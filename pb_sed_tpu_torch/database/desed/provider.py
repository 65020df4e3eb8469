"""DESED data provider.

Capability parity with ``pb_sed/database/desed/provider.py:8-38``: wires
the DESED json path, ``validate_set='validation'``,
``min_label_diversity_in_batch = min(10, batch_size)`` and asserts the
per-dataset batch quotas stay below each dataset's share given the
reference's dataset sizes (weak 1578, unlabel 14412, syn20 2576,
syn21 10000, strong 3470).
"""
from pb_sed_tpu_torch.data.provider import DataProvider
from pb_sed_tpu_torch.paths import database_jsons_dir

DATASET_LENGTHS = {
    'train_weak': 1578,
    'train_unlabel_in_domain': 14412,
    'train_synthetic20': 2576,
    'train_synthetic21': 10000,
    'train_strong': 3470,
}


class DESEDProvider(DataProvider):
    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['json_path'] = str(database_jsons_dir / 'desed.json')
        config['validate_set'] = 'validation'
        super().finalize_dogmatic_config(config)
        batch_size = config['train_fetcher']['batch_size']
        config['train_fetcher']['min_label_diversity_in_batch'] = min(
            10, batch_size)
        quotas = config['train_fetcher'].get(
            'min_dataset_examples_in_batch')
        if quotas:
            train_set = config['train_set'] or {}
            total = sum(
                DATASET_LENGTHS.get(name, 0) * reps
                for name, reps in train_set.items())
            for name, quota in quotas.items():
                if quota == 0 or total == 0:
                    continue
                share = (DATASET_LENGTHS.get(name, 0)
                         * train_set.get(name, 0)) / total
                assert quota / batch_size <= share + 1e-9, (
                    f'min_dataset_examples_in_batch[{name}]={quota} '
                    f'exceeds the dataset share {share:.3f} of the '
                    f'training set (batch_size={batch_size})')
