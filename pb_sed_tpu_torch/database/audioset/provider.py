"""AudioSet data provider.

Capability parity with ``pb_sed/database/audioset/provider.py:11-96``:
optional ``add_ancestor_events`` ontology label expansion (ancestors from
the json's ontology closure are appended with the child's timing/type),
weak- vs strong-set detection from the dataset names, 527 weak / 456
strong event classes, and label-diversity wiring for the fetcher.
"""
import dataclasses
from collections.abc import Mapping, Sequence

from pb_sed_tpu_torch.data.lazy import Dataset
from pb_sed_tpu_torch.data.provider import DataProvider
from pb_sed_tpu_torch.paths import database_jsons_dir

NUM_EVENTS_WEAK = 527
NUM_EVENTS_STRONG = 456


@dataclasses.dataclass
class AudioSetProvider(DataProvider):
    add_ancestor_events: bool = False

    def get_raw(self, dataset_names_or_raw_datasets,
                discard_labelless_examples=False,
                filter_example_ids=None):
        raw = super().get_raw(
            dataset_names_or_raw_datasets,
            discard_labelless_examples=discard_labelless_examples,
            filter_example_ids=filter_example_ids)
        if self.add_ancestor_events and isinstance(raw, Dataset):
            ontology = self.db.data['ontology']
            ds_names = self._get_dataset_names(
                self.train_set, self.validate_set)
            key = ('strong_event_classes'
                   if self.strongly_labeled_data(ds_names)
                   else 'weak_event_classes')
            event_classes = set(self.db.data.get(
                key, self.db.data.get('strong_event_classes', [])))

            def expand(example):
                example = dict(example)
                events = list(example['events'])
                for idx, event in enumerate(list(events)):
                    if event not in event_classes:
                        continue
                    node = ontology.get(event, {})
                    for ancestor in node.get('ancestor_names', []):
                        if ancestor not in event_classes:
                            continue
                        events.append(ancestor)
                        for k in ('events_start_times',
                                  'events_stop_times', 'label_types'):
                            if k in example:
                                example[k] = list(example[k]) + [
                                    example[k][idx]]
                example['events'] = events
                if 'events_start_times' in example:
                    order = sorted(
                        range(len(events)),
                        key=lambda i: example['events_start_times'][i])
                    for k in ('events', 'events_start_times',
                              'events_stop_times', 'label_types'):
                        if k in example:
                            example[k] = [example[k][i] for i in order]
                return example

            raw = raw.map(expand)
        return raw

    @classmethod
    def _get_dataset_names(cls, train_set, validate_set):
        names = []
        for ds in (train_set, validate_set):
            if isinstance(ds, str):
                names.append(ds)
            elif isinstance(ds, Mapping):
                names.extend(ds.keys())
            elif isinstance(ds, Sequence) and not isinstance(ds, str):
                names.extend(ds)
            elif ds is not None:
                raise ValueError(type(ds))
        assert names, names
        return names

    @classmethod
    def strongly_labeled_data(cls, dataset_names):
        if any(name in dataset_names for name in
               ('balanced_train', 'unbalanced_train', 'eval')):
            assert 'train_strong' not in dataset_names
            assert 'eval_strong' not in dataset_names
            return False
        return True

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['json_path'] = str(database_jsons_dir / 'audioset.json')
        config['validate_set'] = 'eval'
        super().finalize_dogmatic_config(config)
        ds_names = cls._get_dataset_names(
            config['train_set'], config['validate_set'])
        num_events = (NUM_EVENTS_STRONG
                      if cls.strongly_labeled_data(ds_names)
                      else NUM_EVENTS_WEAK)
        config['train_fetcher']['min_label_diversity_in_batch'] = min(
            num_events, config['train_fetcher']['batch_size'])
