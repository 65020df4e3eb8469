"""Both packages' weak-label tuning CLIs on one run: a tiny FBCRNN trained
by the JAX package's training CLI on the synthetic database of
``tests/util_synth.py``, then tuned on its ``validation`` set with the
debug grids by the JAX package's ``experiments.weak_label_crnn.tuning``
and by the port's (``device='cpu'``; it reads the JAX run directory
through ``port_config``). The tuned hyper-parameter files must name the
same classes and keys, choose the same lengths and filters, and reach
metrics and thresholds within a tolerance: the two packages' scores
differ by the bf16 paths' rounding (``tests/test_torch_fbcrnn.py``), which
can move a threshold to a neighbouring candidate of its sweep.

Slow (two tuning runs and a JAX training run, ~2-4 min on the CPU):
optional under tier-1 (``-m 'not slow'``); run it with
``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tuning_cli.py -q``.
"""
import json

import numpy as np
import pytest
import torch

from tests.util_synth import build_database

torch.set_num_threads(2)

TS = '2026-01-01-00-00-00-00'
# metrics within this distance; thresholds and biases within THRESHOLD
METRIC = .05
THRESHOLD = .1


def _training_updates(json_path, storage_dir):
    return {
        'timestamp': TS, 'group_name': TS, 'storage_dir': str(storage_dir),
        'debug': True, 'batch_size': 4, 'validation_set_name': None,
        'data_provider': {
            'json_path': str(json_path),
            'train_set': {'train_weak': 1, 'train_strong': 1,
                          'train_synthetic20': 0, 'train_synthetic21': 0,
                          'train_unlabel_in_domain': 0},
            'cached_datasets': None, 'min_audio_length': 0.2,
            'train_fetcher': {'batch_size': 4, 'prefetch_workers': 0,
                              'pad_to_multiple': 16,
                              'min_label_diversity_in_batch': 0,
                              'min_dataset_examples_in_batch': None},
            'test_fetcher': {'batch_size': 4, 'prefetch_workers': 0,
                             'pad_to_multiple': 16},
            'train_transform': {
                'stft': {'shift': 160, 'window_length': 480, 'size': 512},
                'anchor_sampling_fn': None,
                'anchor_shift_sampling_fn': None},
            'mix_interval': None,
        },
        'num_iterations': 6, 'checkpoint_interval': 3,
        'summary_interval': 2, 'lr_rampup_steps': 2, 'lr_decay_steps': [],
        'trainer': {'model': {
            'feature_extractor': {
                'stft_size': 512, 'stft_shift': 160,
                'stft_window_length': 480, 'number_of_filters': 16,
                'n_time_masks': 1, 'n_frequency_masks': 1,
                'max_noise_scale': .1},
            'cnn': {
                'cnn_2d': {'out_channels': [4, 4],
                           'pool_size': [[2, 1], [2, 1]], 'kernel_size': 3},
                'cnn_1d': {'out_channels': [8, 8], 'kernel_size': 3}},
            'rnn_fwd': {
                'rnn': {'hidden_size': 8, 'num_layers': 1},
                'output_net': {'out_channels': [8, 3], 'kernel_size': 1}},
        }},
        'hyper_params_tuning_batch_size': 4,
    }


def _tune(module, run_dir, storage_root, monkeypatch, **more):
    """One tuning run of ``module`` (either package's tuning experiment)
    on the run's latest checkpoint; returns its hyper-parameter files."""
    monkeypatch.setattr(module, 'storage_root', storage_root)
    module.ex.run(config_updates=dict(
        debug=True, crnn_dirs=[str(run_dir)],
        crnn_checkpoints='ckpt_latest.pkl', eval_set_name=None, **more))
    (hp_dir,) = (storage_root / 'weak_label_crnn' / 'desed'
                 / 'hyper_params').iterdir()
    return {p.name: json.loads(p.read_text())
            for p in sorted(hp_dir.glob('*_hyper_params_*.json'))}


def _same(got, ref, key):
    if key in ('f', 'auc'):
        return abs(got - ref) <= METRIC
    if isinstance(ref, (int, bool)) or isinstance(got, (int, bool)):
        return got == ref
    if not (np.isfinite(got) and np.isfinite(ref)):
        return got == ref
    return abs(got - ref) <= THRESHOLD


@pytest.mark.slow
def test_weak_tuning_matches_the_jax_cli(tmp_path, monkeypatch):
    from pb_sed_tpu.experiments.weak_label_crnn import training as jtraining
    from pb_sed_tpu.experiments.weak_label_crnn import tuning as jtuning
    from pb_sed_tpu_torch.experiments.weak_label_crnn import (
        tuning as ttuning)
    _, json_path = build_database(tmp_path / 'db', num_train=8, num_weak=6,
                                  num_validate=4)
    run_dir = tmp_path / 'training' / TS / TS
    jtraining.ex.run(config_updates=_training_updates(json_path, run_dir))
    assert (run_dir / 'checkpoints' / 'ckpt_latest.pkl').exists()
    ref = _tune(jtuning, run_dir, tmp_path / 'jax', monkeypatch)
    got = _tune(ttuning, run_dir, tmp_path / 'port', monkeypatch,
                device='cpu')
    assert sorted(got) == sorted(ref) and len(ref) == 5
    for name, classes in ref.items():
        assert sorted(got[name]) == sorted(classes), name
        for event_class, values in classes.items():
            mine = got[name][event_class]
            assert sorted(mine) == sorted(values), (name, event_class)
            for key, value in values.items():
                assert _same(mine[key], value, key), (
                    name, event_class, key, mine[key], value)
