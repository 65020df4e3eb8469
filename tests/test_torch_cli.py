"""The port's weak-label training experiment through its entry point
(``experiments.weak_label_crnn.training.ex.run``) on the CPU, on the
synthetic database of ``tests/util_synth.py`` with the configuration of
``tests/test_experiments.py`` (tiny model, batch 4, 6 iterations, a
checkpoint every 3; the 2-D convs are 16 wide, the least the port's conv
kernels take): the run directory's files, the summary's training and
validation lines, the best checkpoint served by both packages alike,
``resume=True``, a second run from ``init_ckpt_path`` with frozen layers,
the chain into tuning (debug grids) and inference on ``eval_public`` at
the default ``validation_set_name``, an inference run that pseudo-labels,
and the refusal to run without a card unless ``device='cpu'``.
"""
import copy
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu_torch.experiments.weak_label_crnn import (inference,
                                                         training, tuning)
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.utils.checkpoint import load_payload
from tests.util_synth import build_database

torch.set_num_threads(2)

TS = '2026-01-01-00-00-00-00'
MODEL = {
    'feature_extractor': {
        'stft_size': 512, 'stft_shift': 160, 'stft_window_length': 480,
        'number_of_filters': 16, 'n_time_masks': 1, 'n_frequency_masks': 1,
        'max_noise_scale': .1,
    },
    'cnn': {
        'cnn_2d': {'out_channels': [16, 16], 'pool_size': [[2, 1], [2, 1]],
                   'kernel_size': 3},
        'cnn_1d': {'out_channels': [8, 8], 'kernel_size': 3},
    },
    'rnn_fwd': {
        'rnn': {'hidden_size': 8, 'num_layers': 1},
        'output_net': {'out_channels': [8, 3], 'kernel_size': 1},
    },
}


def _updates(json_path, storage_dir, **more):
    updates = {
        'timestamp': TS, 'group_name': TS, 'storage_dir': str(storage_dir),
        'debug': True, 'batch_size': 4, 'device': 'cpu',
        'validation_set_name': None,
        'data_provider': {
            'json_path': str(json_path),
            'train_set': {
                'train_weak': 1, 'train_strong': 1,
                'train_synthetic20': 0, 'train_synthetic21': 0,
                'train_unlabel_in_domain': 0,
            },
            'cached_datasets': None,
            'min_audio_length': 0.2,
            'train_fetcher': {
                'batch_size': 4, 'prefetch_workers': 0,
                'pad_to_multiple': 16,
                'min_label_diversity_in_batch': 0,
                'min_dataset_examples_in_batch': None,
            },
            'test_fetcher': {'batch_size': 4, 'prefetch_workers': 0,
                             'pad_to_multiple': 16},
            # the recipe's time warp stays on (its anchor samplers are the
            # provider's defaults)
            'train_transform': {
                'stft': {'shift': 160, 'window_length': 480, 'size': 512}},
            'mix_interval': None,
        },
        'num_iterations': 6, 'checkpoint_interval': 3,
        'summary_interval': 2, 'lr_rampup_steps': 2, 'lr_decay_steps': [],
        'trainer': {'model': copy.deepcopy(MODEL)},
        'hyper_params_tuning_batch_size': 4,
    }
    updates.update(more)
    return updates


def _rows(storage_dir):
    return [json.loads(line) for line in
            (storage_dir / 'summary.jsonl').read_text().splitlines()]


@pytest.fixture(scope='module')
def first_run(tmp_path_factory):
    root = tmp_path_factory.mktemp('cli')
    _, json_path = build_database(root / 'db', num_train=8, num_weak=6,
                                  num_validate=4)
    storage_dir = root / 'exp' / TS / TS
    result = training.ex.run(config_updates=_updates(json_path, storage_dir))
    assert result == str(storage_dir)
    return json_path, storage_dir


def test_cli_writes_the_run_directory(first_run):
    _, storage_dir = first_run
    config = json.loads((storage_dir / '1' / 'config.json').read_text())
    assert config['trainer']['model']['factory'] == \
        'pb_sed_tpu_torch.models.weak_label.crnn.CRNN'
    assert config['data_provider']['factory'] == \
        'pb_sed_tpu_torch.database.desed.provider.DESEDProvider'
    assert config['device'] == 'cpu' and config['num_events'] == 10
    assert json.loads((storage_dir / 'events.json').read_text()) == [
        'beep', 'chirp', 'hum']
    names = sorted(p.name for p in (storage_dir / 'checkpoints').iterdir())
    assert names == ['ckpt_6.pkl', 'ckpt_best_macro_fscore_weak.pkl',
                     'ckpt_latest.pkl']
    rows = _rows(storage_dir)
    assert [(r['prefix'], r['iteration']) for r in rows] == [
        ('training', 2), ('validation', 3), ('training', 4),
        ('training', 6), ('validation', 6), ('validation', 6)]
    for row in rows:
        for key in ('loss', 'macro_fscore_weak', 'lwlrap_weak',
                    'z/fscore_weak/beep'):
            assert np.isfinite(row[key]), (row['prefix'], key)
    # the ramp: lr 5e-4 * interp(iteration, (0, 2), (0, 1)), mean of 2 steps
    assert rows[0]['lr'] == pytest.approx(5e-4 * .25, rel=1e-5)
    assert rows[2]['lr'] == pytest.approx(5e-4, rel=1e-5)
    payload = load_payload(storage_dir / 'checkpoints' / 'ckpt_latest.pkl')
    assert payload['iteration'] == 6 and payload['optimizer']['count'] == 6


def test_best_checkpoint_serves_alike_in_both_packages(first_run):
    """``from_storage_dir`` of the port loads the best checkpoint by
    default; its ``'model'`` entry restores into a JAX model of the same
    config (read with ``pickle.load``, as the JAX package reads it), and
    both tag a batch alike (``1e-4 + 3e-2 * max|ref|``, the serving bound
    of ``tests/test_torch_fbcrnn.py``)."""
    _, storage_dir = first_run
    port = tweak.CRNN.from_storage_dir(storage_dir, device='cpu')
    assert port.label_mapping is None or len(port.label_mapping) == 3
    with (storage_dir / 'checkpoints'
          / 'ckpt_best_macro_fscore_weak.pkl').open('rb') as fid:
        flat = pickle.load(fid)['model']
    # the run's own model config, its factories pointed at the JAX package
    text = (storage_dir / '1' / 'config.json').read_text().replace(
        '"pb_sed_tpu_torch.', '"pb_sed_tpu.')
    jmodel = jweak.CRNN.from_config(json.loads(text)['trainer']['model'])
    rng = np.random.RandomState(0)
    batch = {'audio_data': (.3 * rng.randn(3, 8000)).astype(np.float32),
             'seq_len': np.array([50, 41, 33], np.int32)}
    jrnn.set_pallas_mode('off')
    try:
        jmodel.variables = jax.jit(lambda b: jmodel.module.init(
            {'params': jax.random.PRNGKey(0)}, b, training=False))(
                {k: jnp.asarray(v) for k, v in batch.items()})
        assert sorted(jmodel.state_dict()) == sorted(flat)
        jmodel.load_state_dict(flat)
        ref = np.asarray(jmodel.tagging(batch)[0])
    finally:
        jrnn.set_pallas_mode('auto')
    got = port.tagging(batch)[0]
    assert got.shape == ref.shape == (3, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 + 3e-2 * float(np.abs(ref).max()))


def test_resume_continues_from_the_saved_iteration(first_run, capsys,
                                                   tmp_path):
    import shutil
    json_path, storage_dir = first_run
    copy_dir = tmp_path / TS / TS
    shutil.copytree(storage_dir, copy_dir)
    training.ex.run(config_updates=_updates(
        json_path, copy_dir, resume=True, num_iterations=9))
    assert 'Resumed from iteration 6' in capsys.readouterr().out
    rows = _rows(copy_dir)[6:]
    assert [(r['prefix'], r['iteration']) for r in rows] == [
        ('training', 8), ('validation', 9), ('training', 9),
        ('validation', 9)]
    payload = load_payload(copy_dir / 'checkpoints' / 'ckpt_latest.pkl')
    assert payload['iteration'] == 9 and payload['optimizer']['count'] == 9


def test_init_checkpoint_freezes_and_trains(first_run, capsys, tmp_path):
    """A second run from ``init_ckpt_path``: the checkpoint's tensors
    arrive (all of them: the class count is the same, and
    ``drop_output_layer``, reproduced as it is, looks for ``.head.conv_``
    while the heads name ``.output_net.conv_``, so a layer of another
    class count is left to ``load_partial_state_dict``'s shape check),
    ``finetune_mode`` sets the
    gradient clipping to 1 and drops the ramp, and the freeze predicate,
    reproduced as it is (it looks for ``cnn.tower_2d.`` while the model
    names ``cnn.cnn_2d.``), freezes no tensor and says so."""
    json_path, storage_dir = first_run
    init = storage_dir / 'checkpoints' / 'ckpt_best_macro_fscore_weak.pkl'
    run_dir = tmp_path / TS / TS
    updates = _updates(json_path, run_dir, init_ckpt_path=str(init),
                       frozen_cnn_2d_layers=2, num_iterations=3)
    del updates['lr_rampup_steps']
    training.ex.run(config_updates=updates)
    out = capsys.readouterr().out
    n = len(load_payload(init)['model'])
    assert f'Loaded {n} tensors, skipped 0' in out
    assert 'Freeze 2 cnn_2d layers and 0 cnn_1d layers' in out
    assert 'froze 0 tensors' in out
    config = json.loads((run_dir / '1' / 'config.json').read_text())
    assert config['finetune_mode'] is True
    assert config['lr_rampup_steps'] is None
    assert config['trainer']['optimizer']['gradient_clipping'] == 1
    rows = [r for r in _rows(run_dir) if r['prefix'] == 'training']
    assert rows[0]['lr'] == pytest.approx(5e-4, rel=1e-5)
    trained = load_payload(run_dir / 'checkpoints' / 'ckpt_latest.pkl')
    start = load_payload(init)['model']
    moved = [k for k, v in trained['model'].items()
             if k.startswith('params.cnn.cnn_2d.conv_0.kernel')
             and not np.array_equal(v, start[k])]
    assert moved and trained['iteration'] == 3


# the debug grids of experiments/weak_label_crnn/tuning.py, by file and key
GRIDS = {
    'boundaries_detection_hyper_params_f.json': {
        'medfilt_length': [1], 'stepfilt_length': [20]},
    'sed_hyper_params_f.json': {
        'medfilt_length': [11], 'window_length': [11], 'window_shift': [1]},
    'sed_hyper_params_psds1.json': {
        'medfilt_length': [11], 'window_length': [11], 'window_shift': [1]},
    'sed_hyper_params_psds2.json': {
        'medfilt_length': [1], 'window_length': [250],
        'window_shift': [250]},
    'tagging_hyper_params_f.json': {'medfilt_length': [1]},
}
KEYS = {
    'boundaries_detection_hyper_params_f.json': [
        'f', 'medfilt_length', 'offset_bias', 'onset_bias',
        'stepfilt_length', 'tag_masked', 'threshold'],
    'sed_hyper_params_f.json': [
        'f', 'medfilt_length', 'offset_bias', 'onset_bias', 'tag_masked',
        'threshold', 'window_length', 'window_shift'],
    'sed_hyper_params_psds1.json': [
        'auc', 'medfilt_length', 'tag_masked', 'threshold', 'window_length',
        'window_shift'],
    'tagging_hyper_params_f.json': ['f', 'medfilt_length', 'threshold'],
}
KEYS['sed_hyper_params_psds2.json'] = KEYS['sed_hyper_params_psds1.json']


def test_run_chains_into_tuning_and_inference(first_run, tmp_path,
                                              monkeypatch):
    """At the default ``validation_set_name`` the run trains, tunes on
    ``validation`` with the debug grids (``debug=True``) and runs inference
    on ``eval_public`` for both scenarios, all on the CPU: the
    hyper-parameter files with each class's keys, every length from its
    grid, every threshold in [0, 1] or at an end of the sweep (+-inf);
    finite results; the symlinks from
    the training run to the tuning directory and from there to both
    inference runs. A second inference run pseudo-labels
    ``train_unlabel_in_domain`` (weak and strong) into a database json."""
    json_path, _ = first_run
    monkeypatch.setattr(tuning, 'storage_root', tmp_path / 'exp')
    monkeypatch.setattr(inference, 'storage_root', tmp_path / 'exp')
    run_dir = tmp_path / 'train' / TS / TS
    updates = _updates(json_path, run_dir, num_iterations=3)
    del updates['validation_set_name']
    assert training.ex.run(config_updates=updates) == str(run_dir)
    root = tmp_path / 'exp' / 'weak_label_crnn' / 'desed'
    (hp_dir,) = (root / 'hyper_params').iterdir()
    assert sorted(p.name for p in hp_dir.glob('*.json')) == sorted(GRIDS)
    for name, grid in GRIDS.items():
        params = json.loads((hp_dir / name).read_text())
        assert sorted(params) == ['beep', 'chirp', 'hum'], name
        for values in params.values():
            assert sorted(values) == KEYS[name], name
            for key, choices in grid.items():
                assert values[key] in choices, (name, key)
            # or an end of the sweep: -inf (every clip tagged) or +inf
            # (no threshold met the boundaries' min_precision .8)
            assert (0. <= values['threshold'] <= 1.
                    or abs(values['threshold']) == np.inf), name
    config = json.loads((hp_dir / '1' / 'config.json').read_text())
    assert config['device'] == 'cpu'
    assert config['data_provider']['test_fetcher']['batch_size'] == 4
    assert (run_dir / 'hyper_params' / hp_dir.name).resolve() == hp_dir
    inference_dirs = sorted((root / 'inference').iterdir())
    assert sorted(p.resolve() for p in (hp_dir / 'inference').iterdir()) \
        == inference_dirs and len(inference_dirs) == 2
    results = {p.name: json.loads(p.read_text())
               for d in inference_dirs for p in d.glob('*_results_*.json')}
    assert sorted(results) == [
        'boundaries_detection_results_eval_public.json',
        'sed_f_results_eval_public.json',
        'sed_psds1_results_eval_public.json',
        'sed_psds2_results_eval_public.json',
        'tagging_results_eval_public.json']
    for name, values in results.items():
        assert values and all(np.isfinite(v) for v in values.values()), name
    for key in ('psds[0]', 'psds[1]', 'macro_average_f'):
        value = results['sed_psds1_results_eval_public.json'][key]
        assert 0. <= value <= 1. + 1e-12  # float sums of a staircase

    out_dir = inference.ex.run(config_updates={
        'debug': True, 'device': 'cpu', 'hyper_params_dir': str(hp_dir),
        'storage_dir': str(tmp_path / 'pseudo'),
        'dataset_name': ['train_unlabel_in_domain'],
        'weak_pseudo_labeling': [True], 'strong_pseudo_labeling': [True],
        'pseudo_labeled_dataset_name': ['train_unlabel_in_domain']})
    database = json.loads((tmp_path / 'pseudo' / json_path.name).read_text())
    assert out_dir == str(tmp_path / 'pseudo')
    clips = database['datasets']['train_unlabel_in_domain']
    assert clips
    for example in clips.values():
        assert len(example['label_types']) == len(example['events'])
        assert len(example['events_start_times']) == len(example['events'])
        assert set(example['label_types']) <= {'strong', 'weak'}


def test_module_runs_from_the_command_line(first_run, tmp_path):
    """``python -m pb_sed_tpu_torch.experiments.weak_label_crnn.training
    with key=value ...`` in a process of its own: the overrides parse
    (nested keys, lists, ``None``) and the run leaves its checkpoints."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    json_path, _ = first_run
    run_dir = tmp_path / TS / TS

    def flat(node, prefix=''):
        for key, value in node.items():
            if isinstance(value, dict):
                yield from flat(value, f'{prefix}{key}.')
            else:
                yield f'{prefix}{key}={value!r}'

    args = list(flat(_updates(json_path, run_dir, num_iterations=2,
                              checkpoint_interval=2)))
    assert 'validation_set_name=None' in args
    out = subprocess.run(
        [sys.executable, '-m',
         'pb_sed_tpu_torch.experiments.weak_label_crnn.training', 'with',
         *args], cwd=Path(__file__).resolve().parents[1],
        env=dict(os.environ, OMP_NUM_THREADS='2'), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '##### Training #####' in out.stdout
    payload = load_payload(run_dir / 'checkpoints' / 'ckpt_latest.pkl')
    assert payload['iteration'] == 2
    assert (run_dir / 'checkpoints'
            / 'ckpt_best_macro_fscore_weak.pkl').exists()


def test_cli_defaults_to_the_card(first_run, tmp_path):
    """``device=None`` means the card: without one the run raises before
    it builds anything, naming ``device='cpu'``."""
    json_path, _ = first_run
    updates = _updates(json_path, tmp_path / TS / TS)
    del updates['device']
    if torch.cuda.is_available():
        pytest.skip('a card is there: the default device is valid')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.ex.run(config_updates=updates)
    assert not (tmp_path / TS / TS / 'checkpoints').exists()


@pytest.mark.parametrize('database_name,expected', [
    ('desed', dict(num_events=10, num_iterations=20000, lr=5e-4,
                   checkpoint_interval=1000, gradient_clipping=1e10,
                   strong_fwd_bwd_loss_weight=1.,
                   validation_set_name='validation')),
    ('audioset', dict(num_events=527, num_iterations=500000, lr=1e-4,
                      checkpoint_interval=5000, gradient_clipping=.1,
                      strong_fwd_bwd_loss_weight=0.,
                      validation_set_name=None)),
])
def test_recipes_equal_the_jax_experiments(database_name, expected):
    """The config function gives what the JAX experiment's gives, value
    for value, once the factories' package is set aside."""
    from pb_sed_tpu.experiments.weak_label_crnn import training as jtraining
    from pb_sed_tpu.utils.config import config_to_json as jax_to_json
    from pb_sed_tpu_torch.utils.config import config_to_json
    updates = {'database_name': database_name, 'timestamp': TS}
    got = config_to_json(dict(training.ex.build_config(dict(updates))))
    ref = jax_to_json(dict(jtraining.ex.build_config(dict(updates))))
    for key, value in expected.items():
        assert got[key] == value, key

    def ported(node):
        if isinstance(node, dict):
            return {k: ported(v) for k, v in node.items()}
        if isinstance(node, list):
            return [ported(v) for v in node]
        if isinstance(node, str) and node.startswith('pb_sed_tpu.'):
            return 'pb_sed_tpu_torch.' + node[len('pb_sed_tpu.'):]
        return node

    assert got == ported(ref)
