"""The port's data pipeline against the JAX package's on the synthetic
database of ``tests/util_synth.py``: with ``prefetch_workers = 0`` and the
same seeds (``epoch_shuffle_seed`` for the per-source epoch shuffles and
the gain and mixing draws, ``np.random.seed`` for the time-warp anchors),
the two ``DESEDProvider``s yield the same training and validation batches:
the same keys, shapes, dtypes, ``example_id``s in the same order, and
``np.array_equal`` arrays. Likewise the ``AudioSetProvider``s on the
fixture of ``tests/test_audioset.py`` (ancestor expansion, class
rebalancing).

Both packages read audio with their default ``AudioReader``: the C++
reader of each (``data/native.py``) decodes, resamples and normalizes, so
the batches hold the same bits; one case reads a database whose files are
44.1 kHz, some of them stereo, where the reader resamples.
"""
import copy

import numpy as np
import pytest

from pb_sed_tpu.database.audioset.provider import \
    AudioSetProvider as JaxAudioSetProvider
from pb_sed_tpu.database.desed.provider import \
    DESEDProvider as JaxDESEDProvider
from pb_sed_tpu_torch.data.audio import read_wav
from pb_sed_tpu_torch.database.audioset.provider import AudioSetProvider
from pb_sed_tpu_torch.database.desed.provider import DESEDProvider
from tests.test_audioset import build_audioset_db
from tests.test_torch_native import load_jax_reader, write_wav
from tests.util_synth import build_database

STFT = {'shift': 160, 'window_length': 480, 'size': 512}


def _desed_config(json_path, storage_dir, **updates):
    config = {
        'json_path': str(json_path),
        'train_set': {'train_weak': 2, 'train_strong': 1,
                      'train_synthetic20': 0, 'train_synthetic21': 0,
                      'train_unlabel_in_domain': 1},
        'cached_datasets': None,
        'min_audio_length': 0.2,
        'discard_labelless_train_examples': False,
        'epoch_shuffle_seed': 11,
        'storage_dir': str(storage_dir),
        'train_fetcher': {
            'batch_size': 4, 'prefetch_workers': 0, 'pad_to_multiple': 16,
            'min_label_diversity_in_batch': 0,
            'min_dataset_examples_in_batch': None,
        },
        'test_fetcher': {'batch_size': 4, 'prefetch_workers': 0,
                         'pad_to_multiple': 16},
        'train_transform': {'stft': dict(STFT),
                            'provide_boundary_targets': True},
        'mix_interval': None,
    }
    for key, value in updates.items():
        if isinstance(value, dict) and isinstance(config.get(key), dict):
            config[key] = {**config[key], **value}
        else:
            config[key] = value
    return config


def _provider(cls, config, label_sets):
    # get_config fills the package's factories into the dict it is given
    provider = cls.from_config(cls.get_config(copy.deepcopy(config)))
    provider.train_transform.label_encoder.initialize_labels(
        dataset=provider.db.get_dataset(label_sets))
    provider.test_transform.label_encoder.initialize_labels()
    return provider


def _batches(dataset, seed, epochs=1):
    """Every batch of ``epochs`` passes; the global numpy generator (the
    anchor draws) is seeded first, and each pass runs to its end so no
    prefetch thread is left drawing from it."""
    np.random.seed(seed)
    return [batch for _ in range(epochs) for batch in dataset]


def _assert_same_batches(got, ref, expect_keys=()):
    assert len(got) == len(ref) > 0
    for tb, jb in zip(got, ref):
        assert list(tb) == list(jb)
        for key in expect_keys:
            assert key in tb, (key, list(tb))
        for key, value in jb.items():
            if isinstance(value, np.ndarray):
                assert tb[key].dtype == value.dtype, key
                assert tb[key].shape == value.shape, key
                assert np.array_equal(tb[key], value), key
            else:
                assert tb[key] == value, key


@pytest.fixture(scope='module', autouse=True)
def jax_reader():
    """Both packages read through their C++ readers: the JAX one loaded
    (it would fall back to numpy on a failed load)."""
    load_jax_reader()


@pytest.fixture(scope='module')
def database(tmp_path_factory):
    root = tmp_path_factory.mktemp('synth')
    # clips of unequal length, so the bucketing has something to do
    _, short = build_database(root / 'short', num_train=10, num_weak=8,
                              num_validate=6, clip_seconds=.5, seed=0)
    _, long = build_database(root / 'long', num_train=10, num_weak=8,
                             num_validate=6, clip_seconds=.9, seed=1)
    from pb_sed_tpu.utils.misc import dump_json, load_json
    merged = load_json(short)
    for name, examples in load_json(long)['datasets'].items():
        merged['datasets'][name].update(
            {f'long_{key}': ex for key, ex in examples.items()})
    json_path = root / 'db.json'
    dump_json(merged, json_path)
    return json_path


@pytest.fixture(scope='module')
def database_44k(tmp_path_factory):
    """The database of ``build_database`` with every file rewritten at
    44.1 kHz (``resample_poly``), every third one stereo."""
    from scipy.signal import resample_poly
    root = tmp_path_factory.mktemp('synth_44k')
    _, json_path = build_database(root, num_train=10, num_weak=8,
                                  num_validate=6, clip_seconds=.7, seed=3)
    rng = np.random.RandomState(0)
    for i, path in enumerate(sorted(root.rglob('*.wav'))):
        audio = read_wav(path)[0][0]
        audio = resample_poly(audio, 441, 160)[:, None]
        if i % 3 == 0:
            audio = np.concatenate(
                [audio, audio + .01 * rng.randn(*audio.shape)], 1)
        write_wav(path, np.clip(audio, -.99, .99), 44100)
    return json_path


CASES = {
    # the DESED recipe's transform: time warp on, no mixing
    'warp': {},
    'mix': {'mix_interval': 1.5},
    'cached': {'cached_datasets': ['train_weak', 'train_strong']},
    # the disk-backed decode cache of data/cache.py (one directory each)
    'memmap_cache': {'cached_datasets': ['train_weak', 'train_strong'],
                     'cache_dir': 'per provider'},
    # a tight padding rate and label diversity: short and long clips go
    # to different buckets
    'bucketing': {'train_fetcher': {
        'max_padding_rate': .05, 'min_label_diversity_in_batch': 2,
        'drop_incomplete': False}},
    'int16_no_warp': {
        'train_fetcher': {'audio_dtype': 'int16'},
        'train_transform': {'anchor_sampling_fn': None,
                            'anchor_shift_sampling_fn': None}},
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_desed_provider_batches_equal_jax(database, tmp_path, case):
    config = _desed_config(database, tmp_path, **CASES[case])
    label_sets = ['train_weak', 'train_strong']
    if 'cache_dir' in config:
        config['cache_dir'] = str(tmp_path / 'cache_jax')
    jax_provider = _provider(JaxDESEDProvider, config, label_sets)
    if 'cache_dir' in config:
        config['cache_dir'] = str(tmp_path / 'cache_port')
    provider = _provider(DESEDProvider, config, label_sets)
    assert type(provider.train_transform.stft).__module__ == \
        'pb_sed_tpu_torch.ops.stft'
    ref = _batches(jax_provider.get_train_set(), seed=5, epochs=2)
    got = _batches(provider.get_train_set(), seed=5, epochs=2)
    keys = ['audio_data', 'seq_len', 'seq_len_samples', 'weak_targets',
            'boundary_targets', 'example_id', 'dataset']
    if case != 'int16_no_warp':
        keys += ['warp_anchor_out', 'warp_anchor_in']
    _assert_same_batches(got, ref, keys)
    assert got[0]['audio_data'].dtype == (
        np.int16 if case == 'int16_no_warp' else np.float32)
    if case == 'mix':
        assert any('+' in i for b in got for i in b['example_id'])
    if case == 'memmap_cache':
        assert sorted(p.name for p in (tmp_path / 'cache_port').iterdir()) \
            == ['train_strong', 'train_weak']
    if case == 'bucketing':
        assert len({b['audio_data'].shape[1] for b in got}) > 1
    # soft targets of the unlabeled clips came through
    assert any((b['weak_targets'] == .5).any() for b in got)
    ref = _batches(jax_provider.get_validate_set(), seed=6)
    got = _batches(provider.get_validate_set(), seed=6)
    _assert_same_batches(got, ref, ['audio_data', 'boundary_targets'])
    assert not any('warp_anchor_out' in b for b in got)
    assert sum(len(b['example_id']) for b in got) == 12


def test_desed_provider_batches_equal_jax_at_44k(database_44k, tmp_path,
                                                 monkeypatch):
    """44.1 kHz files, some stereo, with mixing and the time warp on: the
    C++ readers resample every clip to 16 kHz, and the batches are the
    JAX package's."""
    from pb_sed_tpu_torch.data import native
    config = _desed_config(database_44k, tmp_path, mix_interval=1.5)
    label_sets = ['train_weak', 'train_strong']
    jax_provider = _provider(JaxDESEDProvider, config, label_sets)
    provider = _provider(DESEDProvider, config, label_sets)
    calls = []
    load_wav = native.load_wav
    monkeypatch.setattr(native, 'load_wav', lambda *args, **kwargs: (
        calls.append(args[0]) or load_wav(*args, **kwargs)))
    ref = _batches(jax_provider.get_train_set(), seed=5)
    got = _batches(provider.get_train_set(), seed=5)
    _assert_same_batches(got, ref, ['audio_data', 'warp_anchor_out',
                                    'boundary_targets'])
    assert len(calls) >= sum(len(b['example_id']) for b in got)
    # at 16 kHz: a mix of two 0.7 s clips spans at most 1.4 s
    assert max(b['audio_data'].shape[1] for b in got) <= 1.4 * 16000
    assert any('+' in i for b in got for i in b['example_id'])
    _assert_same_batches(_batches(provider.get_validate_set(), seed=6),
                         _batches(jax_provider.get_validate_set(), seed=6))


def test_desed_provider_default_quotas_hold(database, tmp_path):
    """Per-dataset quotas as the recipe sets them (here at batch 8):
    every batch holds its quota of each dataset, and the batches are the
    JAX package's."""
    config = _desed_config(database, tmp_path, train_fetcher={
        'batch_size': 8,
        'min_dataset_examples_in_batch': {
            'train_weak': 1, 'train_strong': 1, 'train_synthetic20': 0,
            'train_synthetic21': 0, 'train_unlabel_in_domain': 0},
        'drop_incomplete': True, 'max_padding_rate': .5})
    provider = _provider(DESEDProvider, config,
                         ['train_weak', 'train_strong'])
    batches = _batches(provider.get_train_set(), seed=0)
    jax_provider = _provider(JaxDESEDProvider, config,
                             ['train_weak', 'train_strong'])
    _assert_same_batches(batches,
                         _batches(jax_provider.get_train_set(), seed=0))
    for batch in batches:
        assert len(batch['example_id']) == 8
        assert sum(d == 'train_weak' for d in batch['dataset']) >= 1
        assert sum(d == 'train_strong' for d in batch['dataset']) >= 1


@pytest.mark.parametrize('updates', [
    {'add_ancestor_events': True},
    {'min_class_examples_per_epoch': 6,
     'train_fetcher': {'drop_incomplete': False}},
], ids=['ancestors', 'rebalancing'])
def test_audioset_provider_batches_equal_jax(tmp_path, updates):
    _, json_path = build_audioset_db(tmp_path, n=12)
    config = _desed_config(
        json_path, tmp_path, discard_labelless_train_examples=True,
        **updates)
    config['train_set'] = {'balanced_train': 1}
    config['train_transform'] = {
        'stft': dict(STFT), 'anchor_sampling_fn': None,
        'anchor_shift_sampling_fn': None}
    jax_provider = _provider(JaxAudioSetProvider, config, 'balanced_train')
    provider = _provider(AudioSetProvider, config, 'balanced_train')
    assert provider.validate_set == 'eval'
    ref = _batches(jax_provider.get_train_set(), seed=2)
    got = _batches(provider.get_train_set(), seed=2)
    _assert_same_batches(got, ref, ['audio_data', 'weak_targets'])
    if 'min_class_examples_per_epoch' in updates:
        assert sum(len(b['example_id']) for b in got) >= 12
    else:
        # a 'Dog' clip carries its ancestor's label too
        assert any(b['weak_targets'].sum(-1).max() > 1 for b in got)
    _assert_same_batches(_batches(provider.get_validate_set(), seed=3),
                         _batches(jax_provider.get_validate_set(), seed=3))
