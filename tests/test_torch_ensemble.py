"""The port's stacked ensemble (``models/base/ensemble.py``) against the
JAX package's ``StackedEnsemble`` and against its own members run in
turn: three tiny weak-label FBCRNNs (16 mels, 16/32-wide towers, two GRU
layers of 32) and two tag-conditioned BiCRNNs, each member with its own
seeded numpy weights carried across by the weight bridge, on clips of
unequal lengths.

The JAX side runs its XLA path (``set_pallas_mode('off')``: the plain
reference of its Pallas kernels, as ``tests/test_torch_strong.py`` runs
its inference) with ``mesh=None``: this directory's conftest gives JAX 8
virtual devices, where ``mesh='auto'`` would build a mesh. The port runs
its kernels' plain versions (CPU tensors) under ``torch.func.vmap``.
Tolerances: against JAX ``1e-4 + 3e-2 * max|ref|``
(``tests/test_torch_fbcrnn.py``: bf16 paths that round at different
points); stacked against in turn 2e-5, the JAX package's own bound
(``tests/test_inference.py``).
"""
import pickle

import jax
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import base as jbase
from pb_sed_tpu.models import strong_label as jstrong
from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.models.base.ensemble import StackedEnsemble as JStacked
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base as tbase
from pb_sed_tpu_torch.models import strong_label as tstrong
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.models.base import ensemble
from pb_sed_tpu_torch.models.base.ensemble import (StackedEnsemble,
                                                   maybe_stack,
                                                   same_architecture)
from pb_sed_tpu_torch.ops.kernels import conv as kconv
from pb_sed_tpu_torch.ops.kernels import gru as kgru

torch.set_num_threads(2)

K = 4
SAMPLES = 8000   # 0.5 s at 16 kHz -> 50 frames at shift 160
CNN = {
    'cnn_2d': {
        'out_channels': [16, 16, 32], 'kernel_size': 3,
        'pool_size': [1, [2, 1], [2, 1]],
        'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
        'pre_activation': True, 'use_pallas': True,
    },
    'cnn_1d': {'out_channels': [32, 32], 'kernel_size': [1, 3],
               'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
               'pre_activation': True},
}
FRONT = {'sample_rate': 16000, 'stft_size': 512, 'stft_shift': 160,
         'stft_window_length': 480, 'number_of_filters': 16}
WEAK = {
    'feature_extractor': FRONT, 'cnn': CNN,
    'rnn_fwd': {
        'rnn': {'hidden_size': 32, 'num_layers': 2, 'use_pallas': True},
        'output_net': {'out_channels': [32, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
}
STRONG = {
    'feature_extractor': FRONT, 'cnn': CNN, 'tag_conditioning': True,
    'rnn': {
        'rnn': {'hidden_size': 16, 'num_layers': 1, 'bidirectional': True,
                'use_pallas': True},
        'output_net': {'out_channels': [16, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
}
STACKED_TOL = 2e-5


def _batch(seed=3, lens=(50, 33, 17)):
    """Clips of unequal lengths (zeroed tails), 0/1 tags as a condition."""
    rng = np.random.RandomState(seed)
    audio = (.3 * rng.randn(len(lens), SAMPLES)).astype(np.float32)
    for i, sl in enumerate(lens):
        audio[i, sl * 160:] = 0.
    return {'audio_data': audio, 'seq_len': np.asarray(lens, np.int32),
            'tag_condition': (rng.rand(len(lens), K) > .5).astype(
                np.float32),
            'example_id': [f'clip{seed}_{i}' for i in range(len(lens))]}


def _arrays(batch):
    return {k: v for k, v in batch.items() if k != 'example_id'}


def _close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    atol = 1e-4 + 3e-2 * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def _members(jcls, tcls, config, seeds):
    """(JAX models, port models), member i with ``random_flat(seed_i)``."""
    jmodels, tmodels = [], []
    template = jcls.from_config(jcls.get_config(pickle.loads(pickle.dumps(
        config))))
    arrays = _arrays(_batch())
    variables = jax.jit(lambda b: template.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(arrays)
    for seed in seeds:
        jm = jcls.from_config(jcls.get_config(pickle.loads(pickle.dumps(
            config))))
        jm.variables = variables
        jm.load_state_dict(bridge.random_flat(jm.state_dict(), seed))
        tm = tcls.from_config(tcls.get_config(pickle.loads(pickle.dumps(
            config))), device='cpu')
        bridge.load_flat(tm.module, jm.state_dict())
        jmodels.append(jm)
        tmodels.append(tm)
    return jmodels, tmodels


@pytest.fixture(scope='module')
def weak():
    jrnn.set_pallas_mode('off')
    try:
        yield _members(jweak.CRNN, tweak.CRNN, WEAK, (0, 1, 2))
    finally:
        jrnn.set_pallas_mode('auto')


@pytest.fixture(scope='module')
def strong():
    jrnn.set_pallas_mode('off')
    try:
        yield _members(jstrong.CRNN, tstrong.CRNN, STRONG, (4, 5))
    finally:
        jrnn.set_pallas_mode('auto')


METHODS = [('tagging', {}), ('boundaries_detection', {}),
           ('sound_event_detection', {'window_length': 11}),
           ('sound_event_detection',
            {'window_length': np.array([5, 11, 5, 11])})]
METHOD_IDS = ['tagging', 'boundaries', 'sed_scalar', 'sed_per_class']


@pytest.mark.parametrize('method,kwargs', METHODS, ids=METHOD_IDS)
def test_stacked_matches_jax_stacked(weak, method, kwargs):
    jmodels, tmodels = weak
    batch = _batch()
    jy, jsl = getattr(JStacked(jmodels, mesh=None), method)(
        _arrays(batch), **kwargs)
    ty, tsl = getattr(StackedEnsemble(tmodels), method)(batch, **kwargs)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)


@pytest.mark.parametrize('method,kwargs', METHODS, ids=METHOD_IDS)
def test_stacked_matches_members_in_turn(weak, method, kwargs):
    _, tmodels = weak
    batch = _batch()
    y, seq_len = getattr(StackedEnsemble(tmodels), method)(batch, **kwargs)
    outs = [getattr(m, method)(batch, **kwargs) for m in tmodels]
    ref = np.mean([o[0].astype(np.float64) for o in outs], axis=0)
    np.testing.assert_array_equal(seq_len, outs[0][1])
    np.testing.assert_allclose(y, ref, atol=STACKED_TOL, rtol=0)


def test_one_kernel_call_per_layer_for_all_members(weak, monkeypatch):
    """The stacked lane calls each kernel wrapper once per layer with the
    members on its leading axis (or folded into the batch / direction
    axis), never once per member."""
    _, tmodels = weak
    calls = {'conv': [], 'pool': [], 'gru': []}

    def spy(key, fn):
        def wrapped(*args):
            calls[key].append(tuple(args[0].shape))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(kconv, 'conv2d_same_members',
                        spy('conv', kconv.conv2d_same_members))
    monkeypatch.setattr(kconv, 'maxpool_freq2',
                        spy('pool', kconv.maxpool_freq2))
    monkeypatch.setattr(kgru, 'gru_scan', spy('gru', kgru.gru_scan))
    StackedEnsemble(tmodels).tagging(_batch())
    assert calls['conv'] == [(3, 3, 50, 16, 1), (3, 3, 50, 16, 16),
                             (3, 3, 50, 8, 16)]
    assert calls['pool'] == [(9, 50, 16, 16), (9, 50, 8, 32)]
    # the paired heads of 3 members: D = 6, one call per GRU layer
    assert calls['gru'] == [(6, 3, 50, 96), (6, 3, 50, 96)]


def test_engine_stacks_by_default_and_matches_jax(weak, monkeypatch):
    """``models.base.tagging`` with ``auto_stack`` (the default) serves the
    members as one StackedEnsemble; its scores match the JAX engine's
    stacked lane and the port's own members run in turn."""
    jmodels, tmodels = weak
    batches = [_batch(3), _batch(4, (50, 50, 29))]
    seen = []
    init = ensemble.StackedEnsemble.__init__

    def spy(self, models, **kwargs):
        seen.append((len(models), kwargs))
        init(self, models, **kwargs)

    monkeypatch.setattr(ensemble.StackedEnsemble, '__init__', spy)
    stacked = tbase.tagging(tmodels, batches)
    assert seen == [(3, {'mesh': None})]
    monkeypatch.undo()
    in_turn = tbase.tagging(tmodels, batches, auto_stack=False)
    jscores = jbase.tagging(jmodels, [_arrays(b) | {'example_id': b[
        'example_id']} for b in batches], mesh=None)
    assert sorted(stacked) == sorted(jscores) == sorted(in_turn)
    for clip in jscores:
        _close(stacked[clip], jscores[clip])
        np.testing.assert_allclose(stacked[clip], in_turn[clip],
                                   atol=STACKED_TOL, rtol=0)
    # SED with a per-class median filter through the engine
    kw = dict(model_kwargs={'window_length': 11, 'window_shift': 1},
              medfilt_length=np.array([1, 3, 5, 3]))
    sed = tbase.sound_event_detection(tmodels, batches, **kw)
    sed_in_turn = tbase.sound_event_detection(tmodels, batches,
                                              auto_stack=False, **kw)
    for clip in sed:
        np.testing.assert_allclose(sed[clip], sed_in_turn[clip],
                                   atol=STACKED_TOL, rtol=0)


def test_chunked_matches_unchunked(weak):
    """``chunk_size=2`` over 3 clips: a full chunk and a padded partial
    one, the example ids cut alongside, outputs trimmed; unchunked is a
    ``chunk_size`` of the whole batch."""
    _, tmodels = weak
    batch = _batch()
    whole = StackedEnsemble(tmodels, chunk_size=len(batch['example_id']))
    chunked = StackedEnsemble(tmodels, chunk_size=2)
    for method, kwargs in METHODS[:3]:
        y_w, sl_w = getattr(whole, method)(batch, **kwargs)
        y_c, sl_c = getattr(chunked, method)(batch, **kwargs)
        np.testing.assert_allclose(y_c, y_w, atol=STACKED_TOL, rtol=0,
                                   err_msg=method)
        np.testing.assert_array_equal(sl_c, sl_w)


def test_sliding_window_sed_chunked_by_default(weak, monkeypatch):
    """Left without ``chunk_size``, sliding-window SED runs in chunks of
    ceil(clips / members) (4 clips, 3 members: 2 chunks of 2) and equals
    the unchunked run; tagging runs the whole batch at once."""
    _, tmodels = weak
    batch = _batch(4, (50, 50, 29, 50))
    chunks = []
    apply_chunk = StackedEnsemble._apply_chunk

    def spy(self, chunk, method, **kwargs):
        chunks.append((method, len(chunk['example_id'])))
        return apply_chunk(self, chunk, method, **kwargs)

    monkeypatch.setattr(StackedEnsemble, '_apply_chunk', spy)
    default = StackedEnsemble(tmodels)
    y, sl = default.sound_event_detection(batch, window_length=11)
    default.tagging(batch)
    assert chunks == [('sed_windows', 2), ('sed_windows', 2),
                      ('tagging', 4)]
    y_w, sl_w = StackedEnsemble(tmodels, chunk_size=4).sound_event_detection(
        batch, window_length=11)
    np.testing.assert_allclose(y, y_w, atol=STACKED_TOL, rtol=0)
    np.testing.assert_array_equal(sl, sl_w)


def test_dispatch_matches_public_api(weak):
    _, tmodels = weak
    batch = _batch()
    runner = StackedEnsemble(tmodels)
    for method, kwargs in METHODS[:3]:
        y_pub, sl_pub = getattr(runner, method)(batch, **kwargs)
        y_d, sl_d = runner.dispatch(method, batch, **dict(kwargs))
        np.testing.assert_array_equal(
            np.asarray(tbase.model.to_numpy(y_d), np.float64),
            np.asarray(y_pub, np.float64), err_msg=method)
        np.testing.assert_array_equal(tbase.model.to_numpy(sl_d), sl_pub)


def test_maybe_stack_rules(weak):
    """One model, different architectures and different kwargs stay
    unstacked; members that agree on both become one StackedEnsemble."""
    _, tmodels = weak
    kw = [{}] * 3
    assert maybe_stack(tmodels[:1], kw[:1]) == (tmodels[:1], kw[:1])
    config = pickle.loads(pickle.dumps(WEAK))
    config['rnn_fwd']['rnn']['hidden_size'] = 16
    other = tweak.CRNN.from_config(tweak.CRNN.get_config(config),
                                   device='cpu')
    assert not same_architecture([tmodels[0], other])
    assert maybe_stack([tmodels[0], other], kw[:2]) == (
        [tmodels[0], other], kw[:2])
    fuse = pickle.loads(pickle.dumps(WEAK))
    fuse['cnn']['cnn_2d']['fuse_bn'] = True
    fused = tweak.CRNN.from_config(tweak.CRNN.get_config(fuse),
                                   device='cpu')
    assert not same_architecture([tmodels[0], fused])
    per_model = [{'window_length': 11}, {'window_length': 5},
                 {'window_length': 11}]
    assert maybe_stack(tmodels, per_model) == (tmodels, per_model)
    windows = [{'window_length': np.array([5, 11, 5, 11])}] * 3
    stacked, kwargs = maybe_stack(tmodels, windows)
    assert len(stacked) == 1 and isinstance(stacked[0], StackedEnsemble)
    assert len(stacked[0]) == 3 and kwargs == windows[:1]


def test_genuine_error_propagates(weak, monkeypatch):
    """An error inside the stacked call reaches the caller: there is no
    fallback to running the members in turn."""
    _, tmodels = weak
    runner = StackedEnsemble(tmodels)

    def bad_method(self, batch):
        raise ValueError('genuine failure')

    monkeypatch.setattr(type(runner.module), 'tagging', bad_method)
    with pytest.raises(ValueError, match='genuine failure'):
        runner.tagging(_batch())
    with pytest.raises(ValueError, match='genuine failure'):
        tbase.tagging(tmodels, [_batch()])


def test_a_mesh_raises(weak):
    """A mesh that is not the port's ``parallel.mesh.Mesh`` (a JAX mesh,
    say) raises, in the ensemble and through the engine. The port's mesh
    lanes run over ranks in ``tests/test_torch_mesh.py``."""
    _, tmodels = weak
    with pytest.raises(TypeError, match='parallel.mesh.Mesh'):
        StackedEnsemble(tmodels, mesh=object())
    with pytest.raises(TypeError, match='parallel.mesh.Mesh'):
        tbase.tagging(tmodels, [_batch()], mesh=object())


@pytest.mark.parametrize('method', ['tagging', 'sound_event_detection'])
def test_tag_conditioned_bicrnn_stacked(strong, method):
    """Two tag-conditioned BiCRNNs: the tags condition every member, the
    bidirectional layer runs at D = 2N; against the JAX stacked lane and
    the port's members in turn."""
    jmodels, tmodels = strong
    batch = _batch(6)
    jy, jsl = getattr(JStacked(jmodels, mesh=None), method)(_arrays(batch))
    ty, tsl = getattr(StackedEnsemble(tmodels), method)(batch)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)
    ref = np.mean([getattr(m, method)(batch)[0].astype(np.float64)
                   for m in tmodels], axis=0)
    np.testing.assert_allclose(ty, ref, atol=STACKED_TOL, rtol=0)
