"""The port's mesh (``parallel/mesh.py``) on the CPU: worlds of 2 and 4
ranks, one spawned process each, on gloo (``parallel/launch.py``),
against one process and against the JAX package's mesh.

- Three ``Trainer`` steps of the tiny FBCRNN of ``tests/test_torch_train.
  py`` (augmentation and dropout on) and of the tiny BiCRNN of ``tests/
  test_torch_strong.py`` on global batches of 8, 2 ranks of 4 rows
  against one process on the 8: the losses, every parameter and every
  running statistic (batch norms and the feature normalization); both
  ranks end in the same state, bit for bit. The two runs differ only in
  where f32 sums are split (the moments, the loss's sums, the gradients'
  batch sums), but the tiny towers' bf16 roundings amplify that: one
  process whose feature-statistics sum is moved by 2e-7 (relative)
  rounds 30% of its first conv's outputs otherwise, as 2 ranks do, and
  its gradients then differ by 3-9% of their largest element. So the
  rule is the gradient rule of ``tests/test_torch_train.py``: each
  parameter's update over the three steps at cosine >= 0.98 with one
  process's (the BN-fed conv biases aside: their true gradient is zero),
  losses within ``1e-3 * |ref|``, running statistics within ``1e-4 +
  1e-2 * max|ref|``. Measured: cosines >= 0.9905, losses within 2.1e-4,
  statistics within 1.5e-3. With the backward reduction of the moments
  dropped (a mutated copy: the all-reduce's backward as the identity)
  the update cosines fall as low as -0.36 (0.90 at the first tensor
  checked) and every training case fails.
- The world of 2 against the JAX ``Trainer(use_mesh=True)`` on a 2-device
  mesh (augmentation off; the JAX side on its XLA path), under the noise
  rule of ``tests/test_torch_train.py``: losses within ``1e-4 + 3e-2 *
  |ref|``, running statistics within ``1e-4 + 3e-2 * max|ref|``, and each
  parameter's update at ``1 - cos`` within 0.01 (the one-process bound
  against JAX there) plus twice the gap that splitting the sums over 2
  ranks opens in the port on the same tensor (world 2 against one
  process, the noise of the first bullet): both packages' mesh steps
  carry that noise on top of the one-device gap.
- A global batch of 6 over 4 ranks (local batches of 2, 2, 1, 1) padded
  as JAX pads it: the steps of one process on the JAX-padded batch of 8.
- The stacked ensemble over 2 ranks: 4 members (ensemble axis 2) and 3
  (coprime: data only, an odd batch of 3 padded and trimmed), tagging
  and SED, against one process (2e-5, the JAX package's own bound for
  its mesh lanes, ``tests/test_inference.py``) and against JAX's
  ``StackedEnsemble`` on a 2-device mesh (``1e-4 + 3e-2 * max|ref|``,
  ``tests/test_torch_fbcrnn.py``); the engine's ``mesh='auto'``.
- ``pad_batch_to_multiple`` and ``default_ensemble_mesh``'s grid against
  JAX's; a rank that raises fails the world within its deadline.

The rank programs below import no JAX: the spawned processes import
this module by name, so JAX is imported inside the tests only.
"""
import copy
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base as tbase
from pb_sed_tpu_torch.models import strong_label as tstrong
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.models.base.ensemble import StackedEnsemble
from pb_sed_tpu_torch.parallel import mesh as tmesh
from pb_sed_tpu_torch.parallel.launch import run_ranks
from pb_sed_tpu_torch.train.hooks import LRAnnealingHook
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)

T = 50          # frames of a 0.5 s clip at shift 160
SAMPLES = 8000
FRONT = {'sample_rate': 16000, 'stft_size': 512, 'stft_shift': 160,
         'stft_window_length': 480, 'number_of_filters': 16}
CNN = {
    'cnn_2d': {'out_channels': [16, 16, 32], 'kernel_size': 3,
               'pool_size': [1, [2, 1], [2, 1]], 'norm': 'batch',
               'norm_kwargs': {'eps': 1e-3}, 'pre_activation': True},
    'cnn_1d': {'out_channels': [32, 32], 'kernel_size': [1, 3],
               'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
               'pre_activation': True},
}
K = 10
WEAK = {
    'feature_extractor': FRONT, 'cnn': CNN,
    'rnn_fwd': {
        'rnn': {'hidden_size': 32, 'num_layers': 2},
        'output_net': {'out_channels': [32, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
}
# every augmentation of the front end, and dropout in both towers
AUGMENTED = {
    'feature_extractor': dict(
        FRONT, frequency_warping=True, n_time_masks=1,
        max_masked_time_steps=10, n_frequency_masks=1,
        max_masked_frequency_bands=3, max_noise_scale=.1),
    'cnn': {'cnn_1d': dict(CNN['cnn_1d'], dropout=.1)},
    'rnn_fwd': {'rnn': {'hidden_size': 32, 'num_layers': 2,
                        'dropout': .2}},
}
STRONG = {
    'feature_extractor': dict(FRONT, n_time_masks=1,
                              max_masked_time_steps=10),
    'cnn': {'cnn_2d': dict(CNN['cnn_2d'], out_channels=[16, 16, 16]),
            'cnn_1d': dict(CNN['cnn_1d'], out_channels=[16, 16])},
    'rnn': {
        'rnn': {'hidden_size': 16, 'num_layers': 2, 'bidirectional': True,
                'dropout': .1},
        'output_net': {'out_channels': [16, 5], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
}
ADAM = dict(lr=1e-3, gradient_clipping=.1, eps=1e-2)
BREAKPOINTS = [(0, .5), (2, 1.), (10, .2)]
# conv biases that feed a training-mode batch norm (identically zero
# gradient in exact arithmetic, bf16 noise in both packages)
BN_FED_BIASES = {
    'cnn.cnn_2d.conv_0.bias', 'cnn.cnn_2d.conv_1.bias',
    'cnn.cnn_2d.conv_2.bias', 'cnn.cnn_1d.conv_0.bias',
    'rnn_fwd.output_net.conv_0.bias', 'rnn_bwd.output_net.conv_0.bias',
    'rnn.output_net.conv_0.bias',
}


def _merge(base, updates):
    out = copy.deepcopy(base)
    for key, value in updates.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


def _batch(seed, n=8, strong=False):
    """``n`` clips of unequal lengths (zeroed tails), soft weak targets
    and partly labelled boundary (or strong) targets."""
    rng = np.random.RandomState(seed)
    k = 5 if strong else K
    audio = (.3 * rng.randn(n, SAMPLES)).astype(np.float32)
    seq_len = rng.randint(20, T + 1, n).astype(np.int32)
    seq_len[0] = T
    for i, length in enumerate(seq_len):
        audio[i, length * 160:] = 0.
    weak = (rng.rand(n, k) > .5).astype(np.float32)
    weak[0, 3], weak[-1, 1] = .5, .3
    frames = (rng.rand(n, k, T) > .6).astype(np.float32)
    frames[1, :2] = .5
    batch = {'audio_data': audio, 'seq_len': seq_len, 'weak_targets': weak,
             'example_id': [f'clip{seed}_{i}' for i in range(n)]}
    batch['strong_targets' if strong else 'boundary_targets'] = frames
    return batch


def _rows(batch, lo, hi):
    return {k: v[lo:hi] for k, v in batch.items()}


def _split(batch, counts, rank):
    lo = sum(counts[:rank])
    return _rows(batch, lo, lo + counts[rank])


def _model(config, strong=False, flat=None, seed=0):
    cls = tstrong.CRNN if strong else tweak.CRNN
    model = cls.from_config(cls.get_config(copy.deepcopy(config)),
                            device='cpu')
    if flat is None:
        model.init_parameters(seed)
    else:
        bridge.load_flat(model.module, flat)
    return model


def _train(config, batches, strong=False, rank=0, counts=None):
    """Three steps of a fresh trainer (weights from seed 0) on ``batches``
    (this rank's rows of each where ``counts`` is given): the losses and
    the final flat state."""
    trainer = Trainer(_model(config, strong), optimizer=Adam(**ADAM),
                      stop_trigger=(3, 'iteration'))
    trainer.register_hook(LRAnnealingHook(breakpoints=BREAKPOINTS))
    losses = []
    for batch in batches:
        if counts is not None:
            batch = _split(batch, counts, rank)
        losses.append(float(trainer.train_step(batch)))
    return losses, bridge.export_flat(trainer.model.module)


def _grids():
    return {n: (None if m is None else (m.axis_names, m.grid.tolist()))
            for n in (1, 2, 3, 4, 6, 10)
            for m in [tmesh.default_ensemble_mesh(n)]}


def _ensembles(flats, batch):
    """Tagging and SED (scalar window) of the stacked ensemble of each
    member count over this world, and the engine's ``mesh='auto'``."""
    out = {}
    for n, flat_list in flats.items():
        models = [_model(WEAK, flat=f) for f in flat_list]
        mesh = tmesh.default_ensemble_mesh(n)
        b = batch if n % 2 == 0 else _rows(batch, 0, 3)
        runner = StackedEnsemble(models, mesh=mesh)
        out[n] = {
            'axes': mesh.axis_names,
            'tagging': runner.tagging(b)[0],
            'sed': runner.sound_event_detection(b, window_length=11)[0],
            'engine': tbase.tagging(models, [b]),
        }
    return out


def world_of_2(rank, world, batches, strong_batches, plain_batches,
               flats, ens_batch):
    torch.set_num_threads(1)
    assert dist.get_world_size() == world == 2
    counts = [4, 4]
    return {
        'weak': _train(_merge(WEAK, AUGMENTED), batches, rank=rank,
                       counts=counts),
        'strong': _train(STRONG, strong_batches, strong=True, rank=rank,
                         counts=counts),
        'plain': _train(WEAK, plain_batches, rank=rank, counts=counts),
        'ensembles': _ensembles(flats, ens_batch),
        'grids': _grids(),
    }


def world_of_4(rank, world, batches):
    torch.set_num_threads(1)
    counts = [2, 2, 1, 1]
    return {'weak': _train(_merge(WEAK, AUGMENTED), batches, rank=rank,
                           counts=counts),
            'grids': _grids()}


def rank_one_raises(rank, world):
    if rank == 1:
        raise ValueError('rank 1 fails on purpose')
    dist.barrier()   # rank 0 waits here for a rank that never comes


# -- fixtures -----------------------------------------------------------------
@pytest.fixture(scope='module')
def flats():
    """Seeded member weights for the ensembles (JAX layout)."""
    template = bridge.export_flat(_model(WEAK).module)
    return {n: [bridge.random_flat(template, 10 * n + i) for i in range(n)]
            for n in (4, 3)}


@pytest.fixture(scope='module')
def data():
    return {
        'batches': [_batch(s) for s in (1, 2, 3)],
        'strong_batches': [_batch(s, strong=True) for s in (4, 5, 6)],
        'plain_batches': [_batch(s) for s in (7, 8, 9)],
        'ens_batch': _batch(11),
        'batches6': [_batch(s, n=6) for s in (12, 13, 14)],
    }


@pytest.fixture(scope='module')
def world2(data, flats):
    ranks = run_ranks(world_of_2, 2, args=(
        data['batches'], data['strong_batches'], data['plain_batches'],
        flats, data['ens_batch']), timeout_s=240.)
    return ranks


def _cosine(a, b):
    a = np.ravel(a).astype(np.float64)
    b = np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _assert_same_steps(got, ref, p0, what):
    """The rule of the module docstring: losses, parameter updates (from
    ``p0``), running statistics."""
    (losses, state), (ref_losses, ref_state) = got, ref
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-3, atol=0,
                               err_msg=what)
    assert sorted(state) == sorted(ref_state)
    for key, value in ref_state.items():
        if key.startswith('params.'):
            if key[len('params.'):] not in BN_FED_BIASES:
                cos = _cosine(state[key] - p0[key], value - p0[key])
                assert cos >= .98, (what, key, cos)
        else:
            np.testing.assert_allclose(
                state[key], value, rtol=0,
                atol=1e-4 + 1e-2 * float(np.abs(value).max()),
                err_msg=f'{what}: {key}')


# -- training -----------------------------------------------------------------
@pytest.mark.parametrize('case', ['weak', 'strong'])
def test_two_ranks_take_the_step_of_one_process(world2, data, case):
    """2 ranks of 4 rows against one process on the 8 (augmentation and
    dropout on): losses, parameters, batch-norm and feature statistics;
    both ranks hold the same state in every bit."""
    strong = case == 'strong'
    config = STRONG if strong else _merge(WEAK, AUGMENTED)
    ref = _train(config, data['strong_batches' if strong else 'batches'],
                 strong=strong)
    ranks = [r[case] for r in world2]
    for key, value in ranks[0][1].items():
        np.testing.assert_array_equal(ranks[1][1][key], value, err_msg=key)
    assert ranks[0][0] == ranks[1][0]
    assert any(k.endswith('feature_extractor.mean') for k in ref[1])
    p0 = bridge.export_flat(_model(config, strong).module)
    _assert_same_steps(ranks[0], ref, p0, case)


def test_four_ranks_pad_a_batch_of_6_as_jax(world2, data):
    """A global batch of 6 over 4 ranks (2, 2, 1, 1 rows) takes the steps
    of one process on the batch JAX's ``pad_batch_to_multiple`` makes of
    it (8 rows: the last clip twice more, soft targets)."""
    from pb_sed_tpu.parallel.mesh import pad_batch_to_multiple as jpad
    ranks = run_ranks(world_of_4, 4, args=(data['batches6'],),
                      timeout_s=240.)
    padded = [jpad(b, 4)[0] for b in data['batches6']]
    assert all(len(b['seq_len']) == 8 for b in padded)
    config = _merge(WEAK, AUGMENTED)
    ref = _train(config, padded)
    _assert_same_steps(ranks[0]['weak'], ref,
                       bridge.export_flat(_model(config).module), 'padded')
    for r in ranks[1:]:
        assert r['weak'][0] == ranks[0]['weak'][0]
    _check_grids(ranks[0]['grids'], 4)


def test_two_ranks_match_the_jax_trainer_on_a_2_device_mesh(world2, data):
    """The world of 2 against the JAX ``Trainer(use_mesh=True)`` with a
    2-device mesh (XLA path), same weights and batches, augmentation off:
    losses within ``1e-4 + 3e-2 * |ref|``, parameter updates at cosine
    >= 0.99 (but the BN-fed biases), statistics within ``1e-4 + 3e-2 *
    max|ref|`` (``tests/test_torch_train.py``)."""
    import jax
    from pb_sed_tpu.models import weak_label as jweak
    from pb_sed_tpu.ops import rnn as jrnn
    from pb_sed_tpu.parallel.mesh import get_mesh
    from pb_sed_tpu.train.hooks import LRAnnealingHook as JaxHook
    from pb_sed_tpu.train.optimizer import Adam as JaxAdam
    from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
    p0 = bridge.export_flat(_model(WEAK).module)

    def jax_steps(mesh):
        jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
            copy.deepcopy(WEAK)))
        jmodel.load_state_dict(p0)
        jtrainer = JaxTrainer(jmodel, optimizer=JaxAdam(**ADAM),
                              storage_dir=None, use_mesh=mesh,
                              stop_trigger=(3, 'iteration'))
        jtrainer.register_hook(JaxHook(breakpoints=BREAKPOINTS))
        # before the first step: the JAX trainer builds its jit lazily
        jtrainer.mesh = get_mesh(devices=jax.devices()[:2])
        losses = [float(jtrainer.train_step(
            {k: v for k, v in b.items() if k != 'example_id'}))
            for b in data['plain_batches']]
        return losses, jtrainer.model.state_dict()

    jrnn.set_pallas_mode('off')
    try:
        jlosses, jflat = jax_steps(True)
    finally:
        jrnn.set_pallas_mode('auto')
    losses, state = world2[0]['plain']
    _, one = _train(WEAK, data['plain_batches'])
    for got, ref in zip(losses, jlosses):
        assert abs(got - ref) <= 1e-4 + 3e-2 * abs(ref), (losses, jlosses)
    for key, before in p0.items():
        if key.startswith('params.'):
            if key[len('params.'):] not in BN_FED_BIASES:
                gap = 1 - _cosine(state[key] - before, jflat[key] - before)
                own = 1 - _cosine(one[key] - before, state[key] - before)
                assert gap <= .01 + 2 * own, (key, gap, own)
        else:
            np.testing.assert_allclose(
                state[key], jflat[key], rtol=0,
                atol=1e-4 + 3e-2 * float(np.abs(jflat[key]).max()),
                err_msg=key)


# -- the stacked ensemble ----------------------------------------------------
@pytest.mark.parametrize('n', [4, 3])
def test_stacked_ensemble_over_two_ranks(world2, data, flats, n):
    """4 members over an ensemble axis of 2 (two per rank), 3 over a
    data-only mesh with an odd batch of 3: both ranks return the whole
    scores, equal to one process's stacked ensemble and to JAX's on a
    2-device mesh of the same shape; the engine's ``mesh='auto'`` gives
    one process's scores."""
    import jax
    from pb_sed_tpu.models.base.ensemble import StackedEnsemble as JStacked
    from pb_sed_tpu.models import weak_label as jweak
    from pb_sed_tpu.ops import rnn as jrnn
    from pb_sed_tpu.parallel.mesh import get_mesh
    got = [r['ensembles'][n] for r in world2]
    assert got[0]['axes'] == (('ensemble', 'data') if n == 4 else ('data',))
    batch = data['ens_batch'] if n == 4 else _rows(data['ens_batch'], 0, 3)
    models = [_model(WEAK, flat=f) for f in flats[n]]
    local = StackedEnsemble(models)
    ref = {'tagging': local.tagging(batch)[0],
           'sed': local.sound_event_detection(batch, window_length=11)[0]}
    ref_engine = tbase.tagging(models, [batch], mesh=None)
    for r in got:
        for method in ('tagging', 'sed'):
            assert r[method].shape == ref[method].shape
            np.testing.assert_allclose(r[method], ref[method], rtol=0,
                                       atol=2e-5, err_msg=method)
        assert sorted(r['engine']) == sorted(ref_engine)
        for key, value in ref_engine.items():
            np.testing.assert_allclose(r['engine'][key], value, rtol=0,
                                       atol=2e-5, err_msg=key)
    jmodels = []
    for f in flats[n]:
        jm = jweak.CRNN.from_config(jweak.CRNN.get_config(
            copy.deepcopy(WEAK)))
        jm.load_state_dict(f)
        jmodels.append(jm)
    jmesh = get_mesh(devices=jax.devices()[:2],
                     ensemble_size=2 if n == 4 else None)
    jbatch = {k: v for k, v in batch.items() if k != 'example_id'}
    jrnn.set_pallas_mode('off')
    try:
        runner = JStacked(jmodels, mesh=jmesh)
        jref = {'tagging': np.asarray(runner.tagging(jbatch)[0]),
                'sed': np.asarray(runner.sound_event_detection(
                    jbatch, window_length=11)[0])}
    finally:
        jrnn.set_pallas_mode('auto')
    for method, value in jref.items():
        np.testing.assert_allclose(
            got[0][method], value, rtol=0,
            atol=1e-4 + 3e-2 * float(np.abs(value).max()), err_msg=method)


# -- helpers against JAX's ----------------------------------------------------
def _check_grids(grids, world):
    import jax
    from pb_sed_tpu.parallel.mesh import default_ensemble_mesh
    for n, got in grids.items():
        ref = default_ensemble_mesh(n, devices=jax.devices()[:world])
        if ref is None:
            assert got is None, n
            continue
        ids = np.vectorize(lambda d: d.id)(ref.devices).tolist()
        assert got == (tuple(ref.axis_names), ids), (n, got)


def test_default_ensemble_mesh_grid_matches_jax(world2):
    _check_grids(world2[0]['grids'], 2)
    assert world2[1]['grids'] == world2[0]['grids']
    assert tmesh.default_ensemble_mesh(4) is None   # no process group


@pytest.mark.parametrize('n,multiple', [(5, 2), (6, 4), (8, 4), (3, 1)])
def test_pad_batch_to_multiple_matches_jax(n, multiple):
    from pb_sed_tpu.parallel.mesh import pad_batch_to_multiple as jpad
    batch = _batch(20, n=n)
    batch['scale'] = np.float32(2.)
    got, pad = tmesh.pad_batch_to_multiple(batch, multiple)
    ref, ref_pad = jpad(batch, multiple)
    assert pad == ref_pad and sorted(got) == sorted(ref)
    for key, value in ref.items():
        if isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value, err_msg=key)
        else:
            assert got[key] == value, key


def test_a_rank_that_raises_fails_the_world_in_time():
    start = time.monotonic()
    with pytest.raises(RuntimeError, match='rank 1 fails on purpose'):
        run_ranks(rank_one_raises, 2, timeout_s=60.)
    assert time.monotonic() - start < 60.
