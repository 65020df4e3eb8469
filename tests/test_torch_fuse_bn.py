"""The BN+ReLU-fused conv tower (``CNN2d(fuse_bn=True)``) of the port
against the JAX package's fused packed tower, on the same seeded numpy
inputs and weights: the fused conv's plain version forward and in all
five gradients against ``bnrelu_conv2d_packed_fm`` at the shapes of its
three kernel paths (``tests/test_pallas_conv.py:441-445``) and with a
large positive shift (a lit SAME halo would show), the post-activation
buffer's rounding, the mini tower of ``tests/test_pallas_conv.py:
312-323`` (the fused layer set, outputs, batch statistics, eval mode,
pool-free gradients) and the deep-structured mini FBCRNN of
``tests/test_torch_deep.py`` with ``fuse_bn`` served and stepped by both
trainers.

The JAX side runs its Pallas kernels in interpret mode, as its own CPU
tests do; the port runs its kernels' plain versions (CPU tensors), so no
launch counter moves. Tolerances, each with its reason:

- the fused conv: y and dx ``2^-7 * max|ref|`` (both round the same f32
  sum of the same bf16 products once to bf16; another summation order
  moves that rounding by one bf16 ulp, and dx = bf16(dz * scale) adds at
  most one more); dscale and dshift ``1e-3 * max|ref|`` (f32 sums over
  every pixel of dz * x in another order, on a dz that carries da's
  one-ulp flips); dw and db ``1e-4 * max|ref|`` (f32 sums of identical
  bf16 products in another order);
- the towers and the FBCRNN: outputs and statistics ``1e-4 + 3e-2 *
  max|ref|`` (``tests/test_torch_fbcrnn.py``), gradients the larger of
  ``1e-4 + 3.5e-2 * max|ref|`` and twice the JAX package's own gap
  between its fused packed tower and its unfused XLA tower on the same
  tensor (``tests/test_torch_train.py`` docstring).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.models.base.model import (flatten_variables,
                                          unflatten_variables)
from pb_sed_tpu.ops import cnn as jcnn
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas import conv as pconv
from pb_sed_tpu.train.hooks import LRAnnealingHook
from pb_sed_tpu.train.optimizer import Adam as JaxAdam
from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
from pb_sed_tpu.utils.misc import to_list
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.ops import cnn as tcnn
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (BnReluConv2dSame,
                                               bnrelu_conv2d_same,
                                               bnrelu_conv2d_same_bwd,
                                               bnrelu_plain)
from pb_sed_tpu_torch.train.hooks import \
    LRAnnealingHook as PortLRAnnealingHook
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from chip_smoke import bn_fed_biases
from tests.test_torch_deep import DEEP
from tests.test_torch_fbcrnn import _batches
from tests.test_torch_train import _cosine, _train_batch

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


def _close(got, ref, rel=3e-2, floor=1e-4):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=floor + rel * float(np.max(np.abs(ref))))


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


# -- the fused conv ----------------------------------------------------------

@pytest.mark.parametrize('b,t,f,cin,cout,halo', [
    (2, 20, 16, 16, 32, False),     # _fwd_kernel_bn / _bwd_kernel_bn (rot)
    (1, 12, 8, 128, 128, False),    # the taps path
    (1, 8, 4, 256, 256, False),     # _fwd_kernel_cb_bn, the cb backward
    (2, 20, 16, 16, 32, True),      # shift > 0 everywhere: the halo
], ids=['rot', 'taps', 'channel_blocked', 'positive_shift_halo'])
def test_bnrelu_conv2d_same_matches_jax(interpret_mode, b, t, f, cin, cout,
                                        halo):
    rng = np.random.RandomState(20 + cin + int(halo))
    x = _bf16(rng.randn(b, t, f, cin))
    w = (rng.randn(3, 3, cin, cout) / (3. * np.sqrt(cin))).astype(np.float32)
    bias = (.1 * rng.randn(cout)).astype(np.float32)
    scale = (.5 + rng.rand(cin)).astype(np.float32)
    shift = ((2. + rng.rand(cin)) if halo
             else .2 * rng.randn(cin)).astype(np.float32)
    gy = rng.randn(b, t, f, cout).astype(np.float32)
    g = pconv.fm_geom(t, f, 3, 3, max(cin, cout), cin=cin, cout=cout,
                      fused=True)

    def fused(x, scale, shift, w, bias):
        y2 = pconv.bnrelu_conv2d_packed_fm(pconv.pack_fm(x, g), scale,
                                           shift, w, bias, g, True)
        return pconv.unpack_fm(y2, g, jnp.float32)

    y_ref, vjp = jax.vjp(fused, *map(jnp.asarray,
                                     (x, scale, shift, w, bias)))
    refs = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    params = [torch.from_numpy(a).requires_grad_()
              for a in (scale, shift, w, bias)]
    build.reset_launches()
    y = BnReluConv2dSame.apply(xt, *params)
    assert y.dtype == torch.bfloat16
    _close(y.detach().float().numpy(), y_ref, 2. ** -7, 0.)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16
    grads = [xt.grad.float()] + [p.grad for p in params]
    for name, got, ref, rel in zip(
            ('dx', 'dscale', 'dshift', 'dw', 'db'), grads, refs,
            (2. ** -7, 1e-3, 1e-3, 1e-4, 1e-4)):
        _close(got.numpy(), np.asarray(ref, np.float32), rel, 0.)
    # the wrappers themselves: bf16 y and da, f32 dw, no launch on the CPU
    args = (xt.detach(), *(p.detach() for p in params[:3]))
    torch.testing.assert_close(bnrelu_conv2d_same(*args, params[3].detach()),
                               y.detach(), rtol=0, atol=0)
    da, dw = bnrelu_conv2d_same_bwd(*args, torch.from_numpy(gy).to(
        torch.bfloat16))
    assert da.dtype == torch.bfloat16 and dw.dtype == torch.float32
    torch.testing.assert_close(dw, params[2].grad, rtol=0, atol=0)
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}
    if halo:
        # a halo lit with relu(shift) would move the border outputs far
        # past the tolerance: the case can tell a wrong halo
        xp = F.pad(xt.detach(), (0, 0, 1, 1, 1, 1))
        a_lit = bnrelu_plain(xp, *(p.detach() for p in params[:2]))
        y_lit = F.conv2d(a_lit.float().permute(0, 3, 1, 2),
                         params[2].detach().to(torch.bfloat16).float()
                         .permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
        y_lit = y_lit + params[3].detach()
        gap = float((y_lit - y.detach().float()).abs().max())
        assert gap > 10 * 2. ** -7 * float(np.abs(y_ref).max()), gap


def test_bnrelu_buffer_rounds_like_xla():
    """``a = bf16(relu(x * scale + shift))`` rounds the affine once, as
    XLA does when it contracts the JAX package's ``v * sc + sh`` into a
    fused multiply-add (what the interpret-mode kernels compute on the
    CPU, and what the CUDA kernel's ``__fmaf_rn`` does): bit-exact
    against XLA on data where the two-rounding product-then-sum gives
    another bf16 value at one element."""
    rng = np.random.RandomState(20)
    x = _bf16(rng.randn(2, 20, 16, 16))
    rng.randn(3, 3, 16, 32)
    rng.randn(32)
    scale = (.5 + rng.rand(16)).astype(np.float32)
    shift = (.2 * rng.randn(16)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, s, t: jnp.maximum(v * s + t, 0.)
                             .astype(jnp.bfloat16).astype(jnp.float32))(
        x, scale, shift))
    got = bnrelu_plain(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(shift)).float().numpy()
    np.testing.assert_array_equal(got, ref)
    two_roundings = _bf16(np.maximum(x * scale + shift, 0.))
    assert np.count_nonzero(two_roundings != ref) >= 1


def test_masked_moments_keep_bf16_input():
    """The training statistics of a fused layer keep its bf16 input, not
    an f32 copy, for the backward, and give autograd's gradient of the
    plain moments bit for bit."""
    rng = np.random.RandomState(21)
    x = torch.from_numpy(_bf16(rng.randn(2, 12, 8, 16)))
    mask = tcnn.sequence_mask(torch.tensor([12, 7]), 12).reshape(2, 12, 1, 1)
    g1, g2 = (torch.from_numpy(rng.randn(16).astype(np.float32))
              for _ in range(2))
    x_ref = x.to(torch.bfloat16).requires_grad_()
    xf = x_ref.float()
    ref = ((xf * mask).sum((0, 1, 2)), (xf.square() * mask).sum((0, 1, 2)))
    torch.autograd.backward(ref, (g1, g2))
    x_got = x.to(torch.bfloat16).requires_grad_()
    got = tcnn.MaskedMoments.apply(x_got, mask)
    assert {t.dtype for t in got[0].grad_fn.saved_tensors} == {
        torch.bfloat16, torch.float32}            # x and the {0, 1} mask
    torch.autograd.backward(got, (g1, g2))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert x_got.grad.dtype == torch.bfloat16
    torch.testing.assert_close(x_got.grad, x_ref.grad, rtol=0, atol=0)


# -- the mini tower -----------------------------------------------------------

MINI = {
    # tests/test_pallas_conv.py:_mini_tower(True, fuse_bn=True)
    'out_channels': [16, 16, 32, 32], 'kernel_size': 3,
    'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
    'activation_fn': 'relu', 'pre_activation': True, 'dropout': 0.,
    'output_layer': False, 'use_pallas': True, 'fuse_bn': True,
}
POOLS = [1, [2, 1], 1, [2, 1]]


def _tower_data(seed=7, b=2, t=20, f=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, f, 1).astype(np.float32)
    return x, np.array([t, t - 6][:b], np.int32)


def _jax_tower(pallas_mode, pools, flat, x, seq_len, gy, training):
    """The JAX mini tower's output, mutated statistics and the gradients
    of ``sum(y * gy)`` (params and input) in one kernel mode."""
    jrnn.set_pallas_mode(pallas_mode)
    mod = jcnn.CNN2d(**MINI, pool_size=pools)
    variables = unflatten_variables(flat)

    def run(params, x):
        (y, _), state = mod.apply(dict(variables, params=params), x,
                                  jnp.asarray(seq_len), training=training,
                                  mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * gy), (y, state)

    (_, (y, state)), grads = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(variables['params'],
                                            jnp.asarray(x))
    return (np.asarray(y, np.float32),
            flatten_variables({'batch_stats': state['batch_stats']}),
            flatten_variables({'params': grads[0]}), np.asarray(grads[1]))


def _mini_flat(pools, x, seq_len):
    mod = jcnn.CNN2d(**MINI, pool_size=pools)
    return bridge.random_flat(flatten_variables(
        mod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                 jnp.asarray(seq_len))), 5)


def _port_tower(pools, flat, training):
    port = tcnn.CNN2d(**MINI, pool_size=pools, in_channels=1)
    bridge.load_flat(port, flat)
    port.train(training)
    return port


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_fused_mini_tower_matches_jax(interpret_mode, training):
    """The fused layer set, the outputs and, in training, the mutated
    batch statistics (both through the fold)."""
    x, seq_len = _tower_data()
    plan = jcnn.CNN2d(**MINI, pool_size=POOLS)._packed_plan(
        jnp.asarray(x), [3] * 4, POOLS, [None] * 4)
    assert plan[5] == frozenset({1, 2, 3})
    port = _port_tower(POOLS, _mini_flat(POOLS, x, seq_len), training)
    assert port.fused == plan[5]
    flat = bridge.export_flat(port)
    gy = np.random.RandomState(3).randn(2, 20, 4, 32).astype(np.float32)
    y_ref, stats_ref, _, _ = _jax_tower('force_interpret', POOLS, flat, x,
                                        seq_len, gy, training)
    y, sl = port(torch.from_numpy(x), torch.from_numpy(seq_len))
    assert y.dtype == torch.bfloat16 and y.shape == (2, 20, 4, 32)
    _close(y.detach().float().numpy(), y_ref)
    stats = bridge.export_flat(port)
    for key, ref in stats_ref.items():
        _close(stats[key], ref)
    if not training:
        for key, ref in stats_ref.items():
            np.testing.assert_array_equal(stats[key], flat[key])


def test_fused_mini_tower_gradients_match_jax(interpret_mode):
    """Pool-free (a max pool picks a subgradient at bf16 near-ties,
    ``tests/test_pallas_conv.py:371-377``): every parameter's gradient
    and the input's, through the fold's batch statistics."""
    pools = [1] * 4
    x, seq_len = _tower_data(seed=8)
    flat = _mini_flat(pools, x, seq_len)
    gy = np.random.RandomState(4).randn(2, 20, 16, 32).astype(np.float32)
    _, _, grads_ref, dx_ref = _jax_tower('force_interpret', pools, flat, x,
                                         seq_len, gy, True)
    _, _, xla_grads, xla_dx = _jax_tower('off', pools, flat, x, seq_len, gy,
                                         True)
    port = _port_tower(pools, flat, True)
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = port(xt, torch.from_numpy(seq_len))
    (y.float() * torch.from_numpy(gy)).sum().backward()
    pairs = [(f'params.{k}', p.grad.numpy())
             for k, p in port.named_parameters()]
    pairs.append(('input', xt.grad.numpy()))
    for key, got in pairs:
        ref = dx_ref if key == 'input' else grads_ref[key]
        xla = xla_dx if key == 'input' else xla_grads[key]
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()),
                    2 * float(np.abs(xla - ref).max()))
        assert float(np.abs(got - ref).max()) <= bound, key


# -- the deep-structured mini FBCRNN with fuse_bn -----------------------------

DEEP_FUSED = pickle.loads(pickle.dumps(DEEP))
DEEP_FUSED['cnn']['cnn_2d']['fuse_bn'] = True


@pytest.fixture(scope='module')
def fused_flat():
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(DEEP_FUSED))))
    jmodel.variables = jax.jit(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(
            _train_batch(0))
    return bridge.random_flat(jmodel.state_dict(), 17)


def _models(flat):
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(DEEP_FUSED))))
    jmodel.load_state_dict(flat)
    tmodel = tweak.CRNN.from_config(tweak.CRNN.get_config(
        pickle.loads(pickle.dumps(DEEP_FUSED))), device='cpu')
    bridge.load_flat(tmodel.module, flat)
    return jmodel, tmodel


def test_fused_deep_fbcrnn_serves_like_jax(fused_flat, interpret_mode):
    jmodel, tmodel = _models(fused_flat)
    cfg = DEEP_FUSED['cnn']['cnn_2d']
    n = len(cfg['out_channels'])
    plan = jcnn.CNN2d(**cfg)._packed_plan(
        jnp.zeros((2, 50, 16, 1)), cfg['kernel_size'], cfg['pool_size'],
        to_list(cfg['residual_connections'], n))
    assert plan[5] == frozenset({2, 4})
    assert tmodel.module.cnn.cnn_2d.fused == plan[5]
    batch = _batches()[1]
    jy_fwd, jy_bwd, jsl, _, _ = jmodel._apply(batch)
    ty_fwd, ty_bwd, tsl, _, _ = tmodel._apply(batch, 'forward')
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    _close(ty_fwd.numpy(), jy_fwd)
    _close(ty_bwd.numpy(), jy_bwd)
    _close(tmodel.tagging(batch)[0], jmodel.tagging(batch)[0])
    jy, jsl = jmodel.sound_event_detection(batch, 11, window_shift=1)
    ty, tsl = tmodel.sound_event_detection(batch, 11, window_shift=1)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)


def test_three_fused_deep_trainer_steps_match_jax(fused_flat,
                                                  interpret_mode):
    """Both trainers, the AudioSet recipe's settings (Adam at lr 1e-4
    with a ramp, gradient clipping 0.1, no strong loss), three steps:
    the losses, the running statistics and the direction of every
    update: a cosine with the JAX fused tower's update of at least 0.99,
    or, where the JAX package's own unfused XLA tower is further from
    its fused one, within twice that gap (``1 - cos``)."""
    kwargs = dict(lr=1e-4, gradient_clipping=.1, eps=1e-2)
    breakpoints = [(0, .5), (2, 1.)]
    batches = [_train_batch(seed) for seed in (1, 2, 3)]
    jflats, jlosses = [], []
    for mode in ('force_interpret', 'off'):
        jrnn.set_pallas_mode(mode)
        jtrainer = JaxTrainer(_models(fused_flat)[0],
                              optimizer=JaxAdam(**kwargs), storage_dir=None,
                              use_mesh=False, stop_trigger=(3, 'iteration'))
        jtrainer.register_hook(LRAnnealingHook(breakpoints=breakpoints))
        jtrainer._ensure_ready(batches[0])
        jlosses.append([float(jtrainer.train_step(b)) for b in batches])
        jflats.append(jtrainer.model.state_dict())
    jrnn.set_pallas_mode('force_interpret')
    tmodel = _models(fused_flat)[1]
    ttrainer = Trainer(tmodel, optimizer=Adam(**kwargs),
                       stop_trigger=(3, 'iteration'))
    ttrainer.register_hook(PortLRAnnealingHook(breakpoints=breakpoints))
    p0 = bridge.export_flat(tmodel.module)
    bn_fed = bn_fed_biases(tmodel.module)
    build.reset_launches()
    for step, batch in enumerate(batches):
        tloss = float(ttrainer.train_step(batch))
        jloss = jlosses[0][step]
        assert abs(tloss - jloss) <= 1e-4 + 3e-2 * abs(jloss), (step, tloss,
                                                                jloss)
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}
    jflat, xla_flat = jflats
    tflat = bridge.export_flat(tmodel.module)
    for key, before in p0.items():
        path = key.split('.', 1)[1]
        if key.startswith('params.'):
            if path not in bn_fed and before.size >= 16:
                cos = _cosine(tflat[key] - before, jflat[key] - before)
                jax_cos = _cosine(xla_flat[key] - before,
                                  jflat[key] - before)
                assert cos >= min(.99, 1 - 2 * (1 - jax_cos)), (
                    path, cos, jax_cos)
        else:
            _close(tflat[key], jflat[key])
