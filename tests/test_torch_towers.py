"""The tower configurations beyond the recipes against the JAX package:
max pools of any window (time pools, scalar pools, odd extents), the
residual average pool of any window, the conv at any Cout and any kernel
extent, residuals across all of them, norm-free towers, every flax
activation the towers take, and a tiny time-pooled FBCRNN served,
stepped and stacked.

Every input is made from a seeded numpy ``RandomState`` and handed to
both packages. The JAX towers run with ``use_pallas=True`` under
``set_pallas_mode('force_interpret')`` (the TPU's mix of packed Pallas
layers and unpacked XLA layers, its kernels interpreted) and under
``'auto'`` (XLA only on the CPU); the port runs its kernels' plain
versions (CPU tensors, no launch). Tolerances, each stated where it is
used:

- the pools: bit-exact (a compare, or a sum in one order and a
  division), but the average pool against JAX's ``reduce_window``, 1e-6
  relative;
- the conv: ``1e-4 + 1.2e-2 * max|ref|`` forward, 3.5e-2 / 3.5e-2 / 8e-2
  relative for dx / dw / db (``tests/test_pallas_conv.py:770,780``);
- towers and models: outputs and statistics ``1e-4 + 3e-2 * max|ref|``,
  gradients the larger of ``1e-4 + 3.5e-2 * max|ref|`` and twice the
  gap between the JAX package's two modes (``tests/test_torch_deep.py``),
  ``seq_len`` exact.
"""
import pickle

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.models.base.model import (flatten_variables,
                                          unflatten_variables)
from pb_sed_tpu.ops import cnn as jcnn
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas import conv as pconv
from pb_sed_tpu.utils.misc import to_list
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base as tbase
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.ops import cnn as tcnn
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (AvgPool2d, Conv2dSame,
                                               MaxPool2d, avgpool2d,
                                               avgpool2d_bwd, conv2d_same,
                                               conv2d_same_bwd, maxpool2d,
                                               maxpool2d_bwd)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def auto_mode():
    yield
    jrnn.set_pallas_mode('auto')


def _close(got, ref, rel=3e-2):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 + rel * float(np.max(np.abs(ref))))


def _bf16(a):
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _cosine(a, b):
    a = np.ravel(a).astype(np.float64)
    b = np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _no_launch():
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}


# -- the max pool of any window ---------------------------------------------

@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
@pytest.mark.parametrize('pf,pt', [(1, 2), (2, 2), (3, 1), (2, 3), (4, 4)])
def test_maxpool2d_matches_nn_max_pool_bit_exact(pf, pt, dtype):
    """Forward and VJP against ``nn.max_pool`` (VALID, floor) and
    ``jax.vjp`` at odd T and F, on values drawn from {-2, ..., 2} (most
    windows tie): the cotangent goes to the first of the tied elements in
    (t, f) order, as XLA's select does. Bit-exact."""
    rng = np.random.RandomState(pf * 10 + pt)
    x = rng.randint(-2, 3, size=(2, 13, 11, 8)).astype(np.float32)
    x[0, :, :, 0] = 1.                    # whole windows of one value
    to, fo = 13 // pt, 11 // pf
    gy = _bf16(rng.randn(2, to, fo, 8))
    jdtype = jnp.dtype(dtype)
    y_ref, vjp = jax.vjp(
        lambda v: fnn.max_pool(v, (pt, pf), strides=(pt, pf)),
        jnp.asarray(x, jdtype))
    (dx_ref,) = vjp(jnp.asarray(gy, jdtype))
    tdtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdtype).requires_grad_()
    build.reset_launches()
    y = MaxPool2d.apply(xt, pt, pf)
    assert y.dtype == tdtype and y.shape == (2, to, fo, 8)
    np.testing.assert_array_equal(y.detach().float().numpy(),
                                  np.asarray(y_ref, np.float32))
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy).to(tdtype))
    assert dx.dtype == tdtype
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_ref, np.float32))
    # the rows and columns past the last whole window get no gradient
    assert not dx[:, to * pt:].any() and not dx[:, :, fo * pf:].any()
    np.testing.assert_array_equal(
        maxpool2d_bwd(xt.detach(), torch.from_numpy(gy), pt,
                      pf).float().numpy(), dx.float().numpy())
    _no_launch()


def test_maxpool2d_all_ones_goes_to_the_top_left():
    x = torch.ones(1, 4, 4, 1)
    dx = maxpool2d_bwd(x, torch.ones(1, 2, 2, 1), 2, 2)[0, ..., 0]
    assert dx.tolist() == [[1, 0, 1, 0], [0, 0, 0, 0],
                           [1, 0, 1, 0], [0, 0, 0, 0]]


# -- the residual average pool of any window ---------------------------------

@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_avgpool2d_matches_match_residual(dtype):
    """A residual that crosses a time pool and a pool at an odd F:
    (2, 25, 5, 24) -> (2, 12, 2, 64), ONE window (2, 2) and the channel
    pad, against the JAX ``_match_residual`` and its VJP (f32, on the
    bf16-valued residual for the bf16 case). 1e-6 relative: JAX's
    reduce_window may add in another order. The cotangent in the
    residual's type."""
    rng = np.random.RandomState(3)
    res = rng.randn(2, 25, 5, 24).astype(np.float32)
    if dtype == 'bfloat16':
        res = _bf16(res)
    gy = rng.randn(2, 12, 2, 64).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda r: jcnn._match_residual(r, (2, 12, 2, 64)),
                         jnp.asarray(res))
    (dx_ref,) = vjp(jnp.asarray(gy))
    tdtype = getattr(torch, dtype)
    rt = torch.from_numpy(res).to(tdtype).requires_grad_()
    build.reset_launches()
    y = tcnn._match_residual(rt, (2, 12, 2, 64), pairs=False)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(y_ref).max()))
    (dx,) = torch.autograd.grad(y, rt, torch.from_numpy(gy))
    assert dx.dtype == tdtype
    want = np.asarray(dx_ref, np.float32)
    if dtype == 'bfloat16':
        want = _bf16(want)
    np.testing.assert_allclose(dx.float().numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    assert not dx[:, 24:].any()           # the frame no window covers
    # the Function's forward and backward against the wrappers, bits
    np.testing.assert_array_equal(
        avgpool2d(rt.detach(), 2, 2, 64).numpy(), y.detach().numpy())
    np.testing.assert_array_equal(
        avgpool2d_bwd(torch.from_numpy(gy), 2, 2, rt.shape,
                      tdtype).float().numpy(), dx.float().numpy())
    _no_launch()


def test_avgpool2d_matches_a_time_residual():
    """The 1-D tower's (B, T, C) residual across time pools by 2 and 2:
    (2, 25, 16) -> (2, 6, 32), window 25 // 6 = 4, as the JAX
    ``_match_residual``. 1e-6 relative."""
    rng = np.random.RandomState(4)
    res = rng.randn(2, 25, 16).astype(np.float32)
    gy = rng.randn(2, 6, 32).astype(np.float32)
    y_ref, vjp = jax.vjp(lambda r: jcnn._match_residual(r, (2, 6, 32)),
                         jnp.asarray(res))
    (dx_ref,) = vjp(jnp.asarray(gy))
    rt = torch.from_numpy(res).requires_grad_()
    y = tcnn._match_residual(rt, (2, 6, 32))
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(y_ref).max()))
    (dx,) = torch.autograd.grad(y, rt, torch.from_numpy(gy))
    np.testing.assert_allclose(dx.numpy(), dx_ref, rtol=1e-6,
                               atol=1e-6 * float(np.abs(dx_ref).max()))


def test_pools_under_vmap_equal_each_member():
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 2, 9, 7, 8).astype(
        np.float32)).to(torch.bfloat16)
    got = torch.func.vmap(MaxPool2d.apply, in_dims=(0, None, None))(x, 2, 3)
    assert torch.equal(got, torch.stack([maxpool2d(v, 2, 3) for v in x]))
    got = torch.func.vmap(AvgPool2d.apply, in_dims=(0, None, None, None))(
        x, 2, 3, 16)
    assert torch.equal(got, torch.stack([avgpool2d(v, 2, 3, 16) for v in x]))


# -- the conv at any Cout and any kernel extent ------------------------------

@pytest.mark.parametrize('kt,kf', [(2, 2), (4, 3), (2, 1), (3, 3)])
@pytest.mark.parametrize('cout', [10, 24, 40])
def test_conv_any_width_and_extent_matches_jax(kt, kf, cout):
    """Forward and VJP against ``Conv2dMXU(use_pallas=False)``, XLA's SAME
    conv (pads ``((k - 1) // 2, k // 2)``) in bf16, under the conv tests'
    rules: ``1e-4 + 1.2e-2 * max|ref|`` forward, 3.5e-2 / 3.5e-2 / 8e-2
    relative for dx / dw / db."""
    rng = np.random.RandomState(kt * 100 + kf * 10 + cout)
    b, t, f, cin = 2, 9, 7, 16
    x = _bf16(rng.randn(b, t, f, cin))
    w = (rng.randn(kt, kf, cin, cout) / np.sqrt(kt * kf * cin)).astype(
        np.float32)
    bias = (.1 * rng.randn(cout)).astype(np.float32)
    gy = rng.randn(b, t, f, cout).astype(np.float32)
    conv = jcnn.Conv2dMXU(cout, kernel_size=(kt, kf),
                          compute_dtype=jnp.bfloat16, use_pallas=False)
    y_ref, vjp = jax.vjp(
        lambda x, w, b: conv.apply({'params': {'kernel': w, 'bias': b}},
                                   x).astype(jnp.float32),
        *map(jnp.asarray, (x, w, bias)))
    refs = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    build.reset_launches()
    y = Conv2dSame.apply(xt, wt, bt)
    assert y.shape == (b, t, f, cout) and y.dtype == torch.bfloat16
    _close(y.float().detach().numpy(), y_ref, 1.2e-2)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    for got, ref, rel in zip((xt.grad.float(), wt.grad, bt.grad), refs,
                             (3.5e-2, 3.5e-2, 8e-2)):
        _close(got.numpy(), np.asarray(ref, np.float32), rel)
    # the wrappers: the Function's values, and the plain backward
    assert torch.equal(conv2d_same(xt.detach(), wt.detach(), bt.detach()),
                       y.detach())
    dx, dw = conv2d_same_bwd(xt.detach(), wt.detach(),
                             torch.from_numpy(gy).to(torch.bfloat16))
    assert dx.shape == x.shape and dw.shape == w.shape
    if kt % 2 and kf % 2:
        # the odd kernel also against the Pallas conv2d_mxu, interpreted
        jrnn.set_pallas_mode('force_interpret')
        y2 = pconv.conv2d_mxu(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias), True)
        _close(y.float().detach().numpy(), np.asarray(y2, np.float32),
               1.2e-2)
    _no_launch()


def test_even_kernel_pads_as_xla_same():
    """A 2 x 2 kernel of one tap at (1, 1) shifts the input by one frame
    and one bin (XLA pads (0, 1)): the port's plain conv and its dx,
    exactly."""
    x = torch.arange(1., 1. + 3 * 4).reshape(1, 3, 4, 1).to(torch.bfloat16)
    w = torch.zeros(2, 2, 1, 16)
    w[1, 1, 0, :] = 1.
    y = conv2d_same(x, w, None)[0, ..., 0].float()
    want = torch.zeros(3, 4)
    want[:2, :3] = x[0, 1:, 1:, 0].float()
    assert torch.equal(y, want)
    dx, dw = conv2d_same_bwd(x, w, torch.ones(1, 3, 4, 16))
    assert dx[0, 0, :, 0].tolist() == [0] * 4       # frame 0 feeds nothing
    assert dx[0, 1:, 1:, 0].eq(16).all()
    assert dw.shape == (2, 2, 1, 16)


# -- towers ------------------------------------------------------------------

_RELU = dict(norm='batch', norm_kwargs={'eps': 1e-3}, activation_fn='relu',
             pre_activation=True)
# name: (2-D?, tower kwargs, T, F, training)
TOWERS = {
    # test_packed_plan_gating's mid-tower time pool, a residual across it.
    # T is even here: the JAX package's packed plan counts T after a time
    # pool as ceil(T / pt) where nn.max_pool floors it, so an odd T before
    # its packed window (layers 2-3) fails in its TPU path
    'mid_time_pool': (True, dict(
        _RELU, out_channels=[16, 16, 32, 32], kernel_size=3,
        pool_size=[1, [2, 2], 1, 1],
        residual_connections=[None, 3, None, None]), 20, 16, True),
    'mid_time_pool_eval': (True, dict(
        _RELU, out_channels=[16, 16, 32, 32], kernel_size=3,
        pool_size=[1, [2, 2], 1, 1],
        residual_connections=[None, 3, None, None]), 20, 16, False),
    # and its trailing one: a packed window [0, 3), then the pool unpacked
    'trailing_time_pool': (True, dict(
        _RELU, out_channels=[16, 16, 32, 32], kernel_size=3,
        pool_size=[1, 1, 1, [2, 2]],
        residual_connections=[None, 3, None, None]), 21, 16, True),
    # F = 20 -> 10 -> 5 -> 2: layer 2 pools an odd F; the residual 1 -> 3
    # crosses it (one (1, 5) window), 0 -> 2 crosses two (2, 1) pools on
    # even F (row pairs)
    'odd_f_crossing': (True, dict(
        _RELU, out_channels=[16, 16, 16, 32], kernel_size=3,
        pool_size=[[2, 1], [2, 1], [2, 1], 1],
        residual_connections=[2, 3, None, None]), 21, 20, True),
    # Cout 24 and a residual zero-padded from 24 to 48 across a (2, 1)
    # pool, 2 x 2 and 4 x 3 kernels, a scalar pool 2 (both axes)
    'cout24_even_kernels': (True, dict(
        _RELU, out_channels=[16, 24, 24, 48],
        kernel_size=[3, [2, 2], 1, [4, 3]], pool_size=[1, [2, 1], 1, 2],
        residual_connections=[None, 3, None, None]), 21, 16, True),
    # norm-free towers (no norm_{i}, no statistics) in both orders
    'norm_none': (True, dict(
        out_channels=[16, 24, 32], kernel_size=3,
        pool_size=[[2, 2], 1, [2, 1]], residual_connections=[None, 2, None],
        norm=None, activation_fn='elu'), 21, 16, True),
    'norm_layer': (True, dict(
        out_channels=[16, 24, 32], kernel_size=3,
        pool_size=[[2, 2], 1, [2, 1]], residual_connections=[None, 2, None],
        norm='layer', activation_fn='elu', pre_activation=True), 21, 16,
        True),
    'norm_none_1d': (False, dict(
        out_channels=[32, 32], kernel_size=3, pool_size=[2, 1], norm=None,
        activation_fn='elu'), 21, 16, True),
    # time pools in the 1-D tower on its f32 values, odd T, a residual
    # across two of them (one window of 25 // 6 = 4 frames) with growth
    'time_pools_1d': (False, dict(
        _RELU, out_channels=[16, 16, 32, 32], kernel_size=[3, 1, 3, 3],
        pool_size=[1, 2, 2, 1], residual_connections=[None, 3, None, None]),
        25, 12, True),
    'time_pools_1d_eval': (False, dict(
        _RELU, out_channels=[16, 16, 32, 32], kernel_size=[3, 1, 3, 3],
        pool_size=[1, 2, 2, 1], residual_connections=[None, 3, None, None]),
        25, 12, False),
}
# the cases the JAX package runs with a packed window of Pallas layers
# (and its other layers on XLA) in 'force_interpret': held against that
# path too; the others take the XLA path there as in 'auto', but for
# per-layer Pallas convs (conv2d_mxu), which the conv tests hold
INTERPRETED = ('mid_time_pool', 'mid_time_pool_eval', 'trailing_time_pool',
               'odd_f_crossing')
ACTIVATIONS = sorted(tcnn._ACTIVATIONS) + ['identity', None]
# every activation in a two-layer post-activation tower with a time pool
TOWERS.update({f'act_{name}': (True, dict(
    out_channels=[16], kernel_size=3, pool_size=[[1, 2]], norm='batch',
    norm_kwargs={'eps': 1e-3}, activation_fn=name), 21, 8, True)
    for name in ACTIVATIONS})


def _jax_towers(cases, mode, f32=False):
    """Each case's JAX tower (``use_pallas=True`` in 2-D) in one kernel
    mode, all in one jitted call: output, seq_len, mutated statistics and
    the gradients of ``sum(y * gy)`` (params and input). ``f32``: the same
    towers with ``compute_dtype='float32'``."""
    jrnn.set_pallas_mode(mode)
    names = sorted(cases)
    mods, variables, xs = [], [], []
    for name in names:
        case = cases[name]
        kwargs = dict(case['kwargs'], compute_dtype='float32') if f32 \
            else case['kwargs']
        cls = jcnn.CNN2d if case['two_d'] else jcnn.CNN1d
        mods.append(cls(**(dict(kwargs, use_pallas=True) if case['two_d']
                           else kwargs)))
        variables.append(unflatten_variables(case['flat']))
        xs.append(jnp.asarray(case['x']))

    def run(params, xs):
        total, outs = 0., []
        for name, mod, vs, p, x in zip(names, mods, variables, params, xs):
            case = cases[name]
            (y, sl), state = mod.apply(
                dict(vs, params=p), x, jnp.asarray(case['seq_len']),
                training=case['training'], mutable=['batch_stats'])
            total = total + jnp.sum(y.astype(jnp.float32) * case['gy'])
            outs.append((y, sl, state))
        return total, outs

    (_, outs), grads = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(
            [vs['params'] for vs in variables], xs)
    return {name: {
        'y': np.asarray(y, np.float32), 'seq_len': np.asarray(sl),
        'stats': flatten_variables(
            {'batch_stats': state.get('batch_stats', {})}),
        'grads': dict(flatten_variables({'params': gp}),
                      input=np.asarray(gx))}
        for name, (y, sl, state), gp, gx in zip(names, outs, grads[0],
                                                grads[1])}


def _port_tower(case):
    cls = tcnn.CNN2d if case['two_d'] else tcnn.CNN1d
    port = cls(**case['kwargs'], in_channels=case['x'].shape[-1])
    bridge.load_flat(port, case['flat'])
    port.train(case['training'])
    return port


@pytest.fixture(scope='module')
def tower_refs():
    """Every case of ``TOWERS`` from seeded numpy inputs and weights, and
    the JAX package's results in its three paths: ``force_interpret``
    (packed Pallas windows and per-layer Pallas convs, interpreted),
    ``auto`` (XLA) and XLA in f32 (``compute_dtype='float32'``)."""
    cases = {}
    for i, (name, (two_d, kwargs, t, f, training)) in enumerate(
            sorted(TOWERS.items())):
        rng = np.random.RandomState(i)
        x = rng.randn(2, t, f, 1).astype(np.float32)
        if not two_d:
            x = x[..., 0]
        seq_len = np.array([t, t - 6], np.int32)
        cls = tcnn.CNN2d if two_d else tcnn.CNN1d
        # the port's keys and shapes, which the JAX tower's must equal
        flat = bridge.random_flat(bridge.export_flat(
            cls(**kwargs, in_channels=x.shape[-1])), i)
        case = dict(two_d=two_d, kwargs=kwargs, x=x, seq_len=seq_len,
                    flat=flat, training=training)
        with torch.no_grad():
            y, _ = _port_tower(case)(torch.from_numpy(x),
                                     torch.from_numpy(seq_len))
        case['gy'] = rng.randn(*y.shape).astype(np.float32)
        cases[name] = case
    refs = {'auto': _jax_towers(cases, 'auto'),
            'f32': _jax_towers(cases, 'auto', f32=True),
            'force_interpret': _jax_towers(
                {name: cases[name] for name in INTERPRETED},
                'force_interpret')}
    jrnn.set_pallas_mode('auto')
    return cases, refs


# how far above the noise bound a gradient may go where a discrete
# decision sits within one rounding of its edge (see test_towers_match_jax)
EDGE = 8.


@pytest.mark.parametrize('name', sorted(TOWERS))
def test_towers_match_jax(tower_refs, name):
    """The port's tower against the JAX tower in its bf16 paths (both
    kernel modes where they differ): outputs, ``seq_len`` (exact,
    ``ceil(seq_len / pt)`` per time pool) and statistics within ``1e-4 +
    3e-2 * max|ref|``. Gradients against JAX's f32 path
    (``compute_dtype='float32'``, which an f64 run of the same tower
    agrees with to f32 rounding), by the noise rule: within the larger of
    ``1e-4 + 3.5e-2 * max|ref|`` and three times JAX's own bf16 paths'
    distance from it (a random cotangent through training batch norm
    cancels, so some gradients sit far above 3.5e-2 of their largest
    element in JAX's bf16 path alone). A relu gate or a max pool's
    choice within one rounding of its edge can fall either way: e.g. in
    'time_pools_1d_eval' a pre-activation of -6.5e-4, which the port and
    JAX's eager forward leave shut and its jitted XLA opens, moves one
    element of ``norm_3.shift`` by 0.88 of 6; and the 2-D towers pool
    bf16 values where JAX's unpacked layers pool f32, which ties what
    f32 orders. So a gradient may pass the bound by up to ``EDGE`` times
    if it keeps a cosine to the f32 one of at least .99 (the rule of
    ``tests/test_torch_deep.py`` for model gradients) or, where lower, one
    less three times JAX's own bf16 distance from 1 (tensors of 16
    elements and more)."""
    cases, refs = tower_refs
    case = cases[name]
    port = _port_tower(case)
    xt = torch.from_numpy(case['x']).requires_grad_()
    build.reset_launches()
    y, sl = port(xt, torch.from_numpy(case['seq_len']))
    (y.float() * torch.from_numpy(case['gy'])).sum().backward()
    _no_launch()
    stats = bridge.export_flat(port)
    grads = {f'params.{k}': p.grad.numpy()
             for k, p in port.named_parameters()}
    grads['input'] = xt.grad.numpy()
    pools = [p[1] if isinstance(p, list) else p
             for p in to_list(case['kwargs']['pool_size'],
                              len(case['kwargs']['out_channels']))]
    np.testing.assert_array_equal(
        sl.numpy(), -(-case['seq_len'] // int(np.prod(pools))))
    if case['kwargs'].get('norm') != 'batch':
        assert not any(key.startswith('batch_stats') for key in stats)
    paths = [refs[mode][name] for mode in ('force_interpret', 'auto')
             if name in refs[mode]]
    for ref in paths:
        np.testing.assert_array_equal(sl.numpy(), ref['seq_len'])
        _close(y.float().detach().numpy(), ref['y'])
        assert set(ref['stats']) == {key for key in stats
                                     if key.startswith('batch_stats.')}
        for key, value in ref['stats'].items():
            _close(stats[key], value)
        assert set(grads) == set(ref['grads'])
    exact = refs['f32'][name]['grads']
    for key, got in grads.items():
        want = exact[key]
        noise = max(float(np.abs(ref['grads'][key] - want).max())
                    for ref in paths)
        bound = max(1e-4 + 3.5e-2 * float(np.abs(want).max()), 3 * noise)
        err = float(np.abs(got - want).max())
        assert err <= EDGE * bound, (key, err / bound)
        if err > bound and got.size >= 16:
            floor = min(.99, *(1 - 3 * (1 - _cosine(ref['grads'][key], want))
                               for ref in paths))
            assert _cosine(got, want) >= floor, (key, err / bound)


@pytest.mark.parametrize('name', ACTIVATIONS)
def test_activations_match_flax(name):
    """Each name ``_act`` takes against ``getattr(flax.linen, name)``,
    element by element in f32 with its gradient (1e-6 relative; softmax,
    log_softmax and standardize over the channel axis)."""
    v = np.random.RandomState(2).randn(3, 5, 16).astype(np.float32) * 4.
    g = np.random.RandomState(3).randn(3, 5, 16).astype(np.float32)
    want, vjp = jax.vjp(jcnn._act(name), jnp.asarray(v))
    (dwant,) = vjp(jnp.asarray(g))
    vt = torch.from_numpy(v).requires_grad_()
    got = tcnn._act(name)(vt)
    (dgot,) = torch.autograd.grad(got, vt, torch.from_numpy(g))
    for a, b in ((got.detach(), want), (dgot, dwant)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(b).max()))


def test_fused_layers_take_jax_per_layer_terms():
    """``fuse_bn`` fuses a layer only where the JAX plan could: not a time
    pool, not Cout % 16, not a (2, 1) pool on an odd F, not an even
    kernel."""
    tower = tcnn.CNN2d(out_channels=[16, 16, 24, 32, 32, 32, 32],
                       kernel_size=[3, 3, 3, 3, [2, 3], 3, 3],
                       pool_size=[1, [2, 2], 1, [2, 1], 1, [2, 1], 1],
                       pre_activation=True, fuse_bn=True, in_channels=1,
                       input_height=10)
    # 0: Cin 1; 1: time pool; 2: Cout 24; 3: Cin 24; 4: even kernel;
    # 5: a (2, 1) pool on F = 3 (10 -> 5 -> 3, ceil as the plan counts)
    assert tower.fused == {6}
    assert tower.fused_layers(1, 40) == {5, 6}     # 40 -> 20 -> 10


# -- a tiny time-pooled FBCRNN -----------------------------------------------

K = 10
SAMPLES = 8000          # 0.5 s at 16 kHz -> 50 frames at shift 160
POOLED = {
    'feature_extractor': {
        'sample_rate': 16000, 'stft_size': 512, 'stft_shift': 160,
        'stft_window_length': 480, 'number_of_filters': 16,
    },
    'cnn': {
        'cnn_2d': {
            'out_channels': [16, 16, 24, 32], 'kernel_size': [3, 3, 3, 2],
            'pool_size': [1, [2, 2], 1, [2, 2]],
            'residual_connections': [None, 3, None, None],
            'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
            'pre_activation': True, 'use_pallas': True,
        },
        'cnn_1d': {'out_channels': [32, 32], 'kernel_size': [1, 3],
                   'pool_size': [1, 1], 'norm': 'batch',
                   'norm_kwargs': {'eps': 1e-3}, 'pre_activation': True},
    },
    'rnn_fwd': {
        'rnn': {'hidden_size': 32, 'num_layers': 1, 'use_pallas': True},
        'output_net': {'out_channels': [32, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
    'strong_fwd_bwd_loss_weight': 0.,
}


def _pooled_config(**updates):
    config = pickle.loads(pickle.dumps(POOLED))
    config.update(updates)
    return config


def _batch(seed, lens=(50, 33), targets=True):
    """Two clips (the second shorter: 33 frames, ceil(33 / 4) = 9 of the
    12 pooled frames; 50 frames give 13 > 12 pooled)."""
    rng = np.random.RandomState(seed)
    audio = (.3 * rng.randn(2, SAMPLES)).astype(np.float32)
    seq_len = np.array(lens, np.int32)
    audio[1, seq_len[1] * 160:] = 0.
    out = {'audio_data': audio, 'seq_len': seq_len}
    if targets:
        weak = (rng.rand(2, K) > .5).astype(np.float32)
        weak[0, 3] = .5
        out.update(weak_targets=weak, boundary_targets=(
            rng.rand(2, K, 50) > .6).astype(np.float32))
    return out


@pytest.fixture(scope='module')
def pooled_flat():
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(_pooled_config()))
    jmodel.variables = jax.jit(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(
            _batch(0, targets=False))
    return bridge.random_flat(jmodel.state_dict(), 11)


def _models(flat, **updates):
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        _pooled_config(**updates)))
    jmodel.load_state_dict(flat)
    tmodel = tweak.CRNN.from_config(tweak.CRNN.get_config(
        _pooled_config(**updates)), device='cpu')
    bridge.load_flat(tmodel.module, flat)
    return jmodel, tmodel


def test_time_pooled_fbcrnn_serves_like_jax(pooled_flat):
    """seq_len_y exceeds T (50 frames -> T = 12, seq_len 13): the heads'
    masks, ``take_last`` (clipped) and the backward head's reversal
    (modulo T) agree with JAX; tagging, boundaries and SED. JAX on XLA
    ('auto'): its tower takes no packed window here (the time pools and
    Cout 24 break it), so its kernel modes differ only in the GRU, which
    the GRU tests hold."""
    jmodel, tmodel = _models(pooled_flat)
    batch = _batch(1, targets=False)
    jy_fwd, jy_bwd, jsl, _, _ = jmodel._apply(batch)
    ty_fwd, ty_bwd, tsl, _, _ = tmodel._apply(batch, 'forward')
    assert ty_fwd.shape[-1] == 12
    np.testing.assert_array_equal(tsl.numpy(), [13, 9])
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    _close(ty_fwd.numpy(), jy_fwd)
    _close(ty_bwd.numpy(), jy_bwd)
    for method in ('tagging', 'boundaries_detection'):
        jy, jsl = getattr(jmodel, method)(batch)
        ty, tsl = getattr(tmodel, method)(batch)
        np.testing.assert_array_equal(tsl, jsl)
        _close(ty, jy)
    jy, jsl = jmodel.sound_event_detection(batch, 5, window_shift=1)
    ty, tsl = tmodel.sound_event_detection(batch, 5, window_shift=1)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)


def _jax_loss_and_grads(model, batch, mode):
    jrnn.set_pallas_mode(mode)
    variables = model.variables

    def loss_of(params):
        return model.loss_fn(dict(variables, params=params), batch, {},
                             training=True)

    (loss, aux), grads = jax.jit(jax.value_and_grad(
        loss_of, has_aux=True))(variables['params'])
    return (float(loss), flatten_variables({'params': grads}),
            flatten_variables({'batch_stats': aux[0]['batch_stats']}))


def test_time_pooled_fbcrnn_step_matches_jax(pooled_flat):
    """One training step's loss, gradients and statistics with no strong
    loss (the AudioSet recipe): the boundary targets at the feature rate
    are not touched."""
    batch = _batch(2)
    jmodel, tmodel = _models(pooled_flat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads, jstats = _jax_loss_and_grads(jmodel, jbatch,
                                                'force_interpret')
    _, xla_grads, _ = _jax_loss_and_grads(jmodel, jbatch, 'auto')
    tmodel.module.train()
    loss, _ = tmodel.loss(tmodel.to_device(batch))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    for name, p in tmodel.module.named_parameters():
        key = f'params.{name}'
        ref, got = jgrads[key], p.grad.numpy()
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()),
                    2 * float(np.abs(xla_grads[key] - ref).max()))
        assert float(np.abs(got - ref).max()) <= bound, name
    stats = bridge.export_flat(tmodel.module)
    for key, ref in jstats.items():
        _close(stats[key], ref)


def test_time_pooled_strong_loss_fails_in_both_packages(pooled_flat):
    """With a strong loss weight above 0 the boundary targets (50 frames)
    do not match the pooled outputs (12): both packages fail."""
    batch = _batch(2)
    jmodel, tmodel = _models(pooled_flat, strong_fwd_bwd_loss_weight=1.)
    with pytest.raises((TypeError, ValueError)):
        _jax_loss_and_grads(jmodel, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, 'auto')
    tmodel.module.train()
    with pytest.raises(RuntimeError):
        tmodel.loss(tmodel.to_device(batch))


def test_time_pooled_stacked_ensemble_equals_members(pooled_flat):
    """Two members stacked (one launch per layer under ``vmap``, the new
    pools' vmap rules) give what the members run in turn give (1e-6:
    the mean of two scores in another order)."""
    _, one = _models(pooled_flat)
    _, two = _models(bridge.random_flat(bridge.export_flat(one.module), 12))
    batches = [{**_batch(3, targets=False), 'example_id': ['a', 'b']}]
    for method, kwargs in (('tagging', {}), ('sound_event_detection', {
            'model_kwargs': {'window_length': 5, 'window_shift': 1}})):
        stacked = getattr(tbase, method)([one, two], batches, **kwargs)
        in_turn = getattr(tbase, method)([one, two], batches,
                                         auto_stack=False, **kwargs)
        assert sorted(stacked) == sorted(in_turn)
        for clip in stacked:
            np.testing.assert_allclose(stacked[clip], in_turn[clip],
                                       rtol=0, atol=1e-6)


# -- refusals ----------------------------------------------------------------

@pytest.mark.parametrize('name', ['glu', 'one_hot', 'logsumexp', 'PReLU'])
def test_shape_changing_activations_raise_naming_the_name(name):
    with pytest.raises(ValueError, match=name):
        tcnn.CNN2d(out_channels=[16], activation_fn=name)
    with pytest.raises(ValueError, match=name):
        tcnn.CNN1d(out_channels=[16], activation_fn=name)


def test_float32_compute_builds_f32_layers_and_other_dtypes_raise():
    """``compute_dtype='float32'`` (and None, which the JAX package reads
    as float32) builds f32 convs and no fused layer
    (``tests/test_torch_f32.py`` holds them against JAX); any other value
    raises, naming it."""
    for dtype in ('float32', None):
        tower = tcnn.CNN2d(out_channels=[16, 16], fuse_bn=True,
                           pre_activation=True, compute_dtype=dtype,
                           in_channels=16)
        assert tower.conv_0.dtype == torch.float32 and not tower.fused
        tower = tcnn.CNN1d(out_channels=[16], compute_dtype=dtype,
                           in_channels=8)
        assert tower.conv_0.dtype == torch.float32
    for cls in (tcnn.CNN2d, tcnn.CNN1d):
        with pytest.raises(NotImplementedError, match='float16'):
            cls(out_channels=[16], compute_dtype='float16')


def test_bridge_takes_the_new_towers_keys_and_shapes():
    """The JAX variables of a norm-free tower with even and off-16
    kernels (no ``norm_{i}`` keys, kernels (2, 2, 24, 10) and the like)
    load into the port strictly, and ``bridge.init_flat`` of the port's
    template draws the same keys and shapes."""
    config = _pooled_config()
    towers = config['cnn']
    towers['cnn_2d'].update(norm=None, activation_fn='gelu',
                            out_channels=[10, 24, 40, 32],
                            kernel_size=[[2, 2], 3, [4, 3], 1])
    towers['cnn_1d'].update(norm='layer', pool_size=[2, 1])
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(config))))
    batch = {'audio_data': jax.ShapeDtypeStruct((1, SAMPLES), jnp.float32),
             'seq_len': jax.ShapeDtypeStruct((1,), jnp.int32)}
    tree = jax.eval_shape(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), batch)
    shapes = {jax.tree_util.keystr(path, simple=True, separator='.'):
              tuple(leaf.shape) for path, leaf in
              jax.tree_util.tree_flatten_with_path(dict(tree))[0]}
    assert not any('.cnn_2d.norm_' in key or '.cnn_1d.norm_' in key
                   for key in shapes)
    assert shapes['params.cnn.cnn_2d.conv_0.kernel'] == (2, 2, 1, 10)
    assert shapes['params.cnn.cnn_2d.conv_2.kernel'] == (4, 3, 24, 40)
    tmodel = tweak.CRNN.from_config(tweak.CRNN.get_config(
        pickle.loads(pickle.dumps(config))), device='cpu')
    flat = {key: np.zeros(shape, np.float32)
            for key, shape in shapes.items()}
    bridge.load_flat(tmodel.module, flat)
    drawn = bridge.init_flat(bridge.export_flat(tmodel.module), 0)
    assert {k: v.shape for k, v in drawn.items()} == shapes
