"""The port's backward kernels (their plain versions, on the CPU) against
the JAX package's Pallas backward kernels in interpret mode, on the same
numpy inputs: the SAME-conv backward (fused shapes, the Cin = 1 entry,
and a channel-blocked split shape), the freq max-pool backward
(bit-exact, ties and NaN) and the split and fused GRU backward.

Tolerances: conv ``1e-4 + 3.5e-2 * max|ref|`` per tensor, the JAX
package's own bound for packed-vs-XLA gradients
(``tests/test_pallas_conv.py:209``); GRU ``5.3e-3 * max|ref|``, the GRU
kernels' measured ceiling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas import conv as pconv
from pb_sed_tpu.ops.pallas.gru import (_gru_scan_pallas,
                                       _gru_scan_pallas_bwd, _to_tm)
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (Conv2dSame, MaxPoolFreq2,
                                               conv2d_same_bwd)
from pb_sed_tpu_torch.ops.kernels.gru import GruScan, gru_scan_bwd

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


def _close(got, ref, rel):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * float(np.max(np.abs(ref))) + 1e-4)


def _jax_conv_grads(x, w, b, gy):
    """jax.grad of the packed freq-major conv (Cin zero-padded to 16 as
    the packed tower's entry layer does)."""
    bsz, t, f, cin = x.shape
    cout = w.shape[-1]
    c16 = max(cin, 16)
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, c16 - cin)))
    wp = np.pad(w, ((0, 0), (0, 0), (0, c16 - cin), (0, 0)))
    g = pconv.fm_geom(t, f, 3, 3, max(c16, cout), cin=c16, cout=cout)

    def loss(x, w, b):
        y2 = pconv.conv2d_packed_fm(pconv.pack_fm(x, g), w, b, g, True)
        return jnp.sum(pconv.unpack_fm(y2, g, jnp.float32) * gy)

    dx, dw, db = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(b))
    return (np.asarray(dx)[..., :cin], np.asarray(dw)[:, :, :cin],
            np.asarray(db), g)


@pytest.mark.parametrize('bsz,t,f,cin,cout', [
    (2, 7, 8, 16, 32),    # fused _bwd_kernel
    (2, 6, 8, 1, 16),     # entry layer: dx has one channel
    (1, 5, 4, 128, 256),  # taps path, channel-blocked split dx/dw
])
def test_conv_backward_matches_jax(interpret_mode, bsz, t, f, cin, cout):
    rng = np.random.RandomState(cin + cout)
    x = (.5 * rng.randn(bsz, t, f, cin)).astype(np.float32)
    w = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    b = (.1 * rng.randn(cout)).astype(np.float32)
    gy = rng.randn(bsz, t, f, cout).astype(np.float32)
    jdx, jdw, jdb, g = _jax_conv_grads(x, w, b, gy)
    if cin == 128:
        # the JAX backward takes the channel-blocked split pair here
        assert pconv._use_taps(g, cout)
        assert pconv._cb_bwd_of(cin, cout, g.ls) == 128
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = Conv2dSame.apply(xt, wt, bt)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(gy)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    for got, ref in ((xt.grad.float(), jdx), (wt.grad, jdw), (bt.grad, jdb)):
        _close(got.numpy(), ref, 3.5e-2)
    # the wrapper itself (the kernel's contract: bf16 dx, f32 dw)
    build.reset_launches()
    dx, dw = conv2d_same_bwd(xt.detach(), wt.detach(),
                             torch.from_numpy(gy).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    torch.testing.assert_close(dx, xt.grad, rtol=0, atol=0)
    assert build.LAUNCHES['conv2d_same_bwd'] == 0


def _tie_heavy(rng, bsz, t, f, c):
    """bf16-exact values with many ties between freq row pairs: constant
    rows (the padded frames of a batch), duplicated rows, and NaNs."""
    x = np.round(rng.randn(bsz, t, f, c) * 4) / 4
    x[:, -2:] = 1.5                        # constant frames: all tie
    x[:, :, 1::4] = x[:, :, 0::4]          # row pairs (0, 1) tie
    x[0, 0, 2, :3] = np.nan                # NaN in the first row
    x[0, 1, 5, :3] = np.nan                # NaN in the second row
    x[0, 2, 6:8, 0] = np.nan               # both NaN
    return x.astype(np.float32)


def test_maxpool_backward_ties_first_row_bit_exact(interpret_mode):
    """A tie routes the whole cotangent to the first row, as the TPU
    kernel does (autograd of torch.maximum would split it in halves)."""
    rng = np.random.RandomState(1)
    bsz, t, f, c = 2, 5, 8, 16
    x = _tie_heavy(rng, bsz, t, f, c)
    gy = rng.randn(bsz, t, f // 2, c).astype(np.float32)
    g = pconv.fm_geom(t, f, 3, 3, c)
    g_out = g._replace(t=f // 2, tp=f // 2, ls=f // 2 * g.fs)

    def pool(x):
        y2 = pconv.maxpool2_rows_packed(pconv.pack_fm(x, g), f // 2, g.fs,
                                        True)
        return pconv.unpack_fm(y2, g_out, jnp.float32)

    y_ref, vjp = jax.vjp(pool, jnp.asarray(x))
    (dx_ref,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = MaxPoolFreq2.apply(xt)
    np.testing.assert_array_equal(y.float().detach().numpy(),
                                  np.asarray(y_ref))
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy).to(y.dtype))
    assert dx.dtype == torch.bfloat16
    np.testing.assert_array_equal(dx.float().numpy(), np.asarray(dx_ref))
    # every tie went whole to the first row
    tie = x[:, :, 0::2] == x[:, :, 1::2]
    assert tie.sum() > 100
    gyb = torch.from_numpy(gy).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(dx.float().numpy()[:, :, 0::2][tie],
                                  gyb[tie])


def _gru_inputs(d, b, t, h, seed=0):
    rng = np.random.RandomState(seed)
    xw = rng.randn(d, b, t, 3 * h).astype(np.float32)
    w_hh = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_hh = (.1 * rng.randn(d, 3 * h)).astype(np.float32)
    h0 = (.5 * rng.randn(d, b, h)).astype(np.float32)
    g = rng.randn(d, b, t, h).astype(np.float32)
    return xw, w_hh, b_hh, h0, g


@pytest.mark.parametrize('d,b,t,h', [(1, 6, 11, 8), (2, 6, 11, 16),
                                     (2, 3, 13, 32)])
def test_gru_backward_matches_jax_split_kernel(d, b, t, h):
    """Batch 6 with JAX blocks of 4 rows (a partial block, the
    regression of tests/test_pallas.py:235) and T not a multiple of the
    time block (8)."""
    xw, w_hh, b_hh, h0, g = _gru_inputs(d, b, t, h, seed=d * 10 + h)
    xw = jnp.asarray(xw).astype(jnp.bfloat16).astype(jnp.float32)
    y = _gru_scan_pallas(xw, w_hh, b_hh, h0, interpret=True,
                         block_b=4, block_t=8)
    ref = _gru_scan_pallas_bwd(_to_tm(xw), w_hh, b_hh, h0, y, g,
                               interpret=True, block_b=4, block_t=8,
                               split=True)
    got = gru_scan_bwd(*(torch.from_numpy(np.array(a, np.float32))
                         for a in (xw, w_hh, b_hh, h0, y, g)))
    assert got[0].dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in got[1:])
    for name, a, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'), got, ref):
        _close(a.float().numpy(), np.asarray(r, np.float32), 5.3e-3)


@pytest.mark.parametrize('d,b,t,h', [(1, 6, 11, 8), (2, 6, 11, 16),
                                     (2, 3, 13, 32)])
def test_gru_fused_backward_matches_jax_fused_kernel(d, b, t, h):
    """``gru_scan_bwd(split=False)`` against
    ``_gru_scan_pallas_bwd(split=False)``, the kernel that accumulates
    dw_hh/db_hh in its sweep (the blocks and shapes of the split test
    above); dxw and dh0 come from the same sweep as the split variant's,
    bit for bit."""
    xw, w_hh, b_hh, h0, g = _gru_inputs(d, b, t, h, seed=d * 10 + h + 1)
    xw = jnp.asarray(xw).astype(jnp.bfloat16).astype(jnp.float32)
    y = _gru_scan_pallas(xw, w_hh, b_hh, h0, interpret=True,
                         block_b=4, block_t=8)
    ref = _gru_scan_pallas_bwd(_to_tm(xw), w_hh, b_hh, h0, y, g,
                               interpret=True, block_b=4, block_t=8,
                               split=False)
    args = [torch.from_numpy(np.array(a, np.float32))
            for a in (xw, w_hh, b_hh, h0, y, g)]
    build.reset_launches()
    got = gru_scan_bwd(*args, split=False)
    assert got[0].dtype == torch.bfloat16
    assert all(a.dtype == torch.float32 for a in got[1:])
    for name, a, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'), got, ref):
        _close(a.float().numpy(), np.asarray(r, np.float32), 5.3e-3)
    split = gru_scan_bwd(*args)
    for i in (0, 3):
        torch.testing.assert_close(got[i], split[i], rtol=0, atol=0)
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}


def test_gru_scan_function_matches_jax_vjp(interpret_mode):
    """GruScan's forward and backward through autograd against the JAX
    package's gru_scan custom VJP (both kernels in interpret mode)."""
    from pb_sed_tpu.ops.pallas.gru import gru_scan as jax_gru_scan
    xw, w_hh, b_hh, h0, g = _gru_inputs(2, 5, 9, 32, seed=4)
    y_ref, vjp = jax.vjp(lambda *a: jax_gru_scan(*a, True),
                         *map(jnp.asarray, (xw, w_hh, b_hh, h0)))
    ref = vjp(jnp.asarray(g))
    args = [torch.from_numpy(a).requires_grad_()
            for a in (xw, w_hh, b_hh, h0)]
    y = GruScan.apply(*args)
    _close(y.detach().numpy(), y_ref, 5.3e-3)
    grads = torch.autograd.grad(y, args, torch.from_numpy(g))
    for got, r in zip(grads, ref):
        _close(got.numpy(), np.asarray(r), 5.3e-3)
