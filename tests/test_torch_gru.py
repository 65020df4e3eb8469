"""The port's GRU recurrence (plain version on the CPU) against the JAX
package's Pallas GRU kernel in interpret mode and its ``lax.scan``
reference, at D=1 and D=2 and with T not a multiple of the TPU kernel's
time block (32); forward and gradients with a batch off the port
kernels' 16-row tile and a non-zero initial state."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas.gru import gru_scan as jax_gru_scan
from pb_sed_tpu.ops.pallas.gru import gru_scan_reference
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.gru import (GruScan, gru_scan,
                                              gru_scan_plain)

torch.set_num_threads(2)


def _inputs(d, b, t, h, seed=0):
    rng = np.random.RandomState(seed)
    xw = rng.randn(d, b, t, 3 * h).astype(np.float32)
    w_hh = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_hh = (.1 * rng.randn(d, 3 * h)).astype(np.float32)
    h0 = (.5 * rng.randn(d, b, h)).astype(np.float32)
    return xw, w_hh, b_hh, h0


@pytest.mark.parametrize('d,b,t,h', [(1, 3, 37, 32), (2, 4, 45, 32)])
def test_gru_scan_matches_jax(d, b, t, h):
    xw, w_hh, b_hh, h0 = _inputs(d, b, t, h)
    build.reset_launches()
    got = gru_scan(*map(torch.from_numpy, (xw, w_hh, b_hh, h0)))
    assert got.dtype == torch.float32 and got.shape == (d, b, t, h)
    assert build.LAUNCHES['gru_scan'] == 0
    got = got.numpy()
    kernel = np.asarray(jax_gru_scan(*map(jnp.asarray, (xw, w_hh, b_hh, h0)),
                                     True))
    # same rounding points as the Pallas kernel (bf16 xw and matmul
    # operands, f32 gates); the f32 summation order differs, which can
    # flip a bf16 rounding of h (2^-8 relative) before the next step's
    # matmul and so move later states by ~1e-3 at these weights: 2e-3
    np.testing.assert_allclose(got, kernel, atol=2e-3, rtol=0)
    scan = np.asarray(gru_scan_reference(*map(jnp.asarray,
                                              (xw, w_hh, b_hh, h0))))
    # the all-f32 scan: the TPU kernel's own measured drift against it,
    # 5.3e-3, is the ceiling
    np.testing.assert_allclose(got, scan, atol=5.3e-3, rtol=0)


@pytest.mark.parametrize('d,b,t,h', [(2, 21, 19, 32), (1, 17, 9, 64)])
def test_gru_scan_and_gradients_match_jax_off_the_row_tile(d, b, t, h):
    """B = 21 and 17 (not multiples of 16, the row tile of the port's
    kernels) with a random h0: ``GruScan`` forward and its gradients for a
    random cotangent against the JAX package's ``gru_scan`` and its custom
    VJP, both Pallas kernels in interpret mode. Tolerance: the GRU
    ceiling, 5.3e-3 forward and 5.3e-3 of each gradient's largest entry
    (bf16 roundings of h and dgates that flip with the summation
    order)."""
    xw, w_hh, b_hh, h0 = _inputs(d, b, t, h, seed=b)
    g = np.random.RandomState(b + 1).randn(d, b, t, h).astype(np.float32)
    assert np.abs(h0).max() > .5 and b % 16
    jrnn.set_pallas_mode('force_interpret')
    try:
        y_ref, vjp = jax.vjp(lambda *a: jax_gru_scan(*a, True),
                             *map(jnp.asarray, (xw, w_hh, b_hh, h0)))
        ref = vjp(jnp.asarray(g))
    finally:
        jrnn.set_pallas_mode('auto')
    args = [torch.from_numpy(a).requires_grad_()
            for a in (xw, w_hh, b_hh, h0)]
    build.reset_launches()
    y = GruScan.apply(*args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=5.3e-3, rtol=0)
    grads = torch.autograd.grad(y, args, torch.from_numpy(g))
    assert build.LAUNCHES['gru_scan'] == build.LAUNCHES['gru_scan_bwd'] == 0
    for name, got, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'), grads, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(
            got.numpy(), r, rtol=0, atol=5.3e-3 * float(np.abs(r).max()),
            err_msg=name)


def test_gru_scan_rejects_inconsistent_shapes():
    xw, w_hh, b_hh, h0 = map(torch.from_numpy, _inputs(1, 2, 5, 32))
    with pytest.raises(ValueError):
        gru_scan(xw, w_hh[:, :16], b_hh, h0)
    with pytest.raises(ValueError):
        gru_scan(xw[0], w_hh, b_hh, h0)


@pytest.mark.parametrize('n,shared_h0', [(3, True), (2, False)])
def test_members_fold_into_the_direction_axis(n, shared_h0):
    """N members' D = 2 recurrences as ONE D = 2N ``gru_scan_plain`` equal
    the N D = 2 calls, and so does ``GruScan`` under ``torch.func.vmap``
    (the stacked ensemble's one launch), with the zero initial state
    shared by the members or one state per member."""
    xw, w_hh, b_hh, h0 = map(torch.from_numpy, _inputs(2 * n, 3, 11, 32))
    ref = torch.cat([gru_scan_plain(xw[2 * i:2 * i + 2],
                                    w_hh[2 * i:2 * i + 2],
                                    b_hh[2 * i:2 * i + 2],
                                    h0[2 * i:2 * i + 2]) for i in range(n)])
    assert torch.equal(gru_scan_plain(xw, w_hh, b_hh, h0), ref)
    member = (lambda a: a.reshape(n, 2, *a.shape[1:]))
    if shared_h0:
        h0 = torch.zeros(2, 3, 32)
        ref = torch.cat([gru_scan_plain(xw[2 * i:2 * i + 2],
                                        w_hh[2 * i:2 * i + 2],
                                        b_hh[2 * i:2 * i + 2], h0)
                         for i in range(n)])
        got = torch.func.vmap(GruScan.apply, in_dims=(0, 0, 0, None))(
            member(xw), member(w_hh), member(b_hh), h0)
    else:
        got = torch.func.vmap(GruScan.apply)(
            member(xw), member(w_hh), member(b_hh), member(h0))
    assert torch.equal(got.reshape(ref.shape), ref)
