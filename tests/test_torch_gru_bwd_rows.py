"""The GRU backward at shapes the wgmma rows design takes on the card
(``csrc/gru_bwd_rows.cuh``: every H up to 256 off the cluster design,
tiles of 64 rows): ``GruScan``'s gradients (the plain version on the CPU)
against the JAX package's ``gru_scan`` custom VJP, its Pallas kernels in
interpret mode, with batches off every row tile (the TPU kernel's, the
cluster design's 16 and the rows design's 64) and a random initial
state; and the width the backward wrappers pad a hidden size to, under
the designs the C rule would report."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas.gru import gru_scan as jax_gru_scan
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels import gru as kgru

torch.set_num_threads(2)


def _inputs(d, b, t, h, seed):
    rng = np.random.RandomState(seed)
    xw = rng.randn(d, b, t, 3 * h).astype(np.float32)
    w_hh = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_hh = (.1 * rng.randn(d, 3 * h)).astype(np.float32)
    h0 = (.5 * rng.randn(d, b, h)).astype(np.float32)
    g = rng.randn(d, b, t, h).astype(np.float32)
    return xw, w_hh, b_hh, h0, g


@pytest.mark.parametrize('d,b,t,h', [(2, 70, 9, 64), (2, 33, 7, 128),
                                     (1, 130, 5, 96)])
def test_gradients_match_jax_off_every_row_tile(d, b, t, h):
    """70, 33 and 130 rows (6, 1 and 2 past the last tile of 64; 6, 1, 2
    past the last of 16 and 32), H = 64, 128 and 96 (two, four and three
    blocks a cluster on the card), D = 2 and 1: ``GruScan`` forward and
    gradients for a random cotangent against the JAX custom VJP. The GRU
    ceiling as in ``test_torch_gru.py``: 5.3e-3 forward and 5.3e-3 of each
    gradient's largest entry (bf16 roundings of h and dgates that flip
    with the summation order)."""
    xw, w_hh, b_hh, h0, g = _inputs(d, b, t, h, seed=b + h)
    assert np.abs(h0).max() > .5
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
    y = kgru.GruScan.apply(*args)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=5.3e-3, rtol=0)
    grads = torch.autograd.grad(y, args, torch.from_numpy(g))
    # on the CPU the plain versions: no kernel counted
    assert build.LAUNCHES['gru_scan_bwd'] == 0
    assert build.LAUNCHES['gru_scan_bwd_rows'] == 0
    for name, got, r in zip(('dxw', 'dw_hh', 'db_hh', 'dh0'), grads, ref):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(
            got.numpy(), r, rtol=0, atol=5.3e-3 * float(np.abs(r).max()),
            err_msg=name)


def _fake_designs(cluster_widths):
    """A stand-in for the C design queries: every pass runs the cluster
    design at the widths in ``cluster_widths``, the rows design at any
    other."""
    def design(name, d, b, t, h):
        return {'design': 'cluster' if h in cluster_widths else kgru.ROWS}
    return design


@pytest.mark.parametrize('name', ['bwd', 'bwd_fused'])
@pytest.mark.parametrize('h,cluster_widths,want', [
    (128, {256, 512}, 128),   # the DCASE baseline's width as it is
    (100, {256, 512}, 128),
    (160, {256, 512}, 160),   # few rows: the rows design up to 192
    (192, {256, 512}, 192),
    (200, {256, 512}, 256),   # and the cluster design at 256 above
    (224, {256, 512}, 256),
    (200, {512}, 224),        # many rows: the rows design at any width
    (224, {512}, 224),
    (256, {256, 512}, 256),
    (256, {512}, 256),
    (300, {512}, 512),        # the rows design stops at 256
    (480, {512}, 512),
    (32, {256, 512}, 32),
])
def test_backward_pads_for_the_design(monkeypatch, name, h, cluster_widths,
                                      want):
    """The backwards run 129-192 at the next multiple of 32 on the rows
    design even where the cluster design takes 256 (the rows design is the
    faster there), 193-255 as 256 only where the cluster design takes 256
    (few rows), and 257-511 as 512 (the cluster design, which takes every
    shape at 512)."""
    monkeypatch.setattr(kgru, '_design', _fake_designs(cluster_widths))
    assert kgru.kernel_hidden(2, 32, 500, h, name) == want


def test_forward_still_pads_to_the_cluster_width(monkeypatch):
    """The forward's rule is its own: 129-255 as 256 where the cluster
    design takes 256 (few rows), while the backwards keep the real width
    up to 192."""
    monkeypatch.setattr(kgru, '_design', _fake_designs({256, 512}))
    assert kgru.kernel_hidden(2, 32, 500, 160, 'fwd') == 256
    assert kgru.kernel_hidden(2, 32, 500, 160, 'bwd') == 160
