"""The GRU forward at the many-row shapes that the wgmma rows design takes
on the card (``csrc/gru_rows.cuh``): the port's ``gru_scan`` (its plain
version on the CPU) against the JAX package's Pallas GRU kernel in
interpret mode and its ``lax.scan`` reference, with batches off every
row tile (the TPU kernel's 32, the rows design's 64) and a random
initial state; and the wrapper's choice of the width it pads a hidden
size to, under the designs the C rule would report."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops.pallas.gru import gru_scan as jax_gru_scan
from pb_sed_tpu.ops.pallas.gru import gru_scan_reference
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels import gru as kgru

torch.set_num_threads(2)


def _inputs(d, b, t, h, seed=0):
    rng = np.random.RandomState(seed)
    xw = rng.randn(d, b, t, 3 * h).astype(np.float32)
    w_hh = (rng.randn(d, h, 3 * h) / np.sqrt(h)).astype(np.float32)
    b_hh = (.1 * rng.randn(d, 3 * h)).astype(np.float32)
    h0 = (.5 * rng.randn(d, b, h)).astype(np.float32)
    return xw, w_hh, b_hh, h0


@pytest.mark.parametrize('d,b,t,h', [(2, 300, 11, 64), (4, 130, 7, 96)])
def test_many_rows_match_jax(d, b, t, h):
    """300 and 130 rows (4 and 2 rows past the last tile of 64, 12 and 2
    past the last of 32), H = 64 and 96 (one and three blocks a cluster
    on the card). Tolerances as in ``test_torch_gru.py``: 2e-3 against
    the Pallas kernel (the same rounding points; the summation order can
    flip a bf16 rounding of h), 5.3e-3 against the all-f32 scan (the TPU
    kernel's own measured drift)."""
    xw, w_hh, b_hh, h0 = _inputs(d, b, t, h)
    build.reset_launches()
    got = kgru.gru_scan(*map(torch.from_numpy, (xw, w_hh, b_hh, h0)))
    assert got.dtype == torch.float32 and got.shape == (d, b, t, h)
    assert build.LAUNCHES['gru_scan'] == build.LAUNCHES['gru_scan_rows'] == 0
    got = got.numpy()
    kernel = np.asarray(jax_gru_scan(*map(jnp.asarray, (xw, w_hh, b_hh, h0)),
                                     True))
    np.testing.assert_allclose(got, kernel, atol=2e-3, rtol=0)
    scan = np.asarray(gru_scan_reference(*map(jnp.asarray,
                                              (xw, w_hh, b_hh, h0))))
    np.testing.assert_allclose(got, scan, atol=5.3e-3, rtol=0)


def _fake_designs(cluster_widths):
    """A stand-in for the C design query: the forward runs the cluster
    design at the widths in ``cluster_widths``, the rows design at any
    other."""
    def design(name, d, b, t, h):
        return {'design': 'cluster' if h in cluster_widths else kgru.ROWS}
    return design


@pytest.mark.parametrize('h,cluster_widths,want', [
    (200, {256}, 256),    # few rows: the cluster design at 256
    (200, set(), 224),    # many rows: the rows design at 224, not 256
    (64, set(), 64),
    (96, set(), 96),
    (300, {512}, 512),
    (300, set(), 320),
    (480, set(), 480),
])
def test_kernel_hidden_pads_for_the_design(monkeypatch, h, cluster_widths,
                                           want):
    """``kernel_hidden`` pads to 256 or 512 only where the cluster design
    takes that width at the shape; where the rows design runs it pads to
    the next multiple of 32, which that design takes as it is."""
    monkeypatch.setattr(kgru, '_design', _fake_designs(cluster_widths))
    assert kgru.kernel_hidden(2, 16000, 51, h) == want


def test_design_names():
    """The C queries' return codes name the designs: 1 the cluster
    designs, 2 the wgmma rows designs (forward and backwards), 3 the grid
    design above H = 2048; no design is row-tiled any more."""
    assert kgru._DESIGNS == {1: 'cluster', 2: 'wgmma_rows', 3: 'grid'}
    assert kgru.ROWS == 'wgmma_rows' and kgru.GRID == 'grid'
