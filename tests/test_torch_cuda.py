"""The port's CUDA kernels against their plain versions on the card, at
edge shapes the serving path does not reach (ragged tiles, channel counts
off the vector width, small hidden sizes). They need a CUDA card and
skip without one; ``chip_smoke.py`` covers the serving path's shapes.

On the card (no JAX there, so without this directory's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (conv2d_same,
                                               conv2d_same_plain,
                                               maxpool_freq2,
                                               maxpool_freq2_plain)
from pb_sed_tpu_torch.ops.kernels.gru import gru_scan, gru_scan_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    # the plain versions' f32 conv and matmul in full f32, not TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf', [
    (1, 7, 5, 1, 16, 3, 3),      # entry layer, ragged pixel tile
    (2, 9, 6, 5, 32, 3, 3),      # Cin off the 8-wide vector path
    (2, 11, 8, 24, 48, 5, 3),    # Cin not a multiple of 16, Cout 48
    (1, 4, 3, 16, 64, 1, 3),     # kt = 1
])
def test_conv2d_kernel_matches_plain(gen, b, t, f, cin, cout, kt, kf):
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    n = build.LAUNCHES['conv2d_same']
    got = conv2d_same(x, w, bias)
    assert build.LAUNCHES['conv2d_same'] == n + 1
    ref = conv2d_same_plain(x, w, bias)
    # one f32 sum rounded once to bf16 on both sides; summation order may
    # move that rounding by one bf16 ulp (2^-8 relative)
    tol = 2. ** -7 * float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= tol


@pytest.mark.parametrize('shape', [(2, 3, 6, 16), (1, 5, 4, 12)])
def test_maxpool_kernel_bit_exact(gen, shape):
    x = torch.randn(*shape, generator=gen, device='cuda').to(torch.bfloat16)
    x[0, 0, 0, :4] = float('nan')  # NaN wins, as in torch.maximum
    got = maxpool_freq2(x)
    ref = maxpool_freq2_plain(x)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())


@pytest.mark.parametrize('d,b,t,h', [(1, 5, 9, 32), (2, 33, 17, 64),
                                     (2, 3, 4, 512)])
def test_gru_kernel_matches_plain(gen, d, b, t, h):
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda')
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device='cuda') * h ** -.5
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h0 = .5 * torch.randn(d, b, h, generator=gen, device='cuda')
    got = gru_scan(xw, w_hh, b_hh, h0)
    ref = gru_scan_plain(xw, w_hh, b_hh, h0)
    # same bf16 rounding points; summation order may flip a bf16 rounding
    # of h before the next step's matmul: the TPU kernel's measured
    # drift, 5.3e-3, bounds it
    assert float((got - ref).abs().max()) <= 5.3e-3


def test_kernels_raise_on_unsupported_shapes(gen):
    x = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16, device='cuda')
    with pytest.raises(ValueError):
        conv2d_same(x, torch.zeros(3, 3, 16, 8, device='cuda'), None)
    xw = torch.zeros(1, 2, 3, 3 * 48, device='cuda')
    with pytest.raises(ValueError):  # H = 48 is not a multiple of 32
        gru_scan(xw, torch.zeros(1, 48, 144, device='cuda'),
                 torch.zeros(1, 144, device='cuda'),
                 torch.zeros(1, 2, 48, device='cuda'))
