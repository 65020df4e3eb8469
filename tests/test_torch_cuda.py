"""The port's CUDA kernels, forward and backward, against their plain
versions on the card, at edge shapes the main path does not reach (ragged
tiles, channel counts off the vector width, small hidden sizes, the
Cin = 1 input gradient, batches off the GRU tile, tie- and NaN-heavy
pools, the BN+ReLU-fused conv with a positive shift at the borders, the
fused GRU backward at batches off its tile, the GRU's cluster design at
both widths with ragged row tiles and a random initial state beside the
row-tiled one at small hidden sizes, the wgmma conv kernels'
ragged pixel tiles, frequency rows and channel widths, and at every F
(tiles of whole rows off a power of two, of 128 pixels of a frame above
128), Cin off a multiple of 8 and the dx of Cin < 16, the entry conv
pair at Cin < 16 (F 128, 40 and odd, extents 3x3, 5x3, 1x1 and even,
Cout 16 to 48, with a member axis, dw with and without dx), the member
axis of the forward convs and the GRU at D = 2N that a stacked ensemble
launches; the max and average pools of any window, odd extents, bf16
and f32; the conv at Cout off a multiple of 16 and even kernel extents;
the GRU at hidden sizes off a multiple of 32 and on the cluster design of
16 blocks above 512; the f32 conv and its backward on its three designs,
the entry kernels at the recipes' entry widths, F 40 and odd, with a
member axis, dw over 256 000 pixels on 3xTF32 and on the entry kernels),
the determinism
of the weight gradients, and the wrappers' raises. They need a CUDA card and
skip without one; ``chip_smoke.py`` covers the main path's shapes.

On the card (no JAX there, so without this directory's conftest):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import pytest
import torch

from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (
    avgpool_freq2, avgpool_freq2_bwd, avgpool_freq2_bwd_plain,
    avgpool_freq2_plain, bnrelu_conv2d_same, bnrelu_conv2d_same_bwd,
    bnrelu_conv2d_same_bwd_plain, bnrelu_conv2d_same_members,
    bnrelu_conv2d_same_members_plain, bnrelu_conv2d_same_plain, conv2d_same,
    conv2d_same_bwd, conv2d_same_bwd_plain, conv2d_same_members,
    conv2d_same_members_plain, conv2d_same_plain, conv_designs,
    maxpool_freq2, maxpool_freq2_bwd, maxpool_freq2_bwd_plain,
    maxpool_freq2_plain, avgpool2d, avgpool2d_bwd, avgpool2d_bwd_plain,
    avgpool2d_plain, maxpool2d, maxpool2d_bwd, maxpool2d_bwd_plain,
    maxpool2d_plain)
from pb_sed_tpu_torch.ops.kernels.conv import (
    conv2d_same_f32, conv2d_same_f32_bwd, conv2d_same_f32_bwd_plain,
    conv2d_same_f32_members, conv2d_same_f32_plain, conv_f32_designs)
from pb_sed_tpu_torch.ops.kernels.gru import (GRU_FUSED_MAX_HIDDEN,
                                              GRU_MAX_HIDDEN, GruScan,
                                              gru_designs, gru_scan,
                                              gru_scan_bwd,
                                              gru_scan_bwd_plain,
                                              gru_scan_plain)

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
    (2, 9, 16, 11, 16, 3, 3),    # the tag-conditioned entry layer
    (2, 11, 8, 24, 48, 5, 3),    # Cin not a multiple of 16, Cout 48
    (1, 4, 3, 16, 64, 1, 3),     # kt = 1
    (2, 5, 8, 256, 512, 3, 3),   # deep L16's channels, ragged pixel tile
    (1, 7, 8, 512, 512, 1, 1),   # deep L17: the 1x1 conv
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


# C = 16, 8 and 24 (an odd number of 16-byte vectors) take the vector
# kernel, C = 12 the scalar path; the last shape's 162 825 rows of two
# vectors leave a partial last block
@pytest.mark.parametrize('shape', [(2, 3, 6, 16), (1, 5, 4, 12),
                                   (2, 3, 6, 8), (3, 7, 10, 24),
                                   (5, 501, 130, 16)])
def test_maxpool_kernel_bit_exact(gen, shape):
    x = torch.randn(*shape, generator=gen, device='cuda').to(torch.bfloat16)
    x[0, 0, 0, :4] = float('nan')  # NaN wins, as in torch.maximum
    x[0, 0, 3, :2] = float('nan')  # in the second row
    x[0, 0, 2, 1] = float('nan')   # and in both rows
    x[:, 1, 1::2] = x[:, 1, 0::2]  # ties
    got = maxpool_freq2(x)
    ref = maxpool_freq2_plain(x)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())


# (D, B, T, H): H = 32 and 64 run the row-tiled kernels; H = 256 and 512
# with few rows the cluster design, here with one and two row tiles, rows
# past the batch in a tile (B = 5, 3, 33) and T odd and even
GRU_SHAPES = [(1, 5, 9, 32), (2, 33, 17, 64), (2, 3, 4, 512),
              (2, 32, 40, 256), (2, 33, 17, 512), (1, 5, 9, 256),
              (2, 16, 1, 512)]


def _gru_design_is_expected(d, b, t, h):
    want = 'cluster' if h in (256, 512) else 'row_tiled'
    designs = gru_designs(d, b, t, h)
    return all(designs[k]['design'] == want for k in ('fwd', 'bwd'))


@pytest.mark.parametrize('d,b,t,h', GRU_SHAPES)
def test_gru_kernel_matches_plain(gen, d, b, t, h):
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda')
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device='cuda') * h ** -.5
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h0 = .5 * torch.randn(d, b, h, generator=gen, device='cuda')
    assert _gru_design_is_expected(d, b, t, h)
    n = build.LAUNCHES['gru_scan']
    got = gru_scan(xw, w_hh, b_hh, h0)
    assert build.LAUNCHES['gru_scan'] == n + 1
    ref = gru_scan_plain(xw, w_hh, b_hh, h0)
    # same bf16 rounding points; summation order may flip a bf16 rounding
    # of h before the next step's matmul: the TPU kernel's measured
    # drift, 5.3e-3, bounds it
    assert float((got - ref).abs().max()) <= 5.3e-3
    assert torch.equal(got, gru_scan(xw, w_hh, b_hh, h0))


def test_gru_design_by_shape(gen):
    """The cluster design takes the training shapes (16 rows a cluster
    while all clusters are on the card at once) and, at H = 512, the
    sliding-window one (32 rows a cluster forward); at H = 256 that shape
    keeps the row-tiled kernels. The fused backward follows the split
    one."""
    for h, cluster in ((256, 8), (512, 16)):
        train = gru_designs(2, 32, 500, h)
        for key in ('fwd', 'bwd', 'bwd_fused'):
            assert train[key]['design'] == 'cluster'
            assert train[key]['cluster'] == cluster
            assert train[key]['coresident'] >= 1
            assert train[key]['smem'] <= 232448
            # an H100 holds 7 clusters of 16 blocks and 15 of 8: the 4
            # clusters of 16 rows are all on the card at once
            assert train[key]['coresident'] >= 4
            assert train[key]['rows'] == 16
    sed = gru_designs(2, 16000, 51, 512)
    assert all(sed[key]['design'] == 'cluster' for key in sed)
    assert (sed['fwd']['rows'], sed['bwd']['rows']) == (32, 16)
    assert sed['bwd_fused']['rows'] == 16
    sed = gru_designs(2, 16000, 51, 256)
    for key in ('fwd', 'bwd', 'bwd_fused'):
        assert sed[key]['design'] == 'row_tiled'
        assert sed[key]['cluster'] == 1
    assert gru_designs(2, 16000, 51, 64)['fwd']['design'] == 'row_tiled'


@pytest.mark.parametrize('shape,cout,dtype', [
    ((2, 3, 6, 16), 16, torch.bfloat16),
    ((2, 3, 6, 16), 32, torch.bfloat16),   # the fused channel pad
    ((1, 5, 4, 12), 20, torch.bfloat16),   # C off the vector width
    ((2, 7, 8, 24), 48, torch.float32),    # a residual's second pool
])
def test_avgpool_kernel_bit_exact(gen, shape, cout, dtype):
    x = torch.randn(*shape, generator=gen, device='cuda').to(dtype)
    n = build.LAUNCHES['avgpool_freq2']
    got = avgpool_freq2(x, cout)
    assert build.LAUNCHES['avgpool_freq2'] == n + 1
    assert torch.equal(got, avgpool_freq2_plain(x, cout))
    gy = torch.randn(shape[0], shape[1], shape[2] // 2, cout, generator=gen,
                     device='cuda')
    n = build.LAUNCHES['avgpool_freq2_bwd']
    dx = avgpool_freq2_bwd(gy, shape[3], dtype)
    assert build.LAUNCHES['avgpool_freq2_bwd'] == n + 1
    assert dx.dtype == dtype
    assert torch.equal(dx, avgpool_freq2_bwd_plain(gy, shape[3], dtype))


def test_kernels_raise_on_unsupported_shapes(gen):
    x = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16, device='cuda')
    with pytest.raises(ValueError):  # a kernel of 8 input channels
        conv2d_same(x, torch.zeros(3, 3, 8, 16, device='cuda'), None)
    h = GRU_MAX_HIDDEN + 1
    xw = torch.zeros(1, 2, 3, 3 * h, device='cuda')
    with pytest.raises(ValueError, match=str(GRU_MAX_HIDDEN)):
        gru_scan(xw, torch.zeros(1, h, 3 * h, device='cuda'),  # H > 2048
                 torch.zeros(1, 3 * h, device='cuda'),
                 torch.zeros(1, 2, h, device='cuda'))


def _max_err(got, ref):
    return float((got.float() - ref.float()).abs().max())


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf', [
    (1, 7, 5, 1, 16, 3, 3),      # Cin = 1 dx, odd B*T*F = 35
    (2, 9, 6, 5, 32, 3, 3),      # Cin off the vector width
    (2, 9, 16, 11, 16, 3, 3),    # the tag-conditioned entry layer's dx
    (3, 13, 8, 24, 48, 5, 3),    # Cout 48, kt = 5, B*T*F = 312
    (2, 50, 16, 128, 256, 3, 3), # the layer-9 channel counts
    (2, 9, 8, 256, 512, 3, 3),   # deep L16
    (1, 9, 8, 512, 512, 1, 1),   # deep L17, 1x1
])
def test_conv2d_backward_kernel_matches_plain(gen, b, t, f, cin, cout, kt,
                                              kf):
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda').to(
        torch.bfloat16)
    n = build.LAUNCHES['conv2d_same_bwd']
    dx, dw = conv2d_same_bwd(x, w, gy)
    assert build.LAUNCHES['conv2d_same_bwd'] == n + 1
    ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    # dx: one f32 sum rounded once to bf16 on both sides (one ulp);
    # dw: f32 sums in another order
    assert _max_err(dx, ref_dx) <= 2. ** -7 * float(ref_dx.float().abs().max())
    assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
    # the chunked reduction runs in a fixed order: bit-identical reruns
    dx2, dw2 = conv2d_same_bwd(x, w, gy)
    assert torch.equal(dw, dw2) and torch.equal(dx, dx2)


@pytest.mark.parametrize('shape', [(2, 3, 6, 16), (1, 5, 4, 12),
                                   (2, 7, 128, 16)])
def test_maxpool_backward_kernel_bit_exact(gen, shape):
    x = (torch.randn(*shape, generator=gen, device='cuda') * 4).round() / 4
    x[:, -1] = 1.5                       # constant frames: every pair ties
    x[:, :, 1::4] = x[:, :, 0::4]        # more ties
    x[0, 0, 0, :3] = float('nan')        # NaN in the first row
    x[0, 1, 1, :3] = float('nan')        # NaN in the second row
    x = x.to(torch.bfloat16)
    gy = torch.randn(shape[0], shape[1], shape[2] // 2, shape[3],
                     generator=gen, device='cuda').to(torch.bfloat16)
    got = maxpool_freq2_bwd(x, gy)
    ref = maxpool_freq2_bwd_plain(x, gy)
    assert torch.equal(got, ref)


@pytest.mark.parametrize('d,b,t,h', GRU_SHAPES)
def test_gru_backward_kernel_matches_plain(gen, d, b, t, h):
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda').to(
        torch.bfloat16)
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device='cuda') * h ** -.5
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h0 = .5 * torch.randn(d, b, h, generator=gen, device='cuda')
    y = gru_scan(xw, w_hh, b_hh, h0)
    g = torch.randn(d, b, t, h, generator=gen, device='cuda')
    n = build.LAUNCHES['gru_scan_bwd']
    got = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    assert build.LAUNCHES['gru_scan_bwd'] == n + 1
    ref = gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g)
    # same bf16 rounding points; f32 summation order may flip a bf16
    # rounding of dgates before the next step: the GRU ceiling, 5.3e-3
    for a, r in zip(got, ref):
        assert _max_err(a, r) <= 5.3e-3 * float(r.float().abs().max())
    # the cluster design sums its partials of dh in rank order: reruns
    # agree in every bit
    again = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize('d,b,t,h', [(2, 33, 17, 64), (2, 32, 40, 256),
                                     (2, 5, 12, 512)])
def test_gru_scan_gradients_match_autograd_over_plain(gen, d, b, t, h):
    """``GruScan`` (both kernels) against autograd through the plain
    forward, which differentiates the same f32 math but rounds other
    things to bf16 than the backward kernel does (the gradient at each
    cast, not h_prev, dgates, dxw and r): 2e-2 of each gradient's largest
    entry."""
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda').to(
        torch.bfloat16).float()
    w_hh = (torch.randn(d, h, 3 * h, generator=gen, device='cuda')
            * h ** -.5).to(torch.bfloat16).float()
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h0 = .5 * torch.randn(d, b, h, generator=gen, device='cuda')
    g = torch.randn(d, b, t, h, generator=gen, device='cuda')
    grads = []
    for fn in (GruScan.apply, gru_scan_plain):
        leaves = [v.clone().requires_grad_() for v in (xw, w_hh, b_hh, h0)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, g))
    for a, r in zip(*grads):
        assert _max_err(a, r) <= 2e-2 * float(r.abs().max())


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf', [
    (1, 7, 5, 16, 16, 3, 3),     # Cin 16, ragged pixel tile, odd F
    (2, 9, 8, 16, 32, 3, 3),     # F = 8
    (1, 5, 4, 256, 256, 3, 3),   # Cin 256 (deep L14), T off the tile
    (2, 11, 8, 24, 48, 5, 3),    # Cin not a multiple of 16, kt = 5
    (1, 6, 8, 5, 16, 3, 3),      # Cin off the 8-wide vector path
])
def test_bnrelu_conv2d_kernels_match_plain(gen, b, t, f, cin, cout, kt, kf):
    """The fused conv forward and backward with a positive shift on every
    channel, so a halo lit with relu(shift) would show at the borders."""
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    scale = .5 + torch.rand(cin, generator=gen, device='cuda')
    shift = .5 + torch.rand(cin, generator=gen, device='cuda')
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda').to(
        torch.bfloat16)
    n = dict(build.LAUNCHES)
    y = bnrelu_conv2d_same(x, scale, shift, w, bias)
    da, dw = bnrelu_conv2d_same_bwd(x, scale, shift, w, gy)
    assert build.LAUNCHES['bnrelu_conv2d_same'] == n['bnrelu_conv2d_same'] + 1
    assert (build.LAUNCHES['bnrelu_conv2d_same_bwd']
            == n['bnrelu_conv2d_same_bwd'] + 1)
    ref = bnrelu_conv2d_same_plain(x, scale, shift, w, bias)
    ref_da, ref_dw = bnrelu_conv2d_same_bwd_plain(x, scale, shift, w, gy)
    # y and da: one f32 sum of the same bf16 products rounded once (one
    # ulp); dw: f32 sums in another order
    assert _max_err(y, ref) <= 2. ** -7 * float(ref.float().abs().max())
    assert _max_err(da, ref_da) <= 2. ** -7 * float(
        ref_da.float().abs().max())
    assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
    assert torch.equal(dw, bnrelu_conv2d_same_bwd(x, scale, shift, w, gy)[1])


@pytest.mark.parametrize('d,b,t,h', [(1, 5, 9, 32), (2, 3, 17, 64),
                                     (2, 3, 40, 512), (2, 33, 21, 256),
                                     (2, 32, 500, 256), (2, 32, 500, 512),
                                     (2, 16, 45, 512), (2, 40, 37, 256),
                                     (2, 300, 20, 256)])
def test_gru_fused_backward_kernel_matches_plain(gen, d, b, t, h):
    """B = 3 (rows past the batch in the tile), T past one and across
    several 16-step accumulation groups with a partial one (T = 45, 37,
    500), two and three batch tiles (B = 33, 40), the training shapes;
    H = 32 and 64 and (2, 300, 20, 256) keep the row-tiled sweep, the
    rest the cluster one."""
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda').to(
        torch.bfloat16)
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device='cuda') * h ** -.5
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h0 = .5 * torch.randn(d, b, h, generator=gen, device='cuda')
    y = gru_scan(xw, w_hh, b_hh, h0)
    # at T = 500 the training step's cotangent scale (as chip_smoke.py):
    # summed over 500 steps a unit one grows dxw to where one bf16 ulp of
    # it is more than the bound of its max
    g = torch.randn(d, b, t, h, generator=gen, device='cuda') * (
        1e-2 if t == 500 else 1.)
    cluster = h in (256, 512) and (d, b, t, h) != (2, 300, 20, 256)
    designs = gru_designs(d, b, t, h)
    assert designs['bwd_fused']['design'] == ('cluster' if cluster
                                              else 'row_tiled')
    assert designs['bwd_fused']['rows'] == designs['bwd']['rows']
    n = build.LAUNCHES['gru_scan_bwd_fused']
    got = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g, split=False)
    assert build.LAUNCHES['gru_scan_bwd_fused'] == n + 1
    ref = gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g, split=False)
    for a, r in zip(got, ref):
        assert _max_err(a, r) <= 5.3e-3 * float(r.float().abs().max())
    # against the split kernel: the same sweep in either design (the fused
    # one adds its accumulation off the chain), so dxw and dh0 agree in
    # every bit. dw_hh/db_hh are reduced in a fixed order: bit-identical
    # reruns
    split = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    assert torch.equal(got[0], split[0]) and torch.equal(got[3], split[3])
    again = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g, split=False)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize('b,t,f,cin,cout', [
    (1, 1, 8, 16, 16),       # B = T = 1: 8 of a tile's 128 pixels
    (1, 3, 16, 32, 512),     # Cout 512: four 128-wide N tiles; dx N = 32
    (2, 5, 128, 16, 32),     # F = 128: one frequency row per tile
    (1, 7, 16, 256, 16),     # Cin 256: four K slices; dx N = 256
    (3, 17, 8, 32, 16),      # T = 17 off the 16-row tile, B * T * F = 408
    (1, 2, 128, 1, 16),      # Cin = 1: the entry kernels, dx wgmma
])
def test_wgmma_conv_kernels_match_plain(gen, b, t, f, cin, cout):
    """The wgmma conv kernels (csrc/conv2d_wgmma.cuh), forward and
    backward, plain and BN+ReLU-fused with a positive shift on every
    channel (a halo lit with relu(shift) would show at every border), at
    ragged pixel tiles, F of 8, 16 and 128 and channel counts from 1 to
    512; dw bit-identical in two runs. Cin = 1 runs the entry kernels
    (csrc/conv2d_entry.cuh) forward and dw, and the wgmma one for its dx
    (N = 1)."""
    want = ({'fwd': 'wgmma', 'dx': 'wgmma', 'dw': 'wgmma'} if cin >= 16
            else {'fwd': 'entry', 'dx': 'wgmma', 'dw': 'entry'})
    designs = conv_designs(f, cin, cout)
    assert {name: d['design'] for name, d in designs.items()} == want
    # the wgmma kernels' activation rings hold at least 3 stages here, or
    # 2 where that leaves room for two blocks an SM (half of 227 KB: the
    # narrow tiles); the entry kernels' 2 (forward) and 3 (dw)
    least = {'wgmma': 3, 'entry': 2}
    assert all(d['stages'] >= least[d['design']]
               or (d['design'] == 'wgmma' and d['stages'] == 2
                   and d['smem'] <= 232448 // 2) for d in designs.values())
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(3, 3, cin, cout, generator=gen, device='cuda') * (
        9 * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda').to(
        torch.bfloat16)
    scale = .5 + torch.rand(cin, generator=gen, device='cuda')
    shift = .5 + torch.rand(cin, generator=gen, device='cuda')
    affine = (scale, shift)
    for fwd, fwd_plain, bwd, bwd_plain, pre in (
            (conv2d_same, conv2d_same_plain, conv2d_same_bwd,
             conv2d_same_bwd_plain, ()),
            (bnrelu_conv2d_same, bnrelu_conv2d_same_plain,
             bnrelu_conv2d_same_bwd, bnrelu_conv2d_same_bwd_plain, affine)):
        y = fwd(x, *pre, w, bias)
        ref = fwd_plain(x, *pre, w, bias)
        # one f32 sum of the same bf16 products rounded once (one ulp)
        assert _max_err(y, ref) <= 2. ** -7 * float(ref.float().abs().max())
        dx, dw = bwd(x, *pre, w, gy)
        ref_dx, ref_dw = bwd_plain(x, *pre, w, gy)
        assert _max_err(dx, ref_dx) <= 2. ** -7 * float(
            ref_dx.float().abs().max())
        # dw: f32 sums in another order, reduced in a fixed order
        assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
        assert torch.equal(dw, bwd(x, *pre, w, gy)[1])


# (B, T, F, Cin, Cout, kt, kf, M): the wgmma pair off its old tile of 128
# / F whole rows at a power of two F: F 40, 20, 10 and 5 (the 40-mel
# tower's, tiles of 120 and 125 pixels), 37, 96, and 200 and 256 (tiles of
# 128 pixels of one frame); Cin 16, 20 and 24 (20 padded to 24); the dx at
# N = 1, 3, 11 and 15 (Cin < 16: the entry kernels run forward and dw);
# 3x3, 5x3, 1x1 and an even (padded) kernel; a 9x9 kernel whose dw halo
# takes a narrower tile at F = 128; T off the tile; M > 1 adds member-axis
# launches
OFF_TILE_SHAPES = [
    (2, 7, 40, 16, 32, 3, 3, 2),
    (2, 9, 20, 20, 24, 3, 3, 1),
    (1, 13, 10, 24, 64, 5, 3, 2),
    (2, 11, 5, 24, 16, 3, 3, 1),
    (1, 9, 37, 16, 16, 1, 1, 1),
    (1, 5, 96, 20, 16, 2, 2, 1),
    (1, 3, 200, 16, 32, 3, 3, 2),
    (1, 2, 256, 24, 16, 5, 3, 1),
    (2, 7, 40, 1, 16, 3, 3, 1),
    (1, 6, 37, 3, 32, 5, 3, 1),
    (2, 5, 128, 11, 16, 3, 3, 1),
    (1, 3, 200, 15, 16, 3, 3, 1),
    (1, 6, 128, 16, 16, 9, 9, 1),
]


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf,m', OFF_TILE_SHAPES)
def test_off_tile_conv_shapes_match_plain(gen, b, t, f, cin, cout, kt, kf,
                                          m):
    """Every pass at these shapes runs the entry or the wgmma kernels (no
    other conv kernel exists): forward, dx and dw, plain and BN+ReLU-fused
    with a positive shift on every channel (a lit halo would show at
    every border), against the plain versions within the conv gates
    (2^-7 * max|ref| for y and dx, 1e-3 * max|ref| for dw); dw
    bit-identical on a rerun; with M > 1 one member-axis launch equals M
    single launches in every bit."""
    kt_k, kf_k = kt + 1 - kt % 2, kf + 1 - kf % 2
    cin_k = cin + -cin % 8 if cin >= 16 else cin
    designs = conv_designs(f, cin_k, cout + -cout % 16, kt_k, kf_k)
    want = 'entry' if cin < 16 else 'wgmma'
    assert {name: d['design'] for name, d in designs.items()} == {
        'fwd': want, 'dx': 'wgmma', 'dw': want}
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda').to(
        torch.bfloat16)
    scale = .5 + torch.rand(cin, generator=gen, device='cuda')
    shift = .5 + torch.rand(cin, generator=gen, device='cuda')
    for fwd, fwd_plain, bwd, bwd_plain, pre in (
            (conv2d_same, conv2d_same_plain, conv2d_same_bwd,
             conv2d_same_bwd_plain, ()),
            (bnrelu_conv2d_same, bnrelu_conv2d_same_plain,
             bnrelu_conv2d_same_bwd, bnrelu_conv2d_same_bwd_plain,
             (scale, shift))):
        y = fwd(x, *pre, w, bias)
        ref = fwd_plain(x, *pre, w, bias)
        assert y.shape == ref.shape
        assert _max_err(y, ref) <= 2. ** -7 * float(ref.float().abs().max())
        dx, dw = bwd(x, *pre, w, gy)
        ref_dx, ref_dw = bwd_plain(x, *pre, w, gy)
        assert dx.shape == x.shape and dw.shape == w.shape
        assert _max_err(dx, ref_dx) <= 2. ** -7 * float(
            ref_dx.float().abs().max())
        assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
        assert torch.equal(dw, bwd(x, *pre, w, gy)[1])
    if m == 1:
        return
    xm = torch.randn(m, b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    wm = torch.randn(m, kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bm = .1 * torch.randn(m, cout, generator=gen, device='cuda')
    sm = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    hm = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    n = build.LAUNCHES['conv2d_same']
    y = conv2d_same_members(xm, wm, bm)
    assert build.LAUNCHES['conv2d_same'] == n + 1
    assert torch.equal(y, torch.stack([
        conv2d_same(xm[i].clone(), wm[i], bm[i].clone()) for i in range(m)]))
    y = bnrelu_conv2d_same_members(xm, sm, hm, wm, bm)
    assert torch.equal(y, torch.stack([
        bnrelu_conv2d_same(xm[i].clone(), sm[i].clone(), hm[i].clone(),
                           wm[i], bm[i].clone()) for i in range(m)]))


# (T, F, Cin, kt, kf, M): kernels whose halo fits no tile as a whole. 31 x
# 31: the dw's x halo (64 channels) passes 227 KB at every tile, the
# forward (16-channel K slices) still fits; 61 x 61: no pass fits, at
# Cin = 16 and at Cin = 11 (the entry kernels' forward and dw)
HUGE_KERNELS = [(12, 16, 16, 31, 31, 2), (40, 16, 16, 61, 61, 1),
                (24, 20, 11, 61, 61, 1)]


@pytest.mark.parametrize('t,f,cin,kt,kf,m', HUGE_KERNELS)
def test_conv_runs_a_kernel_no_tile_fits_in_tap_blocks(gen, t, f, cin, kt,
                                                       kf, m):
    """Such a kernel runs as the sum of tap blocks that fit
    (``conv.py:_tap_blocks``), each on the entry or wgmma kernels: forward,
    dx and dw, plain and BN+ReLU-fused, against the plain versions within
    the conv gates (2^-7 * max|ref| for y and dx, 1e-3 * max|ref| for
    dw); dw bit-identical on a rerun; one launch a block; with M > 1 the
    member axis equals M single calls in every bit."""
    cin_k = cin + -cin % 8 if cin >= 16 else cin
    designs = conv_designs(f, cin_k, 16, kt, kf)
    assert all(d['design'] in ('entry', 'wgmma') for d in designs.values())
    taps = designs['dw']['taps']
    assert taps != (kt, kf) and designs['dx']['taps'] == taps
    blocks = -(-kt // taps[0]) * -(-kf // taps[1])
    x = torch.randn(2, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, 16, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(16, generator=gen, device='cuda')
    gy = torch.randn(2, t, f, 16, generator=gen, device='cuda').to(
        torch.bfloat16)
    scale = .5 + torch.rand(cin, generator=gen, device='cuda')
    shift = .5 + torch.rand(cin, generator=gen, device='cuda')
    for fwd, fwd_plain, bwd, bwd_plain, pre in (
            (conv2d_same, conv2d_same_plain, conv2d_same_bwd,
             conv2d_same_bwd_plain, ()),
            (bnrelu_conv2d_same, bnrelu_conv2d_same_plain,
             bnrelu_conv2d_same_bwd, bnrelu_conv2d_same_bwd_plain,
             (scale, shift))):
        y = fwd(x, *pre, w, bias)
        ref = fwd_plain(x, *pre, w, bias)
        assert y.shape == ref.shape
        assert _max_err(y, ref) <= 2. ** -7 * float(ref.float().abs().max())
        n = build.LAUNCHES['conv2d_same_bwd']
        dx, dw = bwd(x, *pre, w, gy)
        assert build.LAUNCHES['conv2d_same_bwd'] == n + blocks
        ref_dx, ref_dw = bwd_plain(x, *pre, w, gy)
        assert dx.shape == x.shape and dw.shape == w.shape
        assert _max_err(dx, ref_dx) <= 2. ** -7 * float(
            ref_dx.float().abs().max())
        assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
        assert torch.equal(dw, bwd(x, *pre, w, gy)[1])
    if m == 1:
        return
    xm = torch.randn(m, 2, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    wm = torch.randn(m, kt, kf, cin, 16, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bm = .1 * torch.randn(m, 16, generator=gen, device='cuda')
    sm = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    hm = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    assert torch.equal(conv2d_same_members(xm, wm, bm), torch.stack([
        conv2d_same(xm[i].clone(), wm[i], bm[i].clone()) for i in range(m)]))
    assert torch.equal(
        bnrelu_conv2d_same_members(xm, sm, hm, wm, bm), torch.stack([
            bnrelu_conv2d_same(xm[i].clone(), sm[i].clone(), hm[i].clone(),
                               wm[i], bm[i].clone()) for i in range(m)]))


def test_new_kernels_raise_on_what_they_do_not_take(gen):
    x = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16, device='cuda')
    w = torch.zeros(3, 3, 16, 16, device='cuda')
    s = torch.ones(16, device='cuda')
    with pytest.raises(TypeError):          # f32 input
        bnrelu_conv2d_same(x.float(), s, s, w, None)
    with pytest.raises(ValueError):         # scale of the wrong length
        bnrelu_conv2d_same(x, s[:8], s, w, None)
    with pytest.raises(ValueError):         # shift on another device
        bnrelu_conv2d_same(x, s, s.cpu(), w, None)
    with pytest.raises(ValueError):         # cotangent of the wrong shape
        bnrelu_conv2d_same_bwd(x, s, s, w, x[..., :8])
    h = GRU_FUSED_MAX_HIDDEN + 1
    y = torch.zeros(1, 2, 3, h, device='cuda')
    with pytest.raises(ValueError, match=str(GRU_FUSED_MAX_HIDDEN)):
        gru_scan_bwd(torch.zeros(1, 2, 3, 3 * h, device='cuda'),  # fused
                     torch.zeros(1, h, 3 * h, device='cuda'),     # > 512
                     torch.zeros(1, 3 * h, device='cuda'),
                     torch.zeros(1, 2, h, device='cuda'), y, y, split=False)


@pytest.mark.parametrize('m,b,t,f,cin,cout,k', [
    (3, 2, 9, 16, 16, 32, 3),    # wgmma, ragged time tile
    (2, 1, 5, 128, 32, 16, 3),   # wgmma, one frequency row a tile
    (4, 2, 7, 8, 64, 256, 3),    # wgmma, two N tiles: the bias restaged
    (3, 2, 6, 16, 1, 16, 3),     # the entry kernel: Cin = 1 entry layer
    (2, 1, 5, 8, 11, 48, 3),     # entry: Cin = 11 (tag-conditioned)
    (3, 1, 4, 8, 16, 16, 1),     # 1x1
])
def test_member_axis_convs_bit_equal_to_single_launches(gen, m, b, t, f,
                                                        cin, cout, k):
    """One launch of the member-axis conv (plain and BN+ReLU-fused, a
    positive shift on every channel) equals M launches of one member in
    every bit, and its plain version within the conv kernels' one ulp."""
    x = torch.randn(m, b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(m, k, k, cin, cout, generator=gen, device='cuda') * (
        k * k * cin) ** -.5
    bias = .1 * torch.randn(m, cout, generator=gen, device='cuda')
    scale = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    shift = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    for name, fn, single, plain, pre in (
            ('conv2d_same', conv2d_same_members, conv2d_same,
             conv2d_same_members_plain, ()),
            ('bnrelu_conv2d_same', bnrelu_conv2d_same_members,
             bnrelu_conv2d_same, bnrelu_conv2d_same_members_plain,
             (scale, shift))):
        if pre and cin % 8:
            continue                  # the fused conv's scale loads
        n = build.LAUNCHES[name]
        y = fn(x, *pre, w, bias)
        assert build.LAUNCHES[name] == n + 1
        ref = torch.stack([single(x[i], *(a[i] for a in pre), w[i],
                                  bias[i]) for i in range(m)])
        assert torch.equal(y, ref), name
        ref = plain(x, *pre, w, bias)
        assert _max_err(y, ref) <= 2. ** -7 * float(ref.float().abs().max())


@pytest.mark.parametrize('n,b,t,h', [(3, 5, 9, 64), (10, 32, 12, 256)])
def test_gru_members_in_the_direction_axis(gen, n, b, t, h):
    """``GruScan`` under ``torch.func.vmap``: N members' D = 2 recurrences
    in one D = 2N launch, each member within the GRU tolerance of its own
    plain D = 2 recurrence (at (20, 32, 12, 256) past the cluster
    design's 32 row tiles)."""
    xw = torch.randn(n, 2, b, t, 3 * h, generator=gen, device='cuda')
    w_hh = torch.randn(n, 2, h, 3 * h, generator=gen, device='cuda') * (
        h ** -.5)
    b_hh = .1 * torch.randn(n, 2, 3 * h, generator=gen, device='cuda')
    h0 = torch.zeros(2, b, h, device='cuda')
    count = build.LAUNCHES['gru_scan']
    y = torch.func.vmap(GruScan.apply, in_dims=(0, 0, 0, None))(
        xw, w_hh, b_hh, h0)
    assert build.LAUNCHES['gru_scan'] == count + 1
    for i in range(n):
        ref = gru_scan_plain(xw[i], w_hh[i], b_hh[i], h0)
        assert _max_err(y[i], ref) <= 5.3e-3


def test_gru_forward_design_at_stacked_shapes(gen):
    """A stacked ensemble's GRU forward at D = 2N keeps the cluster design
    up to 192 row tiles of 16 (10 members' tagging: 40), where clusters
    running in waves beat the row-tiled kernel, and takes the row-tiled
    one beyond (its sliding-window shapes); the backwards keep their
    limit of 32."""
    for d, b, t in ((20, 32, 500), (40, 32, 500), (20, 64, 500),
                    (12, 256, 500), (2, 1536, 51)):
        designs = gru_designs(d, b, t, 256)
        assert designs['fwd']['design'] == 'cluster'
        assert designs['fwd']['rows'] == 32
        assert designs['bwd']['design'] == 'row_tiled'
    for d, b, t in ((20, 176, 500), (2, 1792, 51), (20, 2000, 51),
                    (4, 4000, 11)):
        assert gru_designs(d, b, t, 256)['fwd']['design'] == 'row_tiled'


# (B, T, F, C), (pt, pf): odd T and F (rows and columns past the last
# window), C on the 16-byte vector path (16; 12 in f32) and off it (12 in
# bf16, 5), the 1-D tower's F = 1 time pool
POOL_WINDOWS = [((2, 13, 11, 16), (2, 2)), ((2, 13, 11, 12), (1, 2)),
                ((1, 9, 7, 5), (3, 1)), ((2, 25, 5, 24), (2, 3)),
                ((2, 17, 18, 16), (4, 4)), ((3, 25, 1, 32), (2, 1))]


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape,window', POOL_WINDOWS)
def test_maxpool2d_kernels_bit_exact(gen, shape, window, dtype):
    x = (torch.randn(*shape, generator=gen, device='cuda') * 2).round() / 2
    x[:, -1] = 1.5                       # constant frames: whole windows tie
    x[0, 0, 0, :3] = float('nan')        # NaN first in a window
    x[-1, 1, -1, :2] = float('nan')      # and past the last window
    x = x.to(dtype)
    pt, pf = window
    n = dict(build.LAUNCHES)
    got = maxpool2d(x, pt, pf)
    ref = maxpool2d_plain(x, pt, pf)
    assert torch.equal(got.isnan(), ref.isnan())
    assert torch.equal(got.nan_to_num(), ref.nan_to_num())
    gy = torch.randn(*got.shape, generator=gen, device='cuda').to(dtype)
    dx = maxpool2d_bwd(x, gy, pt, pf)
    assert torch.equal(dx, maxpool2d_bwd_plain(x, gy, pt, pf))
    assert build.LAUNCHES['maxpool2d'] == n['maxpool2d'] + 1
    assert build.LAUNCHES['maxpool2d_bwd'] == n['maxpool2d_bwd'] + 1


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('shape,window,cout', [
    ((2, 25, 5, 24), (2, 2), 64),        # a time pool and an odd F
    ((2, 13, 20, 16), (1, 5), 32),       # F = 20 -> 2 rows, (1, 5)
    ((3, 25, 1, 16), (4, 1), 32),        # the 1-D tower's time residual
    ((1, 7, 9, 5), (3, 3), 7),           # the scalar path
])
def test_avgpool2d_kernels_bit_exact(gen, shape, window, cout, dtype):
    x = torch.randn(*shape, generator=gen, device='cuda').to(dtype)
    st, sf = window
    n = dict(build.LAUNCHES)
    got = avgpool2d(x, st, sf, cout)
    assert torch.equal(got, avgpool2d_plain(x, st, sf, cout))
    gy = torch.randn(*got.shape, generator=gen, device='cuda')
    dx = avgpool2d_bwd(gy, st, sf, x.shape, dtype)
    assert torch.equal(dx, avgpool2d_bwd_plain(gy, st, sf, x.shape, dtype))
    assert build.LAUNCHES['avgpool2d'] == n['avgpool2d'] + 1
    assert build.LAUNCHES['avgpool2d_bwd'] == n['avgpool2d_bwd'] + 1


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf', [
    (2, 9, 7, 16, 10, 2, 2),     # Cout 10, a 2 x 2 kernel
    (2, 11, 8, 16, 24, 4, 3),    # Cout 24, 4 x 3
    (1, 7, 6, 24, 40, 2, 1),     # Cin 24, Cout 40, 2 x 1
    (2, 9, 16, 1, 24, 3, 3),     # the entry layer at Cout 24
    (2, 20, 16, 64, 64, 4, 4),   # the wgmma kernels' widths, 4 x 4
])
def test_padded_conv_shapes_match_plain(gen, b, t, f, cin, cout, kt, kf):
    """The conv kernels at shapes they take only padded (Cout to a
    multiple of 16 with zero columns, an even extent with a zero tap
    first): forward, dx, dw and the BN+ReLU-fused pair against their plain
    versions (XLA's SAME pads), one launch each."""
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda').to(
        torch.bfloat16)
    scale = .5 + torch.rand(cin, generator=gen, device='cuda')
    shift = .5 * torch.randn(cin, generator=gen, device='cuda')
    n = dict(build.LAUNCHES)
    got = conv2d_same(x, w, bias)
    ref = conv2d_same_plain(x, w, bias)
    assert got.shape == (b, t, f, cout)
    # one f32 sum rounded once to bf16 on both sides (one ulp)
    assert _max_err(got, ref) <= 2. ** -7 * float(ref.float().abs().max())
    dx, dw = conv2d_same_bwd(x, w, gy)
    ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert _max_err(dx, ref_dx) <= 2. ** -7 * float(ref_dx.float().abs().max())
    assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
    got = bnrelu_conv2d_same(x, scale, shift, w, bias)
    ref = bnrelu_conv2d_same_plain(x, scale, shift, w, bias)
    assert _max_err(got, ref) <= 2. ** -7 * float(ref.float().abs().max())
    da, dw = bnrelu_conv2d_same_bwd(x, scale, shift, w, gy)
    ref_da, ref_dw = bnrelu_conv2d_same_bwd_plain(x, scale, shift, w, gy)
    assert _max_err(da, ref_da) <= 2. ** -7 * float(ref_da.float().abs().max())
    assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
    for name in ('conv2d_same', 'conv2d_same_bwd', 'bnrelu_conv2d_same',
                 'bnrelu_conv2d_same_bwd', 'conv2d_same_padded',
                 'conv2d_same_bwd_padded'):
        assert build.LAUNCHES[name] == n[name] + 1, name
    # the member axis at the padded shape: each member's own launch, bits
    xm = torch.stack([x, x.flip(1)])
    wm = torch.stack([w, -w])
    bm = torch.stack([bias, bias])
    assert torch.equal(conv2d_same_members(xm, wm, bm), torch.stack(
        [conv2d_same(xm[i], wm[i], bm[i]) for i in range(2)]))


def _gru_case(gen, d, b, t, h, g_scale=1.):
    xw = torch.randn(d, b, t, 3 * h, generator=gen, device='cuda').to(
        torch.bfloat16)
    w_hh = torch.randn(d, h, 3 * h, generator=gen, device='cuda') * h ** -.5
    b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device='cuda')
    h0 = .5 * torch.randn(d, b, h, generator=gen, device='cuda')
    g = g_scale * torch.randn(d, b, t, h, generator=gen, device='cuda')
    return xw, w_hh, b_hh, h0, g


# (D, B, T, H): the cluster design of 16 blocks above 512 at 768, 1024
# and 2048 (its limit), with a ragged row tile (B = 17, 3) and T = 1, and
# at 768 with 3 000 rows (the forward's clusters of 32 rows); H off a
# multiple of 32 below 512 (padded into the row-tiled kernel, or to 256
# for the cluster design at few rows: 400 row tiles keep 200 at 224,
# row-tiled) and above (600 -> 768)
@pytest.mark.parametrize('d,b,t,h', [
    (2, 17, 9, 768), (2, 3, 1, 768), (1, 5, 6, 1024), (2, 3, 4, 2048),
    (2, 3000, 3, 768), (2, 5, 9, 48), (2, 17, 11, 200), (2, 32, 12, 200),
    (2, 3000, 3, 200), (2, 3, 5, 600)])
def test_gru_any_width_matches_plain(gen, d, b, t, h):
    """Forward and the split backward against the plain version at the
    real H (the GRU ceiling: 5.3e-3, and 5.3e-3 of each gradient's
    largest entry), with the design the H each pass runs takes (200 runs
    as 256 on the cluster design at few rows, as 224 row-tiled at 16 000;
    above 512 clusters of 16 blocks of H / 16 units, the forward's of 32
    rows where 16-row clusters would wait their turn), the launches
    counted under the pair's names and the wide and padded ones, and
    bit-identical reruns."""
    xw, w_hh, b_hh, h0, g = _gru_case(gen, d, b, t, h)
    designs = gru_designs(d, b, t, h)
    for key in ('fwd', 'bwd'):
        v = designs[key]
        hp = v['hidden']
        if hp > 512:
            # the next multiple of 256, on 16 blocks of hp / 16 units
            assert hp == -(-h // 256) * 256
            assert (v['design'], v['cluster'], v['units']) == (
                'cluster', 16, hp // 16)
            assert v['resident'] + v['streamed'] == 2 * hp * 3 * hp // 16
            assert v['rows'] == (32 if key == 'fwd' and b == 3000 else 16)
        elif hp != -(-h // 32) * 32:
            # the width the cluster design takes
            assert hp in (256, 512) and v['design'] == 'cluster'
    if h > 512:
        assert designs['bwd_fused'] is None
    n = dict(build.LAUNCHES)
    y = gru_scan(xw, w_hh, b_hh, h0)
    got = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    for name, key in (('gru_scan', 'fwd'), ('gru_scan_bwd', 'bwd')):
        hp = designs[key]['hidden']
        assert build.LAUNCHES[name] == n[name] + 1
        assert build.LAUNCHES[f'{name}_wide'] == n[f'{name}_wide'] + (
            hp > 512)
        assert build.LAUNCHES[f'{name}_padded'] == n[f'{name}_padded'] + (
            hp != h)
    assert y.shape == (d, b, t, h)
    assert _max_err(y, gru_scan_plain(xw, w_hh, b_hh, h0)) <= 5.3e-3
    ref = gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g)
    for a, r in zip(got, ref):
        assert a.shape == r.shape and a.dtype == r.dtype
        assert _max_err(a, r) <= 5.3e-3 * float(r.float().abs().max())
    assert torch.equal(y, gru_scan(xw, w_hh, b_hh, h0))
    again = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize('h', [48, 200])
def test_gru_fused_backward_at_a_padded_width(gen, h):
    """The fused backward (no path selects it) at an H it takes padded."""
    xw, w_hh, b_hh, h0, g = _gru_case(gen, 2, 5, 7, h)
    y = gru_scan(xw, w_hh, b_hh, h0)
    got = gru_scan_bwd(xw, w_hh, b_hh, h0, y, g, split=False)
    ref = gru_scan_bwd_plain(xw, w_hh, b_hh, h0, y, g, split=False)
    for a, r in zip(got, ref):
        assert a.shape == r.shape
        assert _max_err(a, r) <= 5.3e-3 * float(r.float().abs().max())


def test_wide_gru_members_in_the_direction_axis(gen):
    """Two members at H = 768 under ``torch.func.vmap``: one D = 4 launch
    of the cluster design above 512 equal to each member's D = 2 launch in
    every bit."""
    xw, w_hh, b_hh, h0, _ = _gru_case(gen, 4, 3, 6, 768)
    member = (lambda a: a.reshape(2, 2, *a.shape[1:]))
    got = torch.func.vmap(GruScan.apply)(*map(member, (xw, w_hh, b_hh, h0)))
    for i in range(2):
        s = slice(2 * i, 2 * i + 2)
        assert torch.equal(got[i], gru_scan(xw[s], w_hh[s], b_hh[s], h0[s]))


# (B, T, F, Cin, Cout, kt, kf): the entry layer, a narrow tile (Cout 16,
# BN 16), Cout off 16 with an even kernel (padded to 16 on the 3xTF32
# pair; its dx from 7 channels on the entry kernels), a 4 x 3 kernel at
# Cin 33 (padded to 36) on a ragged pixel tile, the late shallow layers'
# widths, and a 1x1; then shapes of the 3xTF32 design: two column tiles
# of 64 (and, with the member axis below, two members on it), and L8's
# Cout 256 at F = 8 on a ragged tile; then the recipes' three entry layers
# (1 -> 16, 1 -> 32, 11 -> 16) on the entry kernels at T off their tiles
# and F = 40 (not a power of two), the BiCRNN's also at F = 128, a 5 x 3
# kernel at F = 37 (odd; its dw pads its tile's pixels to 16), Cin = 8
# (the forward's pair loads, Cout 40 in 16-channel chunks), and a dx from
# 36 channels at F = 200 (its halo in windows of frequencies, copied float
# by float); then 14b's 3x3 layers off a power of two F (40, 20, 10, 5:
# tiles of 120 and 125 pixels, rows x W) and a 3x3 layer at Cout = 10
# (padded to 16 for the forward and dw, its dx from 10 channels on the
# entry kernels)
F32_CONV_SHAPES = [(2, 9, 16, 1, 16, 3, 3), (1, 7, 8, 16, 16, 3, 3),
                   (2, 9, 8, 24, 7, 2, 2), (1, 5, 6, 33, 40, 4, 3),
                   (2, 50, 16, 128, 256, 3, 3), (1, 7, 8, 64, 96, 1, 1),
                   (2, 12, 16, 64, 128, 3, 3), (1, 40, 8, 128, 256, 3, 3),
                   (2, 9, 40, 1, 16, 3, 3), (1, 13, 40, 1, 32, 3, 3),
                   (2, 7, 40, 11, 16, 3, 3), (1, 5, 128, 11, 16, 3, 3),
                   (1, 11, 37, 3, 24, 5, 3), (1, 9, 24, 8, 40, 3, 3),
                   (1, 5, 200, 3, 36, 3, 3),
                   (2, 9, 40, 24, 24, 3, 3), (2, 7, 20, 24, 64, 3, 3),
                   (1, 13, 20, 64, 64, 3, 3), (1, 11, 10, 64, 128, 3, 3),
                   (2, 7, 10, 128, 128, 3, 3), (1, 27, 5, 128, 256, 3, 3),
                   (2, 9, 5, 256, 256, 3, 3), (2, 9, 40, 24, 10, 3, 3)]


def _f32_design_wanted(f, cin, cout):
    """The design of each pass as the rule has it: the entry kernels at
    Cin < 16 (all three passes; the dx's output is then narrow) and for
    the dx of a layer with Cout < 16 (a GEMM from fewer than 16 channels;
    at these shapes its tile fits), 3xTF32 on wgmma everywhere else."""
    if cin < 16:
        return dict.fromkeys(('fwd', 'dx', 'dw'), 'entry')
    return {'fwd': '3xtf32', 'dx': 'entry' if cout < 16 else '3xtf32',
            'dw': '3xtf32'}


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf', F32_CONV_SHAPES)
def test_f32_conv_kernels_match_plain(gen, b, t, f, cin, cout, kt, kf):
    """The f32 conv's forward, dx and dw against the plain version
    (cuDNN in full f32, TF32 off): f32 sums in another order (or 3xTF32
    on the tensor cores), 2e-5 of the largest entry forward and dx, 1e-4
    for dw (sums over every pixel); dw's chunks added in a fixed order:
    bit-identical reruns, also without dx; each pass on the design the
    rule gives its shape, whole (no tap blocks); the member axis one
    launch equal to each member's in every bit."""
    designs = conv_f32_designs(f, cin, cout, kt, kf)
    for name, want in _f32_design_wanted(f, cin, cout).items():
        assert designs[name]['design'] == want, (name, designs[name])
        assert designs[name]['taps'] == (kt, kf), (name, designs[name])
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda')
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda')
    n = dict(build.LAUNCHES)
    got = conv2d_same_f32(x, w, bias)
    assert got.dtype == torch.float32 and got.shape == (b, t, f, cout)
    ref = conv2d_same_f32_plain(x, w, bias)
    assert _max_err(got, ref) <= 2e-5 * float(ref.abs().max())
    dx, dw = conv2d_same_f32_bwd(x, w, gy)
    ref_dx, ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert _max_err(dx, ref_dx) <= 2e-5 * float(ref_dx.abs().max())
    assert _max_err(dw, ref_dw) <= 1e-4 * float(ref_dw.abs().max())
    entry = int(designs['fwd']['design'] == 'entry')
    bwd_entry = int('entry' in (designs['dx']['design'],
                                designs['dw']['design']))
    for name, more in (('conv2d_same_f32', 1), ('conv2d_same_f32_bwd', 1),
                       ('conv2d_same_f32_entry', entry),
                       ('conv2d_same_f32_bwd_entry', bwd_entry)):
        assert build.LAUNCHES[name] == n[name] + more, name
    again = conv2d_same_f32_bwd(x, w, gy)
    assert torch.equal(dx, again[0]) and torch.equal(dw, again[1])
    no_dx, dw_alone = conv2d_same_f32_bwd(x, w, gy, need_dx=False)
    assert no_dx is None and torch.equal(dw, dw_alone)
    # the member axis: one launch equal to each member's in every bit
    xm, wm, bm = torch.stack([x, -x]), torch.stack([w, w.flip(0)]), \
        torch.stack([bias, -bias])
    assert torch.equal(conv2d_same_f32_members(xm, wm, bm), torch.stack(
        [conv2d_same_f32(xm[i], wm[i], bm[i]) for i in range(2)]))


# (T, F, Cin, Cout, kt, kf, M): f32 kernels whose halo fits no tile as a
# whole (f32 halos hold twice bf16's bytes): 31 x 31 at F = 64, 64 -> 64
# on the 3xTF32 pair, and at Cin = 11 on the entry kernels (61 x 61); two
# members on the first
F32_HUGE_KERNELS = [(12, 64, 64, 64, 31, 31, 2), (20, 24, 11, 16, 61, 61, 1)]


@pytest.mark.parametrize('t,f,cin,cout,kt,kf,m', F32_HUGE_KERNELS)
def test_f32_conv_runs_a_kernel_no_tile_fits_in_tap_blocks(gen, t, f, cin,
                                                           cout, kt, kf, m):
    """Such an f32 kernel runs as the f32 sum of tap blocks that fit
    (``conv.py:_f32_tap_blocks``), each on the entry or 3xTF32 kernels:
    forward, dx and dw against the plain versions at the f32 gates (2e-5
    of the largest entry for y and dx, 1e-4 for dw); dw bit-identical on
    a rerun; one launch a block; with M > 1 the member axis equals M
    single calls in every bit."""
    designs = conv_f32_designs(f, cin, cout, kt, kf)
    assert all(d['design'] in ('entry', '3xtf32') for d in designs.values())
    taps = designs['dw']['taps']
    assert taps != (kt, kf) and designs['dx']['taps'] == taps
    blocks = -(-kt // taps[0]) * -(-kf // taps[1])
    x = torch.randn(2, t, f, cin, generator=gen, device='cuda')
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    gy = torch.randn(2, t, f, cout, generator=gen, device='cuda')
    y = conv2d_same_f32(x, w, bias)
    ref = conv2d_same_f32_plain(x, w, bias)
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert _max_err(y, ref) <= 2e-5 * float(ref.abs().max())
    n = build.LAUNCHES['conv2d_same_f32_bwd']
    dx, dw = conv2d_same_f32_bwd(x, w, gy)
    assert build.LAUNCHES['conv2d_same_f32_bwd'] == n + blocks
    ref_dx, ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)
    assert dx.shape == x.shape and dw.shape == w.shape
    assert _max_err(dx, ref_dx) <= 2e-5 * float(ref_dx.abs().max())
    assert _max_err(dw, ref_dw) <= 1e-4 * float(ref_dw.abs().max())
    assert torch.equal(dw, conv2d_same_f32_bwd(x, w, gy)[1])
    if m == 1:
        return
    xm = torch.randn(m, 2, t, f, cin, generator=gen, device='cuda')
    wm = torch.randn(m, kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bm = .1 * torch.randn(m, cout, generator=gen, device='cuda')
    assert torch.equal(conv2d_same_f32_members(xm, wm, bm), torch.stack(
        [conv2d_same_f32(xm[i], wm[i], bm[i]) for i in range(m)]))


def test_f32_conv_dw_over_a_long_run(gen):
    """dw summed over 256 000 pixels (8 ten-second clips at L2's F = 64,
    16 -> 32 channels) on the 3xTF32 design: within 1e-4 of the largest
    entry of the plain version's, bit-identical on a rerun."""
    b, t, f, cin, cout = 8, 500, 64, 16, 32
    assert conv_f32_designs(f, cin, cout)['dw']['design'] == '3xtf32'
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda')
    w = torch.randn(3, 3, cin, cout, generator=gen, device='cuda') * (
        9 * cin) ** -.5
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda')
    _, dw = conv2d_same_f32_bwd(x, w, gy, need_dx=False)
    ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)[1]
    assert _max_err(dw, ref_dw) <= 1e-4 * float(ref_dw.abs().max())
    assert torch.equal(dw, conv2d_same_f32_bwd(x, w, gy, need_dx=False)[1])


def test_f32_entry_dw_over_a_long_run(gen):
    """The entry kernels' dw at Cin = 1 summed over 256 000 pixels (8
    ten-second clips at F = 64, 1 -> 32 channels): within 1e-4 of the
    largest entry of the plain version's, bit-identical on a rerun."""
    b, t, f, cin, cout = 8, 500, 64, 1, 32
    assert conv_f32_designs(f, cin, cout)['dw']['design'] == 'entry'
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda')
    w = torch.randn(3, 3, cin, cout, generator=gen, device='cuda') / 3.
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda')
    _, dw = conv2d_same_f32_bwd(x, w, gy, need_dx=False)
    ref_dw = conv2d_same_f32_bwd_plain(x, w, gy)[1]
    assert _max_err(dw, ref_dw) <= 1e-4 * float(ref_dw.abs().max())
    assert torch.equal(dw, conv2d_same_f32_bwd(x, w, gy, need_dx=False)[1])


def test_f32_conv_raises_on_a_bf16_input(gen):
    x = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16, device='cuda')
    with pytest.raises(TypeError, match='float32'):
        conv2d_same_f32(x, torch.zeros(3, 3, 16, 16, device='cuda'), None)


# (B, T, F, Cin, Cout, kt, kf, M): the entry conv pair (Cin < 16,
# csrc/conv2d_entry.cuh) at the recipes' entry widths with T off the tile,
# F 40 (the 40-mel tower's entry, Cout 24 padded to 32) and an odd F whose
# frame rows take 2-byte copies, 5x3 / 1x1 / even (padded) kernels, Cout
# 48 in three 16-channel chunks; M > 1 adds a member-axis launch
ENTRY_SHAPES = [
    (2, 9, 128, 1, 16, 3, 3, 1),    # shallow L0's widths
    (1, 7, 128, 1, 32, 3, 3, 3),    # deep L0's widths, 3 members
    (2, 5, 128, 11, 16, 3, 3, 2),   # the tag-conditioned L0, 2 members
    (2, 11, 40, 1, 24, 3, 3, 1),    # 40 mel bins, Cout 24
    (1, 13, 37, 3, 32, 5, 3, 2),    # odd F, 5x3, rows of 222 bytes
    (2, 6, 20, 5, 16, 1, 1, 1),     # 1x1
    (2, 6, 20, 15, 32, 3, 3, 1),    # Cin 15
    (1, 9, 16, 1, 16, 2, 2, 1),     # an even kernel, padded to 3x3
    (1, 3, 128, 11, 48, 3, 3, 1),   # Cout 48
]


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf,m', ENTRY_SHAPES)
def test_entry_conv_kernels_match_plain(gen, b, t, f, cin, cout, kt, kf, m):
    """The entry conv pair: forward (plain and BN+ReLU-fused with a
    positive shift on every channel) and dw against the plain versions
    within the conv gates (2^-7 * max|ref| for y, 1e-3 * max|ref| for
    dw); the design query says 'entry' for both passes; dw bit-identical
    on a rerun and with or without dx; with M > 1 one member-axis launch
    equals M single launches in every bit."""
    designs = conv_designs(f, cin, cout + -cout % 16, kt + 1 - kt % 2,
                           kf + 1 - kf % 2)
    assert designs['fwd']['design'] == designs['dw']['design'] == 'entry'
    x = torch.randn(b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    w = torch.randn(kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bias = .1 * torch.randn(cout, generator=gen, device='cuda')
    gy = torch.randn(b, t, f, cout, generator=gen, device='cuda').to(
        torch.bfloat16)
    scale = .5 + torch.rand(cin, generator=gen, device='cuda')
    shift = .5 + torch.rand(cin, generator=gen, device='cuda')
    for fwd, fwd_plain, pre in (
            (conv2d_same, conv2d_same_plain, ()),
            (bnrelu_conv2d_same, bnrelu_conv2d_same_plain, (scale, shift))):
        y = fwd(x, *pre, w, bias)
        ref = fwd_plain(x, *pre, w, bias)
        assert _max_err(y, ref) <= 2. ** -7 * float(ref.float().abs().max())
    n = build.LAUNCHES['conv2d_same_bwd']
    dx, dw = conv2d_same_bwd(x, w, gy)
    no_dx, dw_alone = conv2d_same_bwd(x, w, gy, need_dx=False)
    assert build.LAUNCHES['conv2d_same_bwd'] == n + 2 and no_dx is None
    ref_dx, ref_dw = conv2d_same_bwd_plain(x, w, gy)
    assert _max_err(dx, ref_dx) <= 2. ** -7 * float(
        ref_dx.float().abs().max())
    assert _max_err(dw, ref_dw) <= 1e-3 * float(ref_dw.abs().max())
    assert torch.equal(dw, dw_alone)
    assert torch.equal(dw, conv2d_same_bwd(x, w, gy)[1])
    _, dw_fused = bnrelu_conv2d_same_bwd(x, scale, shift, w, gy)
    _, ref_fused = bnrelu_conv2d_same_bwd_plain(x, scale, shift, w, gy)
    assert _max_err(dw_fused, ref_fused) <= 1e-3 * float(
        ref_fused.abs().max())
    assert torch.equal(dw_fused, bnrelu_conv2d_same_bwd(x, scale, shift, w,
                                                        gy)[1])
    if m == 1:
        return
    xm = torch.randn(m, b, t, f, cin, generator=gen, device='cuda').to(
        torch.bfloat16)
    wm = torch.randn(m, kt, kf, cin, cout, generator=gen, device='cuda') * (
        kt * kf * cin) ** -.5
    bm = .1 * torch.randn(m, cout, generator=gen, device='cuda')
    sm = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    hm = .5 + torch.rand(m, cin, generator=gen, device='cuda')
    n = build.LAUNCHES['conv2d_same']
    y = conv2d_same_members(xm, wm, bm)
    assert build.LAUNCHES['conv2d_same'] == n + 1
    # each member alone, from buffers of its own (16-byte aligned)
    assert torch.equal(y, torch.stack([
        conv2d_same(xm[i].clone(), wm[i], bm[i].clone()) for i in range(m)]))
    y = bnrelu_conv2d_same_members(xm, sm, hm, wm, bm)
    assert torch.equal(y, torch.stack([
        bnrelu_conv2d_same(xm[i].clone(), sm[i].clone(), hm[i].clone(),
                           wm[i], bm[i].clone()) for i in range(m)]))
