"""The port's 2-D conv tower kernels (plain versions on the CPU) against
the JAX package's Pallas kernels in interpret mode: ``conv2d_same`` vs
``conv2d_packed_fm`` (through ``fm_geom``/``pack_fm``/``unpack_fm``) and
``maxpool_freq2`` vs ``maxpool2_rows_packed``. On a CPU tensor no kernel
launches, so every launch counter stays at 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.ops.pallas import conv as pconv
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (
    AvgPoolFreq2, BnReluConv2dSame, Conv2dSame, MaxPoolFreq2,
    avgpool_freq2, bnrelu_conv2d_same, bnrelu_conv2d_same_members,
    bnrelu_conv2d_same_members_plain, conv2d_same, conv2d_same_bwd,
    conv2d_same_members, conv2d_same_members_plain, maxpool_freq2)

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


def _bf16(a):
    """numpy f32 values rounded to bf16 (the kernels' input type)."""
    return np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize('b,t,f,cin,cout,kt,kf', [
    (2, 20, 16, 16, 16, 3, 3),   # the tower's 16 -> 16 layer shape class
    (2, 20, 16, 1, 16, 3, 3),    # the Cin = 1 entry layer
    (1, 12, 8, 16, 16, 5, 3),    # asymmetric kernel: (time, freq) roles
])
def test_conv2d_same_matches_pallas(interpret_mode, b, t, f, cin, cout,
                                    kt, kf):
    rng = np.random.RandomState(1)
    x = _bf16(rng.randn(b, t, f, cin))
    w = (rng.randn(kt, kf, cin, cout) / np.sqrt(kt * kf * cin)).astype(
        np.float32)
    bias = (.1 * rng.randn(cout)).astype(np.float32)
    build.reset_launches()
    got = conv2d_same(torch.from_numpy(x).to(torch.bfloat16),
                      torch.from_numpy(w), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, f, cout)
    # the JAX tower pads the Cin = 1 entry layer to 16 zero channels
    cin_p = max(cin, 16)
    xp = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, cin_p - cin)))
    wp = np.pad(w, ((0, 0), (0, 0), (0, cin_p - cin), (0, 0)))
    g = pconv.fm_geom(t, f, kt, kf, max(cin_p, cout))
    y2 = pconv.conv2d_packed_fm(pconv.pack_fm(jnp.asarray(xp), g),
                                jnp.asarray(wp), jnp.asarray(bias), g, True)
    ref = np.asarray(pconv.unpack_fm(y2, g, jnp.float32))
    # both round the same f32 sum of bf16 products once to bf16; the
    # summation order differs, which can move that rounding by one bf16
    # ulp (2^-8 relative): bound 2^-7 * max|ref|
    atol = 2. ** -7 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, atol=atol, rtol=0)
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}


@pytest.mark.parametrize('c', [16, 24])
def test_maxpool_freq2_matches_pallas_bit_exact(interpret_mode, c):
    rng = np.random.RandomState(2)
    x = _bf16(rng.randn(2, 20, 16, c))
    build.reset_launches()
    got = maxpool_freq2(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (2, 20, 8, c)
    g = pconv.fm_geom(20, 16, 3, 3, c)
    y2 = pconv.maxpool2_rows_packed(
        pconv.pack_fm(jnp.asarray(x), g), 8, g.fs, True)
    g_out = g._replace(t=8, tp=8, ls=8 * g.fs, tc=1)
    ref = np.asarray(pconv.unpack_fm(y2, g_out, jnp.float32))
    # a compare and a copy: bit-exact
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.zeros(1, 4, 8, 16, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        conv2d_same(x.float(), torch.zeros(3, 3, 16, 16), None)
    with pytest.raises(ValueError):  # kernel of 8 input channels, x 16
        conv2d_same(x, torch.zeros(3, 3, 8, 16), None)
    with pytest.raises(ValueError):  # no output channel
        conv2d_same(x, torch.zeros(3, 3, 16, 0), None)
    with pytest.raises(ValueError):  # odd F cannot pool by 2
        maxpool_freq2(torch.zeros(1, 4, 7, 16, dtype=torch.bfloat16))
    with pytest.raises(RuntimeError):  # not CPU, not CUDA: no path
        conv2d_same(x.to('meta'), torch.zeros(3, 3, 16, 16, device='meta'),
                    None)


@pytest.mark.parametrize('cin,k', [(1, 3), (11, 3), (16, 3), (32, 3),
                                   (16, 1), (11, 1)])
def test_member_axis_convs_equal_per_member_calls(cin, k):
    """The member-axis conv and BN+ReLU-fused conv (the stacked ensemble's
    one launch for M members), their plain versions and the Functions'
    vmap rules under ``torch.func.vmap`` give each member exactly what its
    own call gives: the entry layer (Cin = 1), the tag-conditioned one
    (Cin = 11), the tower's widths, 3x3 and 1x1 kernels."""
    m, b, t, f, cout = 3, 2, 7, 8, 16
    rng = np.random.RandomState(cin + k)
    x = torch.from_numpy(rng.randn(m, b, t, f, cin).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(m, k, k, cin, cout)
                          / np.sqrt(k * k * cin)).astype(np.float32))
    bias = torch.from_numpy(.1 * rng.randn(m, cout).astype(np.float32))
    scale = torch.from_numpy((.5 + rng.rand(m, cin)).astype(np.float32))
    shift = torch.from_numpy((rng.rand(m, cin) - .3).astype(np.float32))
    build.reset_launches()
    ref = torch.stack([conv2d_same(x[i], w[i], bias[i]) for i in range(m)])
    for got in (conv2d_same_members(x, w, bias),
                conv2d_same_members_plain(x, w, bias),
                torch.func.vmap(Conv2dSame.apply)(x, w, bias)):
        assert got.shape == (m, b, t, f, cout)
        assert torch.equal(got, ref)
    assert torch.equal(conv2d_same_members(x, w, None),
                       torch.stack([conv2d_same(x[i], w[i], None)
                                    for i in range(m)]))
    ref = torch.stack([bnrelu_conv2d_same(x[i], scale[i], shift[i], w[i],
                                          bias[i]) for i in range(m)])
    for got in (bnrelu_conv2d_same_members(x, scale, shift, w, bias),
                bnrelu_conv2d_same_members_plain(x, scale, shift, w, bias),
                torch.func.vmap(BnReluConv2dSame.apply)(x, scale, shift,
                                                        w, bias)):
        assert torch.equal(got, ref)
    # a shared (unbatched) input against the members' weights
    shared = torch.func.vmap(Conv2dSame.apply, in_dims=(None, 0, 0))(
        x[0], w, bias)
    assert torch.equal(shared, torch.stack(
        [conv2d_same(x[0], w[i], bias[i]) for i in range(m)]))
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}


def test_pools_under_vmap_fold_the_members_into_the_clips():
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 2, 5, 8, 16).astype(
        np.float32)).to(torch.bfloat16)
    got = torch.func.vmap(MaxPoolFreq2.apply)(x)
    assert torch.equal(got, torch.stack([maxpool_freq2(v) for v in x]))
    got = torch.func.vmap(AvgPoolFreq2.apply, in_dims=(0, None))(x, 32)
    assert torch.equal(got, torch.stack([avgpool_freq2(v, 32) for v in x]))


def test_member_axis_wrappers_reject_mismatched_members():
    x = torch.zeros(2, 1, 4, 8, 16, dtype=torch.bfloat16)
    w = torch.zeros(2, 3, 3, 16, 16)
    with pytest.raises(ValueError):  # 3 members of weights for 2 of x
        conv2d_same_members(x, torch.zeros(3, 3, 3, 16, 16), None)
    with pytest.raises(ValueError):  # a bias of 1 member
        conv2d_same_members(x, w, torch.zeros(1, 16))
    with pytest.raises(ValueError):  # one member's x, not (M, B, T, F, C)
        conv2d_same_members(x[0], w, None)
    with pytest.raises(ValueError):  # scale of the wrong width
        bnrelu_conv2d_same_members(x, torch.ones(2, 8), torch.ones(2, 16),
                                   w, None)


@pytest.mark.parametrize('cin', [1, 11])
def test_conv_backward_without_dx_keeps_dw_bit_for_bit(cin):
    """``conv2d_same_bwd(..., need_dx=False)`` (what ``Conv2dSame`` passes
    where its input needs no gradient: the entry layer's log-mel input)
    runs no dx pass and returns the dw of the pass with dx in every bit,
    at the entry layer's widths: Cin = 1 and the tag-conditioned 11."""
    rng = np.random.RandomState(cin)
    x = torch.from_numpy(rng.randn(2, 9, 16, cin).astype(
        np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.randn(3, 3, cin, 16)
                          / np.sqrt(9 * cin)).astype(np.float32))
    gy = torch.from_numpy(rng.randn(2, 9, 16, 16).astype(
        np.float32)).to(torch.bfloat16)
    dx, dw = conv2d_same_bwd(x, w, gy)
    no_dx, dw_alone = conv2d_same_bwd(x, w, gy, need_dx=False)
    assert dx is not None and dx.shape == x.shape and no_dx is None
    assert torch.equal(dw_alone, dw)


@pytest.mark.parametrize('upstream', ['frozen', 'recipe'])
def test_fbcrnn_step_runs_dx_at_the_entry_layer_only_where_needed(
        monkeypatch, upstream):
    """A training step of a shallow FBCRNN on the CPU. Where nothing
    upstream of the entry conv (Cin = 1) learns (a post-activation tower,
    no learnable affine on the log-mel features), its backward computes
    no dx (no transposed conv of the cotangent down to one channel). The
    recipes' towers are pre-activation (a batch norm with a learnable
    scale and shift on the entry conv's input) over features with a
    learnable affine: both need that dx, and it runs. The other convs' dx
    runs in both. Every gradient equals the one of a step whose convs all
    compute dx, in every bit; the gradients themselves are held against
    the JAX package by ``tests/test_torch_train.py``."""
    from pb_sed_tpu_torch.models import weak_label as tweak
    from pb_sed_tpu_torch.ops.kernels import conv as kconv
    from tests.test_torch_fbcrnn import CONFIG, SAMPLES
    frozen = upstream == 'frozen'
    config = {**CONFIG, 'feature_extractor': {
        **CONFIG['feature_extractor'], 'learnable_affine': not frozen},
        'cnn': {**CONFIG['cnn'], 'cnn_2d': {
            **CONFIG['cnn']['cnn_2d'], 'pre_activation': not frozen}}}
    rng = np.random.RandomState(0)
    k = 10
    batch = {'audio_data': (.3 * rng.randn(2, SAMPLES)).astype(np.float32),
             'seq_len': np.array([50, 33], np.int32),
             'weak_targets': (rng.rand(2, k) > .5).astype(np.float32),
             'boundary_targets': (rng.rand(2, k, 50) > .6).astype(
                 np.float32)}

    def step():
        model = tweak.CRNN.from_config(tweak.CRNN.get_config(config),
                                       device='cpu')
        weights = np.random.RandomState(1)
        for p in model.module.parameters():
            p.data = torch.from_numpy(
                .1 * weights.randn(*p.shape).astype(np.float32))
        model.module.train()
        loss, _ = model.loss(model.to_device(batch))
        loss.backward()
        return {n: p.grad.clone() for n, p in model.module.named_parameters()}

    calls = []
    plain_conv = kconv._conv_same

    def counting_conv(x, w, flip=False):
        calls.append((flip, w.shape[0]))  # w is OIHW: its output channels
        return plain_conv(x, w, flip)

    monkeypatch.setattr(kconv, '_conv_same', counting_conv)
    grads = step()
    dx_channels = [out for flip, out in calls if flip]
    assert len(dx_channels) == (2 if frozen else 3), calls
    assert (1 in dx_channels) != frozen
    # the same step with dx computed at every conv
    plain_bwd = kconv.conv2d_same_bwd
    monkeypatch.setattr(kconv, 'conv2d_same_bwd',
                        lambda x, w, gy, need_dx=True: plain_bwd(x, w, gy))
    calls.clear()
    with_dx = step()
    assert 1 in [out for flip, out in calls if flip]
    assert grads.keys() == with_dx.keys()
    for name in grads:
        assert torch.equal(grads[name], with_dx[name]), name
