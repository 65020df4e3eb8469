"""``compute_dtype='float32'`` against the JAX package: the f32 conv
(``Conv2dSameF32``: the plain version of the f32 conv kernel on the CPU)
against ``lax.conv_general_dilated`` on f32 operands, its backward
without dx where the input needs no gradient, a numpy emulation of the
card's 3xTF32 split (``csrc/conv2d_f32_wgmma.cuh``), the 2-D and 1-D
towers in f32 against the JAX towers' unpacked XLA path in f32, and the
slice as a whole: a tiny FBCRNN with f32 towers and f32 output nets and a
tiny tag-conditioned BiCRNN (hidden size 200), each loaded from a JAX run
directory (its ``config.json`` names the JAX package's classes) and held
against the JAX model, scores and one training step.

Every input is made from a seeded numpy ``RandomState`` and handed to
both packages; the port runs its kernels' plain versions (CPU tensors,
no launch). Tolerances:

- the conv and the towers: f32 against f32, so only the summation order
  differs: ``1e-5 * max|ref|`` for outputs, gradients and running
  statistics (the largest distance measured here is 1.6e-6 of the
  tensor's largest entry). Two kinds of gradient are single sums that
  cancel, and are held to ``1e-5`` of the tower's largest gradient entry
  instead (measured: up to 3e-7 of it): a conv bias whose output feeds a
  training-mode batch norm (zero in exact arithmetic, ~1e-5 in either
  package) and the one-channel entry norm's scale and shift (up to 4e-5
  of their own value);
- the models, whose GRU keeps its bf16 rounding points in both packages:
  ``1e-4 + 3e-2 * max|ref|`` for scores (``tests/test_torch_fbcrnn.py``)
  and the gradient rule of ``tests/test_torch_train.py`` (the larger of
  ``1e-4 + 3.5e-2 * max|ref|`` and twice the JAX package's own
  Pallas-vs-XLA gap; three times for the bidirectional model, as
  ``tests/test_torch_strong.py``).
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import strong_label as jstrong
from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.models.base.model import (flatten_variables,
                                          unflatten_variables)
from pb_sed_tpu.ops import cnn as jcnn
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.utils.config import config_to_json
from pb_sed_tpu.utils.misc import dump_json
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import strong_label as tstrong
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.ops import cnn as tcnn
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels import conv as kconv
from pb_sed_tpu_torch.ops.kernels.conv import (Conv2dSameF32,
                                               conv2d_same_f32_bwd)
from tests import test_torch_fbcrnn as fbcrnn_tests
from tests import test_torch_strong as strong_tests
from tests.test_torch_train import _cosine

torch.set_num_threads(2)

TIGHT = 1e-5


@pytest.fixture(autouse=True)
def auto_mode():
    yield
    jrnn.set_pallas_mode('auto')


def _tight(got, ref, scale=None):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = float(np.abs(ref).max()) if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=TIGHT * scale)


def _close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=1e-4 + 3e-2 * float(np.abs(ref).max()))


# -- the f32 conv -------------------------------------------------------------

@pytest.mark.parametrize('kt,kf,cin,cout', [
    (3, 3, 1, 16),     # the entry layer
    (3, 3, 16, 24),    # Cout off a multiple of 16
    (2, 2, 5, 7),      # an even kernel, XLA's asymmetric SAME pads
    (4, 3, 8, 16),
    (1, 1, 12, 20),    # a 1x1 kernel through the conv
])
def test_f32_conv_matches_lax(kt, kf, cin, cout):
    """Forward (with the f32 bias) and the VJP (dx, dw, db) against
    ``lax.conv_general_dilated(..., 'SAME')`` on f32 operands, at odd T
    and F."""
    rng = np.random.RandomState(100 * kt + cin)
    x = rng.randn(2, 7, 5, cin).astype(np.float32)
    w = (rng.randn(kt, kf, cin, cout) / np.sqrt(kt * kf * cin)).astype(
        np.float32)
    b = (.1 * rng.randn(cout)).astype(np.float32)
    gy = rng.randn(2, 7, 5, cout).astype(np.float32)

    def conv(x, w, b):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), 'SAME',
            dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + b

    y_ref, vjp = jax.vjp(conv, *map(jnp.asarray, (x, w, b)))
    refs = vjp(jnp.asarray(gy))
    args = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    build.reset_launches()
    y = Conv2dSameF32.apply(*args)
    assert y.dtype == torch.float32
    _tight(y.detach().numpy(), y_ref)
    grads = torch.autograd.grad(y, args, torch.from_numpy(gy))
    for got, ref in zip(grads, refs):
        assert got.dtype == torch.float32
        _tight(got.numpy(), ref)
    dx, dw = conv2d_same_f32_bwd(args[0].detach(), args[1].detach(),
                                 torch.from_numpy(gy))
    assert torch.equal(dx, grads[0]) and torch.equal(dw, grads[1])
    assert build.LAUNCHES['conv2d_same_f32'] == 0


def test_f32_conv_members_under_vmap_equal_each_member():
    """The stacked ensemble's member axis: ``torch.func.vmap`` of
    ``Conv2dSameF32`` (its rule: one launch for all members on the card)
    equals each member's call, with a bias shared by the members too."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 2, 6, 8, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(3, 3, 3, 4, 16).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 16).astype(np.float32))
    got = torch.func.vmap(Conv2dSameF32.apply)(x, w, b)
    for m in range(3):
        assert torch.equal(got[m], Conv2dSameF32.apply(x[m], w[m], b[m]))
    got = torch.func.vmap(Conv2dSameF32.apply, in_dims=(0, 0, None))(
        x, w, b[0])
    assert torch.equal(got[1], Conv2dSameF32.apply(x[1], w[1], b[0]))


def test_f32_conv_backward_skips_dx_without_changing_dw(monkeypatch):
    """Where autograd needs no dx (a tower's log-mel input), the backward
    asks for none (``need_dx=False``: the kernel skips its dx pass), and
    dw and db equal those of a backward that computed dx in every bit."""
    rng = np.random.RandomState(18)
    x = torch.from_numpy(rng.randn(2, 7, 8, 4).astype(np.float32))
    w = torch.from_numpy((rng.randn(3, 3, 4, 16) / 6).astype(np.float32))
    b = torch.from_numpy((.1 * rng.randn(16)).astype(np.float32))
    gy = torch.from_numpy(rng.randn(2, 7, 8, 16).astype(np.float32))
    asked = []

    def spy(*args, **kwargs):
        asked.append(kwargs['need_dx'])
        return conv2d_same_f32_bwd(*args, **kwargs)

    monkeypatch.setattr(kconv, 'conv2d_same_f32_bwd', spy)
    grads = {}
    for need in (True, False):
        xt = x.clone().requires_grad_(need)
        wt, bt = w.clone().requires_grad_(), b.clone().requires_grad_()
        y = Conv2dSameF32.apply(xt, wt, bt)
        inputs = [wt, bt] + ([xt] if need else [])
        grads[need] = torch.autograd.grad(y, inputs, gy)
    assert asked == [True, False]
    for got, ref in zip(grads[False], grads[True][:2]):
        assert torch.equal(got, ref)
    dx, dw = conv2d_same_f32_bwd(x, w, gy, need_dx=False)
    assert dx is None and torch.equal(dw, grads[True][0])


@pytest.mark.parametrize('norm,input_grad,want', [
    ('batch', False, True),   # the recipes: norm_0's scale and shift
    (None, False, False),     # nothing upstream needs a gradient
])
def test_f32_entry_layer_asks_for_dx_where_upstream_needs_it(
        monkeypatch, norm, input_grad, want):
    """The entry layer (Cin = 1) of a pre-activation f32 tower, as the
    shallow recipe builds it: under a batch norm, whose learnable scale and
    shift sit before it, its backward asks for dx (``need_dx=True``) even
    where the tower's input needs no gradient; without a norm, and with an
    input that needs none, it asks for none."""
    rng = np.random.RandomState(22)
    tower = tcnn.CNN2d(out_channels=[4, 4], kernel_size=3,
                       pool_size=[1, [2, 1]], pre_activation=True,
                       norm=norm, compute_dtype='float32', in_channels=1)
    bridge.load_flat(tower, bridge.random_flat(bridge.export_flat(tower), 5))
    tower.train()
    x = torch.from_numpy(rng.randn(2, 7, 8, 1).astype(np.float32))
    x.requires_grad_(input_grad)
    asked = []

    def spy(*args, **kwargs):
        asked.append((args[0].shape[-1], kwargs['need_dx']))
        return conv2d_same_f32_bwd(*args, **kwargs)

    monkeypatch.setattr(kconv, 'conv2d_same_f32_bwd', spy)
    y, _ = tower(x, torch.tensor([7, 5]))
    y.sum().backward()
    assert dict(asked)[1] is want, asked
    assert len(asked) == 2


def _tf32(a):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away
    from zero (half an ulp added to the magnitude, the low 13 bits
    cleared)."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _tf32_truncated(a):
    """An f32 value as the tensor cores read it as a tf32 operand: the low
    13 bits dropped."""
    bits = np.asarray(a, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a, lo_rounded=True):
    hi = _tf32(a)
    lo = a - hi   # exact in f32
    return hi, _tf32(lo) if lo_rounded else _tf32_truncated(lo)


def _emulated_3xtf32(a, b, run, a_lo_rounded=True, b_lo_rounded=True):
    """``a (M, K) @ b (K, N)`` as the card's 3xTF32 kernels take it: each
    operand split into tf32 hi and lo, per k8 step the block sums of
    hi*lo, lo*hi and hi*hi (lo*lo dropped; products exact, each block sum
    rounded once to f32) added in that order to an f32 run sum, which
    starts afresh every ``run`` k8 steps and is then added to an f32
    register sum. The block sums round to nearest: this models the split
    and the f32 sums, not the tensor cores' own accumulation. An operand
    whose lo is not rounded (``*_lo_rounded=False``: the entry kernels'
    activations, split in registers) has it truncated to tf32, as the
    tensor cores read an f32 register."""
    pad = -a.shape[1] % 8
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    (ahi, alo), (bhi, blo) = _split(a, a_lo_rounded), _split(b, b_lo_rounded)
    steps = a.shape[1] // 8

    def blocks(p, q):
        return np.einsum('msk,skn->smn',
                         p.astype(np.float64).reshape(len(p), steps, 8),
                         q.astype(np.float64).reshape(steps, 8, -1)).astype(
                             np.float32)

    terms = (blocks(ahi, blo), blocks(alo, bhi), blocks(ahi, bhi))
    total = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(total)
    for s in range(steps):
        if s % run == 0:
            part[:] = 0
        for term in terms:
            part = part + term[s]
        if s % run == run - 1 or s == steps - 1:
            total = total + part
    return total


@pytest.mark.parametrize('name,k,run,gate', [
    # the forward and dx at L8's K = 9 taps x 256 channels, a run a K
    # slice of 9 taps x 32 channels
    ('fwd', 2304, 36, 2e-5),
    # dw over 20 000 pixels, a run a 128-pixel tile of one tap
    ('dw', 20000, 16, 1e-4),
    # the entry kernels (csrc/conv2d_f32_entry.cuh), a run one k8 step:
    # the forward at Cin = 1 (K = 9) and at Cin = 11 (K = 99, padded to
    # 112), the dx of a 16- and a 32-channel layer (K = 144, 288), the dw
    # at Cin = 1 over 20 000 pixels (both operands activations)
    ('entry fwd', 9, 1, 2e-5),
    ('entry fwd', 112, 1, 2e-5),
    ('entry dx', 144, 1, 2e-5),
    ('entry dx', 288, 1, 2e-5),
    ('entry dw', 20000, 1, 1e-4),
])
def test_3xtf32_split_error_is_a_tenth_of_the_gate(name, k, run, gate):
    """The 3xTF32 split with f32 sums against the f64 sum of the f32
    operands: within a tenth of the card's gate (``gate * max|ref|``),
    where plain TF32 (hi*hi alone) misses the whole gate. The entry
    kernels split the weights with cvt.rna and the activations in
    registers (their lo truncated by the tensor cores): the forward's and
    dx's A operand, both of the dw's."""
    rng = np.random.RandomState(k)
    a = rng.randn(32, k).astype(np.float32)
    b = (rng.randn(k, 16) / np.sqrt(k)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = float(np.abs(ref).max())
    entry = name.startswith('entry')
    got = _emulated_3xtf32(a, b, run, a_lo_rounded=not entry,
                           b_lo_rounded=name != 'entry dw')
    assert np.abs(got - ref).max() <= .1 * gate * scale, name
    plain = _tf32(a).astype(np.float64) @ _tf32(b).astype(np.float64)
    assert np.abs(plain - ref).max() > gate * scale, name


# -- the towers ---------------------------------------------------------------

_BN = dict(norm='batch', norm_kwargs={'eps': 1e-3})
# name: (2-D, kwargs, T, F, training)
TOWERS = {
    # the shallow recipe's shape: pre-activation, (2, 1) pools
    'shallow': (True, dict(out_channels=[16, 16, 32], kernel_size=3,
                           pool_size=[1, [2, 1], [2, 1]],
                           pre_activation=True, **_BN), 11, 16, True),
    # the deep recipe's shape: 3x3 and 1x1 layers, residuals across one
    # and two (2, 1) pools (one average window each, the unpacked path's
    # match) and into more channels
    'deep': (True, dict(out_channels=[16, 16, 32, 32, 32],
                        kernel_size=[3, 1, 3, 1, 3],
                        pool_size=[1, [2, 1], 1, [2, 1], 1],
                        residual_connections=[4, 3, None, None, None],
                        pre_activation=True, **_BN), 9, 16, True),
    # fuse_bn: the f32 tower fuses no layer, as JAX's unpacked path
    'fuse_bn': (True, dict(out_channels=[16, 16, 32], kernel_size=3,
                           pool_size=[1, [2, 1], [2, 1]],
                           pre_activation=True, fuse_bn=True, **_BN), 11,
                16, True),
    # eval: the running statistics normalize; post-activation, a time
    # pool and an even kernel
    'eval': (True, dict(out_channels=[16, 24], kernel_size=[3, [2, 2]],
                        pool_size=[[2, 2], 1], **_BN), 11, 16, False),
    'cnn1d': (False, dict(out_channels=[16, 32, 32], kernel_size=[1, 3, 3],
                          pool_size=[1, 2, 1],
                          residual_connections=[2, None, None],
                          pre_activation=True, **_BN), 12, 24, True),
}


def _bn_fed(tower):
    """The conv biases of a pre-activation tower whose output reaches the
    end only through a training-mode norm (zero gradient in exact
    arithmetic): every layer's but those the end reaches along skips."""
    n = len(tower.out_channels)
    reaches = [False] * n
    for i in reversed(range(n)):
        j = tower.residuals[i]
        reaches[i] = i == n - 1 or (j is not None and reaches[j])
    return {f'conv_{i}.bias' for i in range(n) if not reaches[i]}


@pytest.mark.parametrize('name', sorted(TOWERS))
def test_f32_towers_match_jax(name):
    """The port's tower with ``compute_dtype='float32'`` against the JAX
    tower with the same setting (its unpacked XLA path, as on the CPU):
    output (f32) and ``seq_len`` (exact), the running statistics after the
    call and the gradients of ``sum(y * gy)`` (parameters and input)."""
    two_d, kwargs, t, f, training = TOWERS[name]
    kwargs = dict(kwargs, compute_dtype='float32')
    rng = np.random.RandomState(sorted(TOWERS).index(name))
    x = rng.randn(2, t, f, 1) if two_d else rng.randn(2, t, f)
    x = x.astype(np.float32)
    seq_len = np.array([t, t - 4], np.int32)
    cls = tcnn.CNN2d if two_d else tcnn.CNN1d
    port = cls(**kwargs, in_channels=x.shape[-1])
    assert not getattr(port, 'fused', ())
    flat = bridge.random_flat(bridge.export_flat(port), 3)
    bridge.load_flat(port, flat)
    port.train(training)
    xt = torch.from_numpy(x).requires_grad_()
    y, sl = port(xt, torch.from_numpy(seq_len))
    assert y.dtype == torch.float32
    gy = rng.randn(*y.shape).astype(np.float32)
    (y * torch.from_numpy(gy)).sum().backward()

    jtower = (jcnn.CNN2d if two_d else jcnn.CNN1d)(**kwargs)
    variables = unflatten_variables(flat)

    def run(params, x):
        (yy, ss), state = jtower.apply(
            dict(variables, params=params), x, jnp.asarray(seq_len),
            training=training, mutable=['batch_stats'])
        return jnp.sum(yy * gy), (yy, ss, state)

    (_, (y_ref, sl_ref, state)), (gp, gx) = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(variables['params'],
                                           jnp.asarray(x))
    assert y_ref.dtype == jnp.float32
    _tight(y.detach().numpy(), y_ref)
    np.testing.assert_array_equal(sl.numpy(), np.asarray(sl_ref))
    stats = flatten_variables({'batch_stats': state.get('batch_stats', {})})
    exported = bridge.export_flat(port)
    for key, ref in stats.items():
        _tight(exported[key], ref)
    grads = flatten_variables({'params': gp})
    largest = max(float(np.abs(g).max()) for g in grads.values())
    cancels = _bn_fed(port) if training else set()
    for pname, p in port.named_parameters():
        ref = grads[f'params.{pname}']
        _tight(p.grad.numpy(), ref,
               largest if pname in cancels or ref.size == 1 else None)
    _tight(xt.grad.numpy(), gx)


# -- the slice as a whole -----------------------------------------------------

def _f32_towers(config, *heads):
    for tower in ('cnn_2d', 'cnn_1d'):
        config['cnn'][tower]['compute_dtype'] = 'float32'
    for head in heads:
        config[head]['output_net']['compute_dtype'] = 'float32'
    return config


def _fbcrnn_config():
    config = _f32_towers(pickle.loads(pickle.dumps(fbcrnn_tests.CONFIG)),
                         'rnn_fwd')
    config['cnn']['cnn_2d']['fuse_bn'] = True
    config['rnn_fwd']['rnn']['hidden_size'] = 40
    return config


def _bicrnn_config():
    config = _f32_towers(strong_tests._config(True), 'rnn')
    config['rnn']['rnn'].update(hidden_size=200, num_layers=1)
    return config


def _jax_model(cls, config, batch):
    """The JAX model with seeded weights in its own keys and shapes (built
    abstractly: no init is run)."""
    model = cls.from_config(cls.get_config(config))
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda: model.module.init(
        {'params': jax.random.PRNGKey(0)}, batch, training=False))
    flat = bridge.random_flat(flatten_variables(jax.tree_util.tree_map(
        lambda a: np.zeros(a.shape, np.float32), dict(shapes))), 7)
    model.variables = jax.tree_util.tree_map(jnp.asarray,
                                             unflatten_variables(flat))
    return model


def _from_jax_run(jmodel, jcls, tcls, config, tmp_path, checkpoint):
    """The port's model from a JAX run directory: the JAX model's
    checkpoint and its ``config.json`` (the JAX package's factories,
    ``port_config`` maps them)."""
    jmodel.save_checkpoint(tmp_path / 'checkpoints' / checkpoint)
    dump_json({'trainer': {'model': config_to_json(jcls.get_config(
        config))}}, tmp_path / '1' / 'config.json')
    return tcls.from_storage_dir(tmp_path, checkpoint_name=checkpoint,
                                 device='cpu')


def _jax_step(model, batch, mode):
    jrnn.set_pallas_mode(mode)
    variables = model.variables

    def loss_of(params):
        return model.loss_fn(dict(variables, params=params), batch, {},
                             training=True)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables['params'])
    return (float(loss), flatten_variables({'params': grads}),
            flatten_variables({'batch_stats': aux[0]['batch_stats']}))


def _step_rule(tmodel, batch, jmodel, factor, zero):
    """One training step of both: the loss within ``1e-4 + 3e-2 * |ref|``,
    the running statistics within the model tolerance, every gradient
    within the larger of ``1e-4 + 3.5e-2 * max|ref|`` and ``factor``
    times the JAX package's own Pallas-vs-XLA gap, and ``1 - cos`` within
    0.01 or ``factor`` times JAX's own where the true gradient is not
    identically zero (``zero``)."""
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads, jstats = _jax_step(jmodel, jbatch, 'force_interpret')
    _, xla_grads, _ = _jax_step(jmodel, jbatch, 'off')
    module = tmodel.module
    module.train()
    try:
        loss, _ = tmodel.loss(tmodel.to_device(batch))
        loss.backward()
    finally:
        module.eval()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    exported = bridge.export_flat(module)
    for key, ref in jstats.items():
        _close(exported[key], ref)
    for name, p in module.named_parameters():
        key = f'params.{name}'
        ref, got = jgrads[key], p.grad.numpy()
        gap = float(np.abs(got - ref).max())
        jax_gap = float(np.abs(xla_grads[key] - ref).max())
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()),
                    factor * jax_gap)
        assert gap <= bound, (name, gap, bound)
        if name not in zero and ref.size >= 16:
            miss = 1. - _cosine(got, ref)
            assert miss <= max(.01, factor * (1. - _cosine(
                xla_grads[key], ref))), (name, miss)
        p.grad = None


def test_f32_fbcrnn_from_a_jax_run_matches_jax(tmp_path):
    """A tiny FBCRNN with f32 towers (``fuse_bn`` asked for: nothing
    fuses), f32 output nets and GRU heads at H = 40 (the kernels run 64),
    loaded from a JAX run directory: tagging and SED (window 11) against
    the JAX model (its GRU on the Pallas kernel in interpret mode), then
    one training step."""
    config = _fbcrnn_config()
    batches = fbcrnn_tests._batches()
    jmodel = _jax_model(jweak.CRNN, config,
                        {k: v for k, v in batches[0].items()
                         if k != 'example_id'})
    tmodel = _from_jax_run(jmodel, jweak.CRNN, tweak.CRNN, config,
                           tmp_path, 'ckpt_best_macro_fscore_weak.pkl')
    module = tmodel.module
    assert module.cnn.cnn_2d.dtype == torch.float32 and \
        not module.cnn.cnn_2d.fused
    assert module.rnn_bwd.output_net.dtype == torch.float32
    assert module.rnn_fwd.rnn.hidden_size == 40
    jrnn.set_pallas_mode('force_interpret')
    build.reset_launches()
    batch = batches[1]
    jy, jsl = jmodel.tagging(batch)
    ty, tsl = tmodel.tagging(batch)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)
    jy, jsl = jmodel.sound_event_detection(batch, 11, window_shift=1)
    ty, tsl = tmodel.sound_event_detection(batch, 11, window_shift=1)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)
    assert not any(build.LAUNCHES.values())
    from tests.test_torch_train import BN_FED_BIASES, _train_batch
    _step_rule(tmodel, _train_batch(1), jmodel, 2., BN_FED_BIASES)


def test_bicrnn_at_200_from_a_jax_run_matches_jax(tmp_path):
    """The tiny tag-conditioned BiCRNN with f32 towers and output net and
    a bidirectional GRU layer at H = 200 (the kernels run 224 or 256),
    loaded from a JAX run directory: tagging against the JAX model on its
    Pallas GRU in interpret mode, then one training step."""
    config = _bicrnn_config()
    batch = strong_tests._batch(1)
    jmodel = _jax_model(jstrong.CRNN, config, strong_tests._arrays(batch))
    tmodel = _from_jax_run(jmodel, jstrong.CRNN, tstrong.CRNN, config,
                           tmp_path, 'ckpt_best_macro_fscore_strong.pkl')
    assert tmodel.module.rnn.rnn.hidden_size == 200
    assert tmodel.module.cnn.cnn_1d.dtype == torch.float32
    jrnn.set_pallas_mode('force_interpret')
    jy, jsl = jmodel.tagging(strong_tests._arrays(batch))
    ty, tsl = tmodel.tagging(batch)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)
    _step_rule(tmodel, strong_tests._arrays(strong_tests._batch(2)), jmodel,
               3., strong_tests.BN_FED_BIASES)
