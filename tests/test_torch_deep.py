"""The port's deep recipe (``net_configs.cnn_config('deep')``: residual
skips across pools with channel growth, alternating 3x3/1x1 convs, wide
channels) against the JAX package on the same seeded numpy inputs and
weights: the (2, 1) average pool that matches a residual across a pool
(bit-exact against the Pallas avg kernels), the SAME conv at the shapes
where the JAX package takes its channel-blocked kernel
(``_fwd_kernel_cb``), a deep-structured mini 2-D tower on the JAX packed
path, a deep-structured mini FBCRNN (serving, loss, gradients and three
``Trainer`` steps with the AudioSet recipe's settings), and the full-width
deep FBCRNN's flat keys.

The JAX side runs its Pallas kernels in interpret mode, as its own CPU
tests do; the port runs its kernels' plain versions (CPU tensors).
Tolerances: outputs ``1e-4 + 3e-2 * max|ref|`` (``tests/
test_torch_fbcrnn.py``); the conv forward ``1e-4 + 1.2e-2 * max|ref|``
and its gradients 3.5e-2 / 3.5e-2 / 8e-2 relative (``tests/
test_pallas_conv.py:770,780``); model gradients the larger of
``1e-4 + 3.5e-2 * max|ref|`` and twice the JAX package's own
Pallas-vs-XLA gap (``tests/test_torch_train.py`` docstring).
"""
import pickle

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
from pb_sed_tpu.train.hooks import LRAnnealingHook
from pb_sed_tpu.train.optimizer import Adam as JaxAdam
from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
from pb_sed_tpu.utils.misc import to_list
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
from pb_sed_tpu_torch.ops import cnn as tcnn
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.ops.kernels.conv import (AvgPoolFreq2, Conv2dSame,
                                               avgpool_freq2,
                                               avgpool_freq2_bwd,
                                               conv2d_same)
from pb_sed_tpu_torch.train.hooks import \
    LRAnnealingHook as PortLRAnnealingHook
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from chip_smoke import bn_fed_biases
from tests.test_torch_fbcrnn import CONFIG, K, _batches
from tests.test_torch_train import (_cosine, _jax_loss_and_grads,
                                    _train_batch)

torch.set_num_threads(2)


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


def _close(got, ref, rel=3e-2):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 + rel * float(np.max(np.abs(ref))))


# -- the residual average pool ----------------------------------------------

@pytest.mark.parametrize('dtype', ['bfloat16', 'float32'])
def test_avgpool_freq2_matches_pallas_bit_exact(interpret_mode, dtype):
    """Forward and VJP of the row-pair mean against
    ``avgpool2_rows_packed`` (through ``pack_fm``/``unpack_fm``), bf16
    input (a residual crossing one pool) and f32 input (a second pool)."""
    rng = np.random.RandomState(5)
    b, t, f, c = 2, 9, 16, 24
    jdtype = jnp.dtype(dtype)
    x = np.array(jnp.asarray(rng.randn(b, t, f, c).astype(np.float32))
                 .astype(jdtype).astype(jnp.float32))
    gy = rng.randn(b, t, f // 2, c).astype(np.float32)
    g = pconv.fm_geom(t, f, 3, 3, c)
    g_out = g._replace(t=f // 2, tp=f // 2, ls=f // 2 * g.fs, tc=1)

    def pool(x):
        y2 = pconv.avgpool2_rows_packed(pconv.pack_fm(x, g, jdtype), f // 2,
                                        g.fs, True)
        return pconv.unpack_fm(y2, g_out, jnp.float32)

    y_ref, vjp = jax.vjp(pool, jnp.asarray(x).astype(jdtype))
    (dx_ref,) = vjp(jnp.asarray(gy))
    tdtype = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdtype).requires_grad_()
    build.reset_launches()
    y = AvgPoolFreq2.apply(xt, c)
    assert y.dtype == torch.float32
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(y_ref))
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(gy))
    assert dx.dtype == tdtype
    np.testing.assert_array_equal(dx.float().numpy(),
                                  np.asarray(dx_ref, np.float32))
    # the fused channel pad: zeros past C forward, no gradient backward
    padded = avgpool_freq2(xt.detach(), 2 * c)
    np.testing.assert_array_equal(padded[..., :c].numpy(), y.detach().numpy())
    assert not padded[..., c:].any()
    g_pad = torch.cat([torch.from_numpy(gy), torch.ones_like(
        torch.from_numpy(gy))], dim=-1)
    np.testing.assert_array_equal(
        avgpool_freq2_bwd(g_pad, c, tdtype).float().numpy(),
        dx.float().numpy())
    assert build.LAUNCHES == {name: 0 for name in build.LAUNCHES}


# -- the conv at the channel-blocked shapes ---------------------------------

@pytest.mark.parametrize('cin,cout', [(256, 256), (256, 512)])
def test_conv2d_same_matches_channel_blocked_pallas(interpret_mode, cin,
                                                    cout):
    """``conv2d_same`` and its backward against ``conv2d_packed_fm`` where
    the JAX package takes ``_fwd_kernel_cb`` (deep L14 and L16), the
    shapes of ``tests/test_pallas_conv.py:740-784``."""
    assert pconv._cb_of(cin) == 128
    rng = np.random.RandomState(21)
    t, f = 12, 8
    x = np.array(jnp.asarray(.3 * rng.randn(2, t, f, cin)).astype(
        jnp.bfloat16).astype(jnp.float32))
    w = (rng.randn(3, 3, cin, cout) / (3. * np.sqrt(cin))).astype(np.float32)
    b = (.1 * rng.randn(cout)).astype(np.float32)
    gy = rng.randn(2, t, f, cout).astype(np.float32)
    g = pconv.fm_geom(t, f, 3, 3, max(cin, cout), cin=cin, cout=cout)

    def packed(x, w, b):
        y2 = pconv.conv2d_packed_fm(pconv.pack_fm(x, g), w, b, g, True)
        return pconv.unpack_fm(y2, g, jnp.float32)

    y_ref, vjp = jax.vjp(packed, *map(jnp.asarray, (x, w, b)))
    grads_ref = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = Conv2dSame.apply(xt, wt, bt)
    _close(y.float().detach().numpy(), y_ref, 1.2e-2)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    for got, ref, rel in zip((xt.grad.float(), wt.grad, bt.grad), grads_ref,
                             (3.5e-2, 3.5e-2, 8e-2)):
        _close(got.numpy(), np.asarray(ref, np.float32), rel)
    torch.testing.assert_close(
        conv2d_same(xt.detach(), wt.detach(), bt.detach()), y.detach(),
        rtol=0, atol=0)


# -- the 1x1 convs ------------------------------------------------------------

def _bf16_bits(a):
    """bf16 values (as f32) -> their 16-bit patterns, ordered."""
    return (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(np.int64)


@pytest.mark.parametrize('cin,cout', [(16, 32), (256, 256)])
def test_1x1_conv_matches_jax_bf16_einsum(cin, cout):
    """The 2-D tower's 1x1 conv against the JAX package's packed 1x1 conv
    on its device path (``pb_sed_tpu/ops/cnn.py:81-99`` with bf16
    operands, f32 accumulation, the f32 bias added before one rounding):
    ``y``, ``dx`` and ``dw`` (which JAX's autodiff rounds to bf16, the
    weight's dtype inside the dot) equal JAX's bit for bit but for at
    most 0.1% of their elements, each one bf16 ulp off (f32 summation
    order); ``db`` is the f32 sum of the cotangent (``1e-5 * max|ref|``)."""
    rng = np.random.RandomState(4)
    shape = (2, 12, 8)
    x = np.array(jnp.asarray(rng.randn(*shape, cin)).astype(
        jnp.bfloat16).astype(jnp.float32))
    w = (rng.randn(1, 1, cin, cout) / np.sqrt(cin)).astype(np.float32)
    b = (.1 * rng.randn(cout)).astype(np.float32)
    g = np.array(jnp.asarray(rng.randn(*shape, cout)).astype(
        jnp.bfloat16).astype(jnp.float32))

    def jax_1x1(x, w, b):
        y = jnp.einsum('btfi,io->btfo', x.astype(jnp.bfloat16),
                       w[0, 0].astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32)
        return (y + b.astype(jnp.float32)).astype(jnp.bfloat16)

    y_ref, vjp = jax.vjp(jax_1x1, jnp.asarray(x, jnp.bfloat16),
                         jnp.asarray(w), jnp.asarray(b))
    refs = vjp(jnp.asarray(g, jnp.bfloat16))
    conv = tcnn.Conv2d(cin, cout, (1, 1))
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(w))
        conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    y = conv(xt)
    assert y.dtype == torch.bfloat16
    dx, dw, db = torch.autograd.grad(y, (xt, conv.kernel, conv.bias),
                                     torch.from_numpy(g).to(torch.bfloat16))
    for name, got, ref in (('y', y, y_ref), ('dx', dx, refs[0]),
                           ('dw', dw, refs[1])):
        ulps = np.abs(_bf16_bits(got.detach().float().numpy())
                      - _bf16_bits(np.asarray(ref, np.float32)))
        assert ulps.max() <= 1, name
        assert np.count_nonzero(ulps) <= 1e-3 * ulps.size, name
    db_ref = np.asarray(refs[2])
    np.testing.assert_allclose(db.numpy(), db_ref, rtol=0,
                               atol=1e-5 * float(np.abs(db_ref).max()))


# -- a deep-structured mini tower on the JAX packed path ---------------------

TOWER = {
    # 3x3/1x1 alternating; two residuals into layer 2 across a pool
    # (16 -> 32 channels), one into layer 4 across a pool (32 -> 256, the
    # deep L2 -> L4 kind), one without pool or growth (4 -> 5); layer 4
    # has Cin = 256: the JAX package's channel-blocked conv kernel
    'out_channels': [16, 16, 32, 256, 256, 256],
    'kernel_size': [3, 1, 3, 1, 3, 1],
    'pool_size': [1, [2, 1], 1, [2, 1], 1, 1],
    'residual_connections': [2, 2, 4, None, 5, None],
    'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
    'activation_fn': 'relu', 'pre_activation': True,
}


def _jax_tower(pallas_mode, flat, x, seq_len, gy, training):
    """The JAX tower's output, its mutated statistics and the gradients
    of ``sum(y * gy)`` (params and input), one kernel mode."""
    jrnn.set_pallas_mode(pallas_mode)
    mod = jcnn.CNN2d(**TOWER, use_pallas=True)
    variables = unflatten_variables(flat)

    def run(params, x):
        vs = dict(variables, params=params)
        (y, _), state = mod.apply(vs, x, seq_len, training=training,
                                  mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * gy), (y, state)

    (_, (y, state)), grads = jax.jit(jax.value_and_grad(
        run, argnums=(0, 1), has_aux=True))(variables['params'], x)
    return (np.asarray(y, np.float32),
            flatten_variables({'batch_stats': state['batch_stats']}),
            flatten_variables({'params': grads[0]}), np.asarray(grads[1]))


@pytest.mark.parametrize('training', [True, False], ids=['train', 'eval'])
def test_deep_tower_matches_jax_packed(interpret_mode, monkeypatch,
                                       training):
    rng = np.random.RandomState(8)
    b, t, f = 2, 12, 8
    x = jnp.asarray(rng.randn(b, t, f, 1).astype(np.float32))
    seq_len = jnp.asarray(np.array([12, 9], np.int32))
    n = len(TOWER['out_channels'])
    plan = jcnn.CNN2d(**TOWER, use_pallas=True)._packed_plan(
        x, TOWER['kernel_size'], TOWER['pool_size'],
        to_list(TOWER['residual_connections'], n))
    assert plan[:2] == (0, n)
    mod = jcnn.CNN2d(**TOWER, use_pallas=True)
    flat = bridge.random_flat(flatten_variables(
        mod.init(jax.random.PRNGKey(0), x, seq_len)), 3)
    gy = rng.randn(b, t, f // 4, 256).astype(np.float32)
    # the packed path reaches the avg kernel and the channel-blocked conv
    calls = {'avg': 0, 'cb': 0}
    avg, conv = pconv.avgpool2_rows_packed, pconv.conv2d_packed_fm

    def counting_avg(*args):
        calls['avg'] += 1
        return avg(*args)

    def counting_conv(x2, w, *args):
        calls['cb'] += int(bool(pconv._cb_of(x2.shape[1])))
        return conv(x2, w, *args)

    monkeypatch.setattr(pconv, 'avgpool2_rows_packed', counting_avg)
    monkeypatch.setattr(pconv, 'conv2d_packed_fm', counting_conv)
    y_ref, stats_ref, grads_ref, dx_ref = _jax_tower(
        'force_interpret', flat, x, seq_len, gy, training)
    assert calls['avg'] >= 3 and calls['cb'] >= 1
    _, _, xla_grads, xla_dx = _jax_tower('off', flat, x, seq_len, gy,
                                         training)

    port = tcnn.CNN2d(**TOWER, in_channels=1)
    bridge.load_flat(port, flat)
    port.train(training)
    xt = torch.from_numpy(np.asarray(x)).requires_grad_()
    y, _ = port(xt, torch.from_numpy(np.asarray(seq_len)))
    assert y.dtype == torch.bfloat16
    _close(y.float().detach().numpy(), y_ref)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    stats = bridge.export_flat(port)
    for key, ref in stats_ref.items():
        _close(stats[key], ref)
    named = dict(port.named_parameters())
    pairs = [(f'params.{k}', p.grad.numpy()) for k, p in named.items()]
    pairs.append(('input', xt.grad.numpy()))
    for key, got in pairs:
        ref = dx_ref if key == 'input' else grads_ref[key]
        xla = xla_dx if key == 'input' else xla_grads[key]
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()),
                    2 * float(np.abs(xla - ref).max()))
        assert float(np.abs(got - ref).max()) <= bound, key


# -- a deep-structured mini FBCRNN ------------------------------------------

DEEP = pickle.loads(pickle.dumps(CONFIG))
DEEP['cnn'] = {
    'cnn_2d': {
        'out_channels': [16, 16, 32, 32, 64, 64],
        'kernel_size': [3, 1, 3, 1, 3, 1],
        'pool_size': [1, [2, 1], 1, [2, 1], 1, 1],
        'residual_connections': [2, None, 4, None, 5, None],
        'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
        'pre_activation': True, 'use_pallas': True,
    },
    'cnn_1d': {
        # a residual with channel growth (0 -> 2) and two into layer 3
        'out_channels': [32, 64, 64, 64], 'kernel_size': [1, 3, 1, 3],
        'residual_connections': [2, 3, 3, None],
        'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
        'pre_activation': True,
    },
}
DEEP['rnn_fwd'] = {
    'rnn': {'hidden_size': 64, 'num_layers': 2, 'use_pallas': True},
    'output_net': {'out_channels': [64, K], 'kernel_size': 1,
                   'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
}
DEEP['strong_fwd_bwd_loss_weight'] = 0.   # the AudioSet recipe


@pytest.fixture(scope='module')
def deep_flat():
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(DEEP))))
    jmodel.variables = jax.jit(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(
            _train_batch(0))
    return bridge.random_flat(jmodel.state_dict(), 13)


def _jax_deep(flat):
    model = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(DEEP))))
    model.load_state_dict(flat)
    return model


def _port_deep(flat):
    model = tweak.CRNN.from_config(tweak.CRNN.get_config(
        pickle.loads(pickle.dumps(DEEP))), device='cpu')
    bridge.load_flat(model.module, flat)
    return model


def test_deep_fbcrnn_serves_like_jax(deep_flat, interpret_mode):
    jmodel, tmodel = _jax_deep(deep_flat), _port_deep(deep_flat)
    batch = _batches()[1]
    jy_fwd, jy_bwd, jsl, _, _ = jmodel._apply(batch)
    ty_fwd, ty_bwd, tsl, _, _ = tmodel._apply(batch, 'forward')
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    _close(ty_fwd.numpy(), jy_fwd)
    _close(ty_bwd.numpy(), jy_bwd)
    jy, _ = jmodel.tagging(batch)
    ty, _ = tmodel.tagging(batch)
    _close(ty, jy)
    jy, jsl = jmodel.sound_event_detection(batch, 11, window_shift=1)
    ty, tsl = tmodel.sound_event_detection(batch, 11, window_shift=1)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)


def test_deep_loss_and_gradients_match_jax(deep_flat, interpret_mode):
    batch = _train_batch(1)
    jmodel = _jax_deep(deep_flat)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads, jstats = _jax_loss_and_grads(jmodel, jbatch,
                                                'force_interpret')
    _, xla_grads, _ = _jax_loss_and_grads(jmodel, jbatch, 'off')
    tmodel = _port_deep(deep_flat)
    tmodel.module.train()
    loss, _ = tmodel.loss(tmodel.to_device(batch))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    # norm-fed biases: an identically zero gradient, held to the bound only
    bn_fed = bn_fed_biases(tmodel.module)
    assert 'cnn.cnn_1d.conv_2.bias' not in bn_fed
    for name, p in tmodel.module.named_parameters():
        key = f'params.{name}'
        ref, got = jgrads[key], p.grad.numpy()
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()),
                    2 * float(np.abs(xla_grads[key] - ref).max()))
        assert float(np.abs(got - ref).max()) <= bound, name
        # a cosine of the entry norm's two scalars (one channel) is a
        # sign: held to the bound only, as chip_smoke.py does
        if name not in bn_fed and ref.size >= 16:
            assert _cosine(got, ref) >= .99, (name, _cosine(got, ref))
    stats = bridge.export_flat(tmodel.module)
    for key, ref in jstats.items():
        _close(stats[key], ref)


def _freeze_2d(n):
    """The fine-tune's ``frozen_cnn_2d_layers = n`` as a path predicate."""
    prefixes = tuple(f'cnn.cnn_2d.{kind}_{i}.' for i in range(n)
                     for kind in ('conv', 'norm'))
    return lambda path: path.startswith(prefixes)


def test_three_deep_trainer_steps_match_jax(deep_flat, interpret_mode):
    """The AudioSet recipe's settings: Adam at lr 1e-4 with a ramp,
    gradient clipping 0.1, no strong loss; the first two 2-D layers
    frozen as a fine-tune freezes them."""
    kwargs = dict(lr=1e-4, gradient_clipping=.1, eps=1e-2)
    breakpoints = [(0, .5), (2, 1.)]
    jtrainer = JaxTrainer(_jax_deep(deep_flat), optimizer=JaxAdam(**kwargs),
                          storage_dir=None, use_mesh=False,
                          stop_trigger=(3, 'iteration'))
    ttrainer = Trainer(_port_deep(deep_flat), optimizer=Adam(**kwargs),
                       stop_trigger=(3, 'iteration'))
    batches = [_train_batch(seed) for seed in (1, 2, 3)]
    jtrainer._ensure_ready(batches[0])
    frozen = _freeze_2d(2)
    # each trainer takes its own package's hook (the port's trainer reads
    # the schedule from its own LRAnnealingHook class)
    jtrainer.register_hook(LRAnnealingHook(breakpoints=breakpoints))
    ttrainer.register_hook(PortLRAnnealingHook(breakpoints=breakpoints))
    for trainer in (jtrainer, ttrainer):
        trainer.freeze(frozen)
    assert ttrainer._frozen and ttrainer._frozen_stats
    p0 = bridge.export_flat(ttrainer.model.module)
    bn_fed = bn_fed_biases(ttrainer.model.module)
    for step, batch in enumerate(batches):
        jloss = float(jtrainer.train_step(batch))
        tloss = float(ttrainer.train_step(batch))
        assert abs(tloss - jloss) <= 1e-4 + 3e-2 * abs(jloss), (step, tloss,
                                                                jloss)
        assert ttrainer.step_lr() == pytest.approx(
            1e-4 * [.75, 1., 1.][step], rel=1e-6)
    assert min(float(v) for v in ttrainer._summary['grad_norm']) > .1
    jflat = jtrainer.model.state_dict()
    tflat = bridge.export_flat(ttrainer.model.module)
    for key, before in p0.items():
        path = key.split('.', 1)[1]
        if frozen(path):
            np.testing.assert_array_equal(tflat[key], before)
            np.testing.assert_array_equal(jflat[key], before)
        elif key.startswith('params.'):
            if path not in bn_fed and before.size >= 16:
                cos = _cosine(tflat[key] - before, jflat[key] - before)
                assert cos >= .99, (path, cos)
        else:
            _close(tflat[key], jflat[key])


# -- the full-width deep FBCRNN's keys ---------------------------------------

def test_full_width_deep_keys_match_jax():
    """Every flat key of the JAX deep FBCRNN (527 classes, built
    abstractly with ``jax.eval_shape``) names a port tensor of the same
    shape; the bridge loads it and exports the same keys and shapes."""
    from pb_sed_tpu.models.net_configs import fbcrnn_config as jax_config
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        jax_config('deep', num_events=527)))
    batch = {'audio_data': jax.ShapeDtypeStruct((1, 16000), jnp.float32),
             'seq_len': jax.ShapeDtypeStruct((1,), jnp.int32)}
    tree = jax.eval_shape(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), batch)
    shapes = {jax.tree_util.keystr(path, simple=True, separator='.'):
              tuple(leaf.shape) for path, leaf in
              jax.tree_util.tree_flatten_with_path(dict(tree))[0]}
    tmodel = tweak.CRNN.from_config(tweak.CRNN.get_config(
        fbcrnn_config('deep', num_events=527)), device='cpu')
    flat = {key: np.zeros(shape, np.float32) for key, shape in shapes.items()}
    bridge.load_flat(tmodel.module, flat)
    out = bridge.export_flat(tmodel.module)
    assert {k: v.shape for k, v in out.items()} == shapes
    assert shapes['params.cnn.cnn_2d.conv_16.kernel'] == (3, 3, 256, 512)
    assert shapes['params.cnn.cnn_1d.conv_0.kernel'] == (1, 4096, 512)
    assert shapes['params.rnn_bwd.rnn.layer_1_fwd.w_hh'] == (512, 1536)
