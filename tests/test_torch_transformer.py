"""The port's Transformer head against the JAX package's
(``pb_sed_tpu/ops/rnn.py:403-491``): one block and the whole encoder,
forward and reversed, on clips of unequal lengths; the Transformer-head
FBCRNN's tagging, boundaries and SED through the weight bridge and from a
JAX run directory; a training step's loss and gradients at dropout 0;
causality; ``bridge.init_flat``'s keys, shapes and scales against the JAX
model's.

The same seeded numpy weights go to both packages (``bridge.random_flat``
on the JAX model's flat keys). The JAX side runs its Pallas kernels in
interpret mode, as its own CPU tests do; the port runs its kernels' plain
versions (CPU tensors). Tolerances: the Transformer blocks compute in f32
in both packages (plain matmuls), so one block and the encoder's hidden
state are held to ``1e-5 * max|ref|`` (summation order only); outputs
behind the bf16 output net and the whole model to the model tolerance
``1e-4 + 3e-2 * max|ref|`` of ``tests/test_torch_fbcrnn.py``; gradients
to the noise rule of ``tests/test_torch_train.py``.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.ops import cnn as jcnn
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.utils.config import config_to_json
from pb_sed_tpu.utils.misc import dump_json
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.models.net_configs import fbcrnn_config
from pb_sed_tpu_torch.ops import cnn as tcnn
from pb_sed_tpu_torch.ops import rnn as trnn
from tests.test_torch_fbcrnn import CONFIG, K, _batches, _close
from tests.test_torch_train import (BN_FED_BIASES, _cosine,
                                    _jax_loss_and_grads, _train_batch)

torch.set_num_threads(2)

RNN = {'hidden_size': 16, 'd_ff': 32, 'num_layers': 2, 'dropout': 0.,
       'num_heads': 2}
F_IN = 24


def _tight(got, ref):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def _inputs(seed=0, b=3, t=12):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, t, F_IN).astype(np.float32)
    seq_len = np.array([t, 7, 3][:b], np.int32)
    return x, seq_len


def _jax_encoder(reverse):
    return jrnn.TransformerEncoder(
        rnn=dict(RNN), reverse=reverse,
        output_net=jcnn.CNN1d([16, K], kernel_size=1, output_layer=True))


def _port_encoder(reverse, flat):
    encoder = trnn.TransformerEncoder(
        rnn=dict(RNN, input_size=F_IN), reverse=reverse,
        output_net=tcnn.CNN1d([16, K], kernel_size=1, output_layer=True))
    bridge.load_flat(encoder, flat)
    return encoder


def _jax_flat(module, *args, seed=7):
    variables = module.init(jax.random.PRNGKey(0), *args)
    from pb_sed_tpu.models.base.model import flatten_variables
    return bridge.random_flat(flatten_variables(dict(variables)), seed)


def _unflatten(flat):
    from pb_sed_tpu.models.base.model import unflatten_variables
    return jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))


def test_block_matches_jax():
    """One pre-LayerNorm block under the encoder's causal, length-masked
    attention, in eval: f32 in both packages."""
    x, seq_len = _inputs()
    x = x[..., :16]
    t = x.shape[1]
    pos = np.arange(t)
    mask = ((pos[None, :] <= pos[:, None])[None, None]
            & (pos[None, :] < seq_len[:, None])[:, None, None, :])
    jblock = jrnn._TransformerBlock(16, 32, 2, 0.)
    flat = _jax_flat(jblock, jnp.asarray(x), jnp.asarray(mask))
    ref = jblock.apply(_unflatten(flat), jnp.asarray(x), jnp.asarray(mask))
    block = trnn._TransformerBlock(16, 32, 2, 0.)
    bridge.load_flat(block, flat)
    block.eval()
    got = block(torch.from_numpy(x), torch.from_numpy(mask))
    _tight(got.detach().numpy(), ref)


@pytest.mark.parametrize('reverse', [False, True], ids=['fwd', 'reversed'])
def test_encoder_matches_jax(reverse):
    """The whole head at hidden 16, 2 heads, 2 layers, clips of 12, 7 and
    3 frames, in eval; the keys the JAX head writes are the port's."""
    x, seq_len = _inputs()
    jenc = _jax_encoder(reverse)
    flat = _jax_flat(jenc, jnp.asarray(x), jnp.asarray(seq_len))
    enc = _port_encoder(reverse, flat)
    assert sorted(bridge.export_flat(enc)) == sorted(flat)
    for key in ('params.in_proj.kernel',
                'params.block_1.MultiHeadDotProductAttention_0.query.kernel',
                'params.block_1.MultiHeadDotProductAttention_0.out.kernel',
                'params.block_0.LayerNorm_1.scale',
                'params.output_net.conv_1.kernel'):
        assert key in flat, key
    assert flat['params.block_0.MultiHeadDotProductAttention_0.query.'
                'kernel'].shape == (16, 2, 8)
    ref, ref_len = jenc.apply(_unflatten(flat), jnp.asarray(x),
                              jnp.asarray(seq_len))
    got, got_len = enc(torch.from_numpy(x), torch.from_numpy(seq_len))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    _close(got.detach().numpy(), ref)
    # sliding windows: seq_len None is every sequence full
    ref, _ = jenc.apply(_unflatten(flat), jnp.asarray(x), None)
    got, _ = enc(torch.from_numpy(x), None)
    _close(got.detach().numpy(), ref)


def _model_config():
    config = pickle.loads(pickle.dumps(CONFIG))
    config['rnn_fwd'] = {
        'factory': 'pb_sed_tpu.ops.rnn.TransformerEncoder',
        'rnn': dict(RNN),
        'output_net': {'out_channels': [16, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    }
    return config


def _port_config():
    config = _model_config()
    config['rnn_fwd']['factory'] = trnn.TransformerEncoder
    return config


@pytest.fixture(scope='module')
def models():
    """The tiny Transformer-head FBCRNN of both packages on the same
    seeded weights; the JAX kernels in interpret mode."""
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(_model_config()))
    batch = {k: v for k, v in _batches()[0].items() if k != 'example_id'}
    jmodel.variables = jax.jit(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(batch)
    jmodel.load_state_dict(bridge.random_flat(jmodel.state_dict(), 7))
    jrnn.set_pallas_mode('force_interpret')
    try:
        config = tweak.CRNN.get_config(_port_config())
        assert config['rnn_bwd']['factory'] is trnn.TransformerEncoder
        assert config['rnn_bwd']['reverse'] is True
        tmodel = tweak.CRNN.from_config(config, device='cpu')
        bridge.load_flat(tmodel.module, jmodel.state_dict())
        yield jmodel, tmodel
    finally:
        jrnn.set_pallas_mode('auto')


def test_fbcrnn_inference_matches_jax(models, tmp_path):
    """Tagging, boundaries and SED (window 11) of the Transformer-head
    FBCRNN, in the port and from a JAX run directory whose config names
    the JAX package's ``TransformerEncoder``."""
    jmodel, tmodel = models
    assert not trnn.paired_heads(tmodel.module.rnn_fwd,
                                 tmodel.module.rnn_bwd)
    batch = _batches()[1]
    for method in ('tagging', 'boundaries_detection'):
        jy, jsl = getattr(jmodel, method)(batch)
        ty, tsl = getattr(tmodel, method)(batch)
        np.testing.assert_array_equal(tsl, jsl)
        _close(ty, jy)
    jy, jsl = jmodel.sound_event_detection(batch, 11, window_shift=1)
    ty, tsl = tmodel.sound_event_detection(batch, 11, window_shift=1)
    np.testing.assert_array_equal(tsl, jsl)
    _close(ty, jy)
    jmodel.save_checkpoint(
        tmp_path / 'checkpoints' / 'ckpt_best_macro_fscore_weak.pkl')
    config = jweak.CRNN.get_config(_model_config())
    dump_json({'trainer': {'model': config_to_json(config)}},
              tmp_path / '1' / 'config.json')
    port = tweak.CRNN.from_storage_dir(tmp_path, device='cpu')
    assert isinstance(port.module.rnn_bwd, trnn.TransformerEncoder)
    _close(port.tagging(batch)[0], jmodel.tagging(batch)[0])


def test_training_step_matches_jax(models):
    """Loss and every gradient of one training-mode step at dropout 0,
    under ``tests/test_torch_train.py``'s rule: the larger of
    ``1e-4 + 3.5e-2 * max|ref|`` and twice the JAX package's own
    Pallas-vs-XLA gap. Where the true gradient is not identically zero
    and the tensor has 16 or more entries, ``1 - cos`` to JAX's gradient
    is at most 0.01 or twice the JAX package's own (its two paths' cosine
    falls to 0.80-0.97 on the heads' biases and the 2-D tower's norms:
    the bf16 tower's noise meets the f32 attention). Identically zero:
    the norm-fed conv biases, the attention's key biases (a softmax does
    not see a key bias) and the last block's ``Dense_1.bias`` (it only
    shifts every frame before the output net's training-mode norm). The
    entry norm's two scalars are sums that cancel to ~1e-5 with no stable
    sign, as ``chip_smoke.py:_card_vs_cpu`` prints them only."""
    jmodel, tmodel = models
    last = RNN['num_layers'] - 1
    zero = BN_FED_BIASES | {
        f'{head}.block_{i}.MultiHeadDotProductAttention_0.key.bias'
        for head in ('rnn_fwd', 'rnn_bwd') for i in range(last + 1)} | {
        f'{head}.block_{last}.Dense_1.bias' for head in ('rnn_fwd',
                                                        'rnn_bwd')}
    batch = _train_batch(1)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads, _ = _jax_loss_and_grads(jmodel, jbatch, 'force_interpret')
    _, xla_grads, _ = _jax_loss_and_grads(jmodel, jbatch, 'off')
    jrnn.set_pallas_mode('force_interpret')
    module = tmodel.module
    module.train()
    try:
        loss, _ = tmodel.loss(tmodel.to_device(batch))
        loss.backward()
    finally:
        module.eval()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    assert any('block_1.MultiHeadDotProductAttention_0' in name
               for name, _ in module.named_parameters())
    for name, p in module.named_parameters():
        key = f'params.{name}'
        ref, got = jgrads[key], p.grad.numpy()
        gap = float(np.abs(got - ref).max())
        jax_gap = float(np.abs(xla_grads[key] - ref).max())
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()), 2 * jax_gap)
        assert gap <= bound, (name, gap, bound)
        if name not in zero and ref.size >= 16:
            cos, jax_cos = _cosine(got, ref), _cosine(xla_grads[key], ref)
            assert 1. - cos <= max(.01, 2. * (1. - jax_cos)), (name, cos,
                                                             jax_cos)
        p.grad = None


def test_forward_head_is_causal(models):
    """As the JAX package's ``test_transformer_fbcrnn`` checks it: a
    change to the last frames leaves the forward head's first frame as it
    was (and the backward head's last valid frame moves)."""
    _, tmodel = models
    batch = {k: v for k, v in _batches()[0].items() if k != 'example_id'}
    changed = dict(batch, audio_data=batch['audio_data'].copy())
    changed['audio_data'][:, -800:] += 1.
    y1 = [t.numpy() for t in tmodel._apply(batch, 'forward')[:2]]
    y2 = [t.numpy() for t in tmodel._apply(changed, 'forward')[:2]]
    np.testing.assert_allclose(y1[0][:, :, 0], y2[0][:, :, 0], atol=1e-5)
    assert np.abs(y1[1][:, :, -1] - y2[1][:, :, -1]).max() > 1e-4


def test_init_flat_draws_a_transformer_like_jax():
    """``init_flat`` on the reference-width Transformer-head FBCRNN
    (``fbcrnn_config('shallow')`` with both heads replaced by the head's
    own defaults: hidden 256, d_ff 1024, 6 layers, 8 heads): the JAX
    model's keys and shapes (``jax.eval_shape``), LayerNorm scales one and
    biases zero, zero attention biases (heads, head_dim), and the kernels
    at flax's scales: query / key / value (256, 8, 32) with fan_in 256
    (the contracted axis), the output (8, 32, 256) with 8 x 32, the dense
    layers with their input width."""
    from pb_sed_tpu.models.net_configs import fbcrnn_config as jax_config
    configs = []
    for make, cls in ((fbcrnn_config, trnn.TransformerEncoder),
                      (jax_config, jrnn.TransformerEncoder)):
        config = make('shallow', num_events=10)
        config['rnn_fwd'] = {'factory': cls}
        configs.append(config)
    tmodel = tweak.CRNN.from_config(tweak.CRNN.get_config(configs[0]),
                                    device='cpu')
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(configs[1]))
    batch = {'audio_data': jax.ShapeDtypeStruct((1, 16000), np.float32),
             'seq_len': jax.ShapeDtypeStruct((1,), np.int32)}
    tree = jax.eval_shape(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), batch)
    shapes = {jax.tree_util.keystr(path, simple=True, separator='.'):
              tuple(leaf.shape) for path, leaf in
              jax.tree_util.tree_flatten_with_path(dict(tree))[0]}
    assert tmodel.as_constructed()
    tmodel.init_parameters(seed=3)
    flat = tmodel.state_dict()
    assert {k: v.shape for k, v in flat.items()} == shapes
    head = 'params.rnn_bwd.block_5.'
    attn = head + 'MultiHeadDotProductAttention_0.'
    assert flat[attn + 'query.kernel'].shape == (256, 8, 32)
    for name in ('query', 'key', 'value', 'out'):
        assert not flat[f'{attn}{name}.bias'].any()
    np.testing.assert_array_equal(flat[head + 'LayerNorm_0.scale'], 1.)
    assert not flat[head + 'LayerNorm_0.bias'].any()
    for key, fan_in in ((attn + 'query.kernel', 256),
                        (attn + 'value.kernel', 256),
                        (attn + 'out.kernel', 256),
                        (head + 'Dense_0.kernel', 256),
                        (head + 'Dense_1.kernel', 1024),
                        ('params.rnn_fwd.in_proj.kernel', 256)):
        std = float(flat[key].std()) * np.sqrt(fan_in)
        assert abs(std - 1.) < .03, (key, std)
    # flax's own DenseGeneral draw for the query kernel, at its scale
    ref = jax.jit(lambda k: jax.nn.initializers.lecun_normal()(
        k, (256, 256)))(jax.random.PRNGKey(0))
    assert abs(float(np.std(ref)) * 16. - 1.) < .03
    # a stacked GRU bias (2, 1, 3H) starts at zero, as the JAX layer's
    assert not bridge.init_flat(
        {'params.layer_0_bi.b_ih': np.ones((2, 1, 48))}, 0)[
            'params.layer_0_bi.b_ih'].any()
