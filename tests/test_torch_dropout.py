"""The port's dropout against the JAX package's, with the same masks.

The port draws its masks from a ``torch.Generator`` and can record them
(``ops/dropout.py:dropout_rng(generator, record=True)``); the JAX side
takes those masks through a test-local shim of ``jax.random`` in
``flax.linen.stochastic`` and ``flax.linen.attention`` whose
``bernoulli`` returns the recorded masks in call order (the JAX
package's files stay as they are). So both packages drop the same units,
and any difference in where a mask acts shows. Covered: CNN2d in both
activation orders, CNN1d, StackedGRU between layers (unidirectional and
bidirectional), the Transformer block's attention (one (Tq, Tk) mask for
the batch and the heads) and feed-forward dropout. Also: the paired and
unpaired head lanes draw the same masks and give the same values, a
dropout-0 run draws the augmentation it drew before dropout existed,
eval output does not depend on ``p``, ``fuse_bn`` fuses nothing under
dropout, a dropout tower's eval output against the JAX package's
unpacked path, and checkpoints without the dropout generator's state
load.

The JAX side runs its Pallas kernels in interpret mode; the port runs
its kernels' plain versions (CPU tensors). Tolerances: the model's
``1e-4 + 3e-2 * max|ref|`` (``tests/test_torch_fbcrnn.py``) for the conv
towers, the GRU kernel's 5.3e-3 (``tests/test_torch_strong.py``), and
``1e-5 * max|ref|`` for the f32 Transformer block.
"""
import contextlib
import pickle

import flax.linen.attention
import flax.linen.stochastic
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models.base.model import flatten_variables
from pb_sed_tpu.ops import cnn as jcnn
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.ops import cnn as tcnn
from pb_sed_tpu_torch.ops import rnn as trnn
from pb_sed_tpu_torch.ops.dropout import dropout_rng
from pb_sed_tpu_torch.ops.kernels import conv as kconv
from pb_sed_tpu_torch.train.trainer import Trainer, dropout_seed
from tests.test_torch_fbcrnn import CONFIG, _close
from tests.test_torch_train import _train_batch

torch.set_num_threads(2)


class _RecordedBernoulli:
    """``jax.random`` with ``bernoulli`` handing out recorded masks."""

    def __init__(self, masks):
        self.masks = [np.asarray(m) for m in masks]

    def bernoulli(self, key, p=.5, shape=None):
        mask = self.masks.pop(0)
        assert tuple(shape) == mask.shape, (shape, mask.shape)
        return jnp.asarray(mask)

    def __getattr__(self, name):
        return getattr(jax.random, name)


@contextlib.contextmanager
def jax_masks(masks):
    """Run flax's dropout on ``masks`` (bool arrays, in call order); all
    must be used."""
    shim = _RecordedBernoulli(masks)
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(flax.linen.stochastic, 'random', shim)
        patch.setattr(flax.linen.attention, 'random', shim)
        yield
    assert not shim.masks, f'{len(shim.masks)} masks left unused'


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


def _weights(module, *args, seed=5):
    variables = module.init({'params': jax.random.PRNGKey(0)}, *args)
    return bridge.random_flat(flatten_variables(dict(variables)), seed)


def _tree(flat):
    from pb_sed_tpu.models.base.model import unflatten_variables
    return jax.tree_util.tree_map(jnp.asarray, unflatten_variables(flat))


def _port_train(module, flat, *args, seed=0):
    """The port module in training mode on ``flat``: (output, masks)."""
    bridge.load_flat(module, flat)
    module.train()
    generator = torch.Generator().manual_seed(seed)
    with dropout_rng(generator, record=True) as stream:
        out = module(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                       else a for a in args])
    return out, [m.numpy() for m in stream.masks]


def _jax_train(module, flat, masks, *args):
    with jax_masks(masks):
        out, _ = module.apply(_tree(flat), *[jnp.asarray(a) for a in args],
                              training=True,
                              rngs={'dropout': jax.random.PRNGKey(1)},
                              mutable=['batch_stats'])
    return out


def _tower_input(b=2, t=10, f=8, c=1, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, f, c).astype(np.float32),
            np.array([t, 6], np.int32))


TOWER = dict(out_channels=[16, 16, 32], kernel_size=3,
             pool_size=[1, (2, 1), (2, 1)], norm='batch',
             norm_kwargs={'eps': 1e-3})


@pytest.mark.parametrize('pre_activation', [True, False],
                         ids=['pre_activation', 'post_activation'])
def test_cnn2d_masks_act_where_jax_s_do(interpret_mode, pre_activation):
    x, seq_len = _tower_input()
    jtower = jcnn.CNN2d(**TOWER, pre_activation=pre_activation, dropout=.3,
                        use_pallas=True)
    flat = _weights(jtower, jnp.asarray(x), jnp.asarray(seq_len))
    tower = tcnn.CNN2d(**TOWER, pre_activation=pre_activation, dropout=.3,
                       in_channels=1)
    (got, _), masks = _port_train(tower, flat, x, seq_len)
    # before each conv (pre-activation) or after each norm (post)
    assert [m.shape for m in masks] == (
        [(2, 10, 8, 1), (2, 10, 8, 16), (2, 10, 4, 16)] if pre_activation
        else [(2, 10, 8, 16), (2, 10, 8, 16), (2, 10, 4, 32)])
    ref, _ = _jax_train(jtower, flat, masks, x, seq_len)
    _close(got.float().detach().numpy(), ref)


def test_cnn1d_masks_act_where_jax_s_do():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 10, 24).astype(np.float32)
    seq_len = np.array([10, 6], np.int32)
    kwargs = dict(out_channels=[16, 16, 16], kernel_size=[1, 3, 3],
                  norm='batch', pre_activation=True, dropout=.3,
                  residual_connections=[None, 2, None])
    jtower = jcnn.CNN1d(**kwargs)
    flat = _weights(jtower, jnp.asarray(x), jnp.asarray(seq_len))
    (got, _), masks = _port_train(tcnn.CNN1d(**kwargs, in_channels=24),
                                  flat, x, seq_len)
    assert [m.shape for m in masks] == [(2, 10, 24), (2, 10, 16),
                                        (2, 10, 16)]
    ref, _ = _jax_train(jtower, flat, masks, x, seq_len)
    _close(got.detach().numpy(), ref)


@pytest.mark.parametrize('bidirectional', [False, True],
                         ids=['unidirectional', 'bidirectional'])
def test_stacked_gru_masks_act_between_layers(interpret_mode, bidirectional):
    rng = np.random.RandomState(2)
    x = rng.randn(2, 9, 12).astype(np.float32)
    seq_len = np.array([9, 5], np.int32)
    jgru = jrnn.StackedGRU(16, num_layers=3, dropout=.3,
                           bidirectional=bidirectional, use_pallas=True,
                           input_size=12)
    flat = _weights(jgru, jnp.asarray(x), jnp.asarray(seq_len))
    gru = trnn.StackedGRU(16, num_layers=3, dropout=.3,
                          bidirectional=bidirectional, input_size=12)
    got, masks = _port_train(gru, flat, x, torch.from_numpy(seq_len))
    width = 32 if bidirectional else 16
    assert [m.shape for m in masks] == [(2, 9, width)] * 2
    with jax_masks(masks):
        ref = jgru.apply(_tree(flat), jnp.asarray(x), jnp.asarray(seq_len),
                         training=True,
                         rngs={'dropout': jax.random.PRNGKey(1)})
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=5.3e-3)


def _causal_mask(seq_len, t):
    pos = np.arange(t)
    return ((pos[None, :] <= pos[:, None])[None, None]
            & (pos[None, :] < seq_len[:, None])[:, None, None, :])


def test_transformer_block_masks_act_where_jax_s_do():
    """Attention dropout on the softmax weights with one (1, 1, Tq, Tk)
    mask for the batch and the heads, then the feed-forward dropout, in
    that order."""
    rng = np.random.RandomState(3)
    x = rng.randn(3, 11, 16).astype(np.float32)
    mask = _causal_mask(np.array([11, 7, 2]), 11)
    jblock = jrnn._TransformerBlock(16, 32, 2, .3)
    flat = _weights(jblock, jnp.asarray(x), jnp.asarray(mask))
    got, masks = _port_train(trnn._TransformerBlock(16, 32, 2, .3), flat,
                             x, torch.from_numpy(mask))
    assert [m.shape for m in masks] == [(1, 1, 11, 11), (3, 11, 32)]
    with jax_masks(masks):
        ref = jblock.apply(_tree(flat), jnp.asarray(x), jnp.asarray(mask),
                           training=True,
                           rngs={'dropout': jax.random.PRNGKey(1)})
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))


def _dropout_config(p=.3, heads_p=None):
    config = pickle.loads(pickle.dumps(CONFIG))
    config['cnn']['cnn_2d']['dropout'] = p
    config['cnn']['cnn_1d']['dropout'] = p
    config['rnn_fwd']['rnn']['num_layers'] = 3
    config['rnn_fwd']['rnn']['dropout'] = p if heads_p is None else heads_p
    return config


def _port_model(config, seed=7):
    model = tweak.CRNN.from_config(tweak.CRNN.get_config(config),
                                   device='cpu')
    model.load_state_dict(bridge.random_flat(model.state_dict(), seed))
    return model


def test_paired_and_unpaired_head_lanes_are_equal():
    """From one generator state, the paired lane (one D = 2 recurrence a
    layer) draws the heads' inter-layer masks in the unpaired lane's order
    and gives the same values."""
    model = _port_model(_dropout_config())
    module = model.module
    module.train()
    h = torch.from_numpy(np.random.RandomState(4).randn(2, 13, 32)
                         .astype(np.float32))
    seq_len = torch.tensor([13, 8], dtype=torch.int32)
    assert trnn.paired_heads(module.rnn_fwd, module.rnn_bwd)
    with dropout_rng(torch.Generator().manual_seed(9), record=True) as s1:
        paired = trnn.paired_gru_apply(module.rnn_fwd, module.rnn_bwd, h,
                                       seq_len)
    with dropout_rng(torch.Generator().manual_seed(9), record=True) as s2:
        unpaired = (module.rnn_fwd(h, seq_len)[0],
                    module.rnn_bwd(h, seq_len)[0])
    assert len(s1.masks) == len(s2.masks) == 4
    for a, b in zip(s1.masks, s2.masks):
        assert torch.equal(a, b)
    np.testing.assert_allclose(paired[0].detach().numpy(),
                               unpaired[0].detach().numpy(), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(paired[1].detach().numpy(),
                               unpaired[1].detach().numpy(), rtol=0,
                               atol=1e-6)


def test_dropout_zero_draws_the_augmentation_of_before():
    """A Trainer step of a model without dropout draws its augmentation
    from the generator seeded with ``seed``, as before dropout existed
    (the loss of ``model.loss(batch, Generator().manual_seed(seed))`` in
    every bit), and leaves the dropout generator at its seed's state."""
    config = pickle.loads(pickle.dumps(CONFIG))
    config['feature_extractor'].update(
        n_time_masks=1, n_frequency_masks=1, max_noise_scale=.2)
    batch = _train_batch(1)
    ref_model = _port_model(config)
    ref_model.module.train()
    generator = torch.Generator().manual_seed(3)
    ref_loss, _ = ref_model.loss(ref_model.to_device(batch), generator)
    trainer = Trainer(_port_model(config), seed=3)
    loss = trainer.train_step(batch)
    assert float(loss) == float(ref_loss.detach())
    assert torch.equal(trainer.generator.get_state(), generator.get_state())
    seeded = torch.Generator().manual_seed(dropout_seed(3))
    assert torch.equal(trainer.dropout_generator.get_state(),
                       seeded.get_state())
    assert dropout_seed(3) != 3


def test_eval_output_does_not_depend_on_p():
    batch = {k: v for k, v in _train_batch(2).items()
             if k in ('audio_data', 'seq_len')}
    plain = _port_model(_dropout_config(p=0.))
    dropped = _port_model(_dropout_config(p=.4))
    for a, b in zip(plain._apply(batch, 'forward')[:2],
                    dropped._apply(batch, 'forward')[:2]):
        assert torch.equal(a, b)


def test_fuse_bn_fuses_no_layer_under_dropout(monkeypatch):
    """With dropout, ``fuse_bn`` fuses nothing (the JAX tower refuses its
    packed plan): the training forward never reaches the fused conv and
    equals the unfused tower's on the same masks."""
    x, seq_len = _tower_input()
    kwargs = dict(TOWER, pre_activation=True, in_channels=1)
    assert tcnn.CNN2d(**kwargs, fuse_bn=True).fused == {1, 2}
    fused = tcnn.CNN2d(**kwargs, fuse_bn=True, dropout=.2)
    assert not fused.fuse_bn and fused.fused == frozenset()

    def refuse(*args):
        raise AssertionError('the fused conv ran under dropout')

    monkeypatch.setattr(kconv.BnReluConv2dSame, 'apply', refuse)
    flat = bridge.random_flat(bridge.export_flat(fused), 5)
    (got, _), _ = _port_train(fused, flat, x, seq_len)
    (ref, _), _ = _port_train(tcnn.CNN2d(**kwargs, dropout=.2), flat, x,
                              seq_len)
    assert torch.equal(got, ref)


def test_eval_tower_with_dropout_against_jax_s_unpacked_path(
        interpret_mode):
    """With dropout > 0 the JAX tower takes its unpacked path in eval too:
    3x3 convs on the same Pallas kernel, 1x1 convs with the bias added in
    bf16, residual sums and pools in f32. The port keeps the packed path's
    rounding points (``ROADMAP.md`` §3). On a tower with a 1x1 layer and a
    residual skip across a pool the two agree within the model tolerance
    (the gap printed beside the JAX package's own gap between its
    dropout-0 packed and dropout > 0 unpacked paths)."""
    x, seq_len = _tower_input(c=1, f=8)
    kwargs = dict(out_channels=[16, 16, 32, 32], kernel_size=[3, 3, 1, 3],
                  pool_size=[1, (2, 1), 1, (2, 1)],
                  residual_connections=[2, None, None, None], norm='batch',
                  norm_kwargs={'eps': 1e-3}, pre_activation=True)
    jtower = jcnn.CNN2d(**kwargs, dropout=.2, use_pallas=True)
    flat = _weights(jtower, jnp.asarray(x), jnp.asarray(seq_len))
    ref, _ = jtower.apply(_tree(flat), jnp.asarray(x), jnp.asarray(seq_len))
    packed, _ = jcnn.CNN2d(**kwargs, use_pallas=True).apply(
        _tree(flat), jnp.asarray(x), jnp.asarray(seq_len))
    tower = tcnn.CNN2d(**kwargs, dropout=.2, in_channels=1)
    bridge.load_flat(tower, flat)
    got, _ = tower(torch.from_numpy(x), torch.from_numpy(seq_len))
    got = got.float().detach().numpy()
    ref = np.asarray(ref)
    print(f'port vs JAX unpacked: {np.abs(got - ref).max():.3e}; JAX '
          f'packed vs unpacked: {np.abs(np.asarray(packed) - ref).max():.3e}'
          f'; max|ref| {np.abs(ref).max():.3e}')
    _close(got, ref)


def test_checkpoints_without_the_dropout_state_load(tmp_path):
    """A checkpoint keeps the dropout generator's state (``dropout_rng``)
    and restores it; one without the key (written before dropout was
    ported, or by the JAX trainer) loads and leaves the generator at its
    seed's state."""
    import pickle as pkl
    config = _dropout_config(p=.2)
    trainer = Trainer(_port_model(config), storage_dir=tmp_path,
                      stop_trigger=(1, 'iteration'), seed=2)
    trainer.train([_train_batch(1)])
    path = tmp_path / 'checkpoints' / 'ckpt_latest.pkl'
    payload = pkl.loads(path.read_bytes())
    assert torch.equal(torch.from_numpy(payload['dropout_rng']),
                       trainer.dropout_generator.get_state())
    seeded = torch.Generator().manual_seed(dropout_seed(2)).get_state()
    assert not torch.equal(trainer.dropout_generator.get_state(), seeded)
    resumed = Trainer(_port_model(config), storage_dir=tmp_path, seed=2)
    assert resumed.load_latest_checkpoint()
    assert torch.equal(resumed.dropout_generator.get_state(),
                       trainer.dropout_generator.get_state())
    del payload['dropout_rng']
    path.write_bytes(pkl.dumps(payload))
    old = Trainer(_port_model(config), storage_dir=tmp_path, seed=2)
    assert old.load_latest_checkpoint() and old.iteration == 1
    assert torch.equal(old.dropout_generator.get_state(), seeded)
