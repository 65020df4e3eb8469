"""The PyTorch port's serving slice against the JAX package: a tiny
weak-label FBCRNN (audio in, unequal lengths, ``use_pallas`` configs)
with the same seeded numpy weights carried across by the weight bridge.

The JAX side runs with its Pallas kernels in interpret mode, as its own
CPU tests run them; the port runs its kernels' plain versions (CPU
tensors). Tolerance everywhere: ``atol = 1e-4 + 3e-2 * max|ref|``, the
JAX package's own bound for bf16 paths that round at different points
(``tests/test_pallas_conv.py:885-888``): both sides quantize activations
and weights to bf16, but not always at the same op.
"""
import pickle

import jax
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import base as jbase
from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.utils.config import config_to_json
from pb_sed_tpu.utils.misc import dump_json
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base as tbase
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.models.net_configs import fbcrnn_config

torch.set_num_threads(2)

K = 10
CONFIG = {
    'feature_extractor': {
        'sample_rate': 16000, 'stft_size': 512, 'stft_shift': 160,
        'stft_window_length': 480, 'number_of_filters': 16,
    },
    'cnn': {
        'cnn_2d': {
            'out_channels': [16, 16, 32], 'kernel_size': 3,
            'pool_size': [1, [2, 1], [2, 1]],
            'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
            'pre_activation': True, 'use_pallas': True,
        },
        'cnn_1d': {'out_channels': [32, 32], 'kernel_size': [1, 3],
                   'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
                   'pre_activation': True},
    },
    'rnn_fwd': {
        'rnn': {'hidden_size': 32, 'num_layers': 2, 'use_pallas': True},
        'output_net': {'out_channels': [32, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
}
SAMPLES = 8000  # 0.5 s at 16 kHz -> 50 frames at shift 160


def _batches():
    rng = np.random.RandomState(3)
    lens = [np.array([50, 50], np.int32), np.array([50, 33], np.int32)]
    out = []
    for i, seq_len in enumerate(lens):
        audio = (.3 * rng.randn(2, SAMPLES)).astype(np.float32)
        audio[1, seq_len[1] * 160:] = 0.
        out.append({'audio_data': audio, 'seq_len': seq_len,
                    'example_id': [f'clip{i}a', f'clip{i}b']})
    return out


def _close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    atol = 1e-4 + 3e-2 * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


@pytest.fixture(scope='module')
def models():
    # the variable tree does not depend on the kernel mode: initialize
    # (jitted) on the XLA path, then apply with the kernels in interpret
    # mode
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(
        pickle.loads(pickle.dumps(CONFIG))))
    batch = {k: v for k, v in _batches()[0].items() if k != 'example_id'}
    jmodel.variables = jax.jit(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(batch)
    jmodel.load_state_dict(bridge.random_flat(jmodel.state_dict(), 7))
    jrnn.set_pallas_mode('force_interpret')
    try:
        tmodel = tweak.CRNN.from_config(tweak.CRNN.get_config(
            pickle.loads(pickle.dumps(CONFIG))), device='cpu')
        bridge.load_flat(tmodel.module, jmodel.state_dict())
        yield jmodel, tmodel
    finally:
        jrnn.set_pallas_mode('auto')


def test_heads_match_jax(models):
    jmodel, tmodel = models
    batch = _batches()[1]
    jy_fwd, jy_bwd, jsl, _, _ = jmodel._apply(batch)
    ty_fwd, ty_bwd, tsl, _, _ = tmodel._apply(batch, 'forward')
    np.testing.assert_array_equal(tsl.numpy(), np.asarray(jsl))
    _close(ty_fwd.numpy(), jy_fwd)
    _close(ty_bwd.numpy(), jy_bwd)


def test_inference_methods_match_jax(models):
    jmodel, tmodel = models
    batch = _batches()[1]
    for method in ('tagging', 'boundaries_detection'):
        jy, jsl = getattr(jmodel, method)(batch)
        ty, tsl = getattr(tmodel, method)(batch)
        np.testing.assert_array_equal(tsl, jsl)
        _close(ty, jy)
    # scalar window, and per-class window lengths (two unique lengths)
    for wl in (11, np.array([5, 11] * (K // 2))):
        jy, jsl = jmodel.sound_event_detection(batch, wl, window_shift=1)
        ty, tsl = tmodel.sound_event_detection(batch, wl, window_shift=1)
        np.testing.assert_array_equal(tsl, jsl)
        _close(ty, jy)


def test_inference_engine_matches_jax(models):
    jmodel, tmodel = models
    runs = [
        ('tagging', dict(medfilt_length=1)),
        ('boundaries_detection', dict(medfilt_length=3, stepfilt_length=4)),
        ('sound_event_detection', dict(
            medfilt_length=np.array([1, 3] * (K // 2)),
            model_kwargs={'window_length': 11, 'window_shift': 1})),
    ]
    for name, kwargs in runs:
        jscores = getattr(jbase, name)(
            [jmodel], _batches(), auto_stack=False, mesh=None, **kwargs)
        tscores = getattr(tbase, name)([tmodel], _batches(), **kwargs)
        assert sorted(tscores) == sorted(jscores)
        for clip in jscores:
            _close(tscores[clip], jscores[clip])
    # two members run in turn and average (identical members here)
    pair = tbase.tagging([tmodel, tmodel], _batches())
    single = tbase.tagging(tmodel, _batches())
    for clip in single:
        np.testing.assert_allclose(pair[clip], single[clip], rtol=1e-12)


def test_jax_checkpoint_serves_in_port(models, tmp_path):
    """A JAX training run directory (config.json naming the JAX classes,
    ``{'model': flat}`` checkpoint) restores into the port."""
    jmodel, _ = models
    jmodel.save_checkpoint(
        tmp_path / 'checkpoints' / 'ckpt_best_macro_fscore_weak.pkl')
    config = jweak.CRNN.get_config(pickle.loads(pickle.dumps(CONFIG)))
    dump_json({'trainer': {'model': config_to_json(config)}},
              tmp_path / '1' / 'config.json')
    port = tweak.CRNN.from_storage_dir(tmp_path, device='cpu')
    assert isinstance(port, tweak.CRNN)
    batch = _batches()[1]
    _close(port.tagging(batch)[0], jmodel.tagging(batch)[0])
    # and the port's state round-trips through the flat dict unchanged
    flat = bridge.export_flat(port.module)
    reference = jmodel.state_dict()
    assert sorted(flat) == sorted(reference)
    for key in flat:
        np.testing.assert_array_equal(flat[key], reference[key])
    flat.pop(next(iter(flat)))
    with pytest.raises(KeyError):
        bridge.load_flat(port.module, flat)


def test_jax_keys_are_the_ports(models):
    """Every flat key the JAX FBCRNN writes names a port tensor."""
    jmodel, tmodel = models
    assert sorted(bridge.export_flat(tmodel.module)) == sorted(
        jmodel.state_dict())
    assert jax.devices()[0].platform == 'cpu'


def test_unported_recipes_raise():
    """The deep recipe (residual skips, 3x3/1x1 towers, H = 512) builds at
    full width, and so do its bidirectional GRU heads, with the JAX
    module's flat keys and shapes (built abstractly with
    ``jax.eval_shape``). Dropout in training, which this test once showed
    to raise (the name is kept from then), now runs: the deep model's
    training forward with ``cnn_1d.dropout = .1`` gives other scores than
    its eval forward and than a training forward on other masks."""
    from pb_sed_tpu.models.net_configs import fbcrnn_config as jax_config
    deep = tweak.CRNN.from_config(tweak.CRNN.get_config(
        fbcrnn_config('deep', num_events=527)), device='cpu')
    module = deep.module
    assert module.cnn.cnn_2d.residuals[2] == 4
    assert module.rnn_fwd.rnn.hidden_size == 512
    assert module.rnn_bwd.output_net.conv_1.kernel.shape == (1, 512, 527)
    configs = [fbcrnn_config('deep', num_events=527),
               jax_config('deep', num_events=527)]
    for config in configs:
        config['rnn_fwd']['rnn']['bidirectional'] = True
    bidi = tweak.CRNN.from_config(tweak.CRNN.get_config(configs[0]),
                                  device='cpu')
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(configs[1]))
    batch = {'audio_data': jax.ShapeDtypeStruct((1, 16000), np.float32),
             'seq_len': jax.ShapeDtypeStruct((1,), np.int32)}
    tree = jax.eval_shape(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), batch)
    shapes = {jax.tree_util.keystr(path, simple=True, separator='.'):
              tuple(leaf.shape) for path, leaf in
              jax.tree_util.tree_flatten_with_path(dict(tree))[0]}
    assert {k: v.shape for k, v in bidi.state_dict().items()} == shapes
    assert shapes['params.rnn_bwd.rnn.layer_1_bi.w_ih'] == (2, 1024, 1536)
    assert shapes['params.rnn_fwd.output_net.conv_0.kernel'] == (1, 1024,
                                                                  512)
    from pb_sed_tpu_torch.ops.dropout import dropout_rng
    deep.init_parameters(0)
    module.cnn.cnn_1d.dropout = .1
    batch = deep.to_device({
        'audio_data': np.random.RandomState(0).randn(1, 16000).astype(
            np.float32),
        'seq_len': np.array([51], np.int32)})
    with torch.no_grad():
        y_eval = module(batch)[0]
        module.train()
        state = {k: v.clone() for k, v in module.state_dict().items()}
        y_train = []
        for seed in (0, 1):
            module.load_state_dict(state)
            with dropout_rng(torch.Generator().manual_seed(seed)):
                y_train.append(module(batch)[0])
    assert y_eval.shape == y_train[0].shape and y_eval.shape[:2] == (1, 527)
    assert torch.isfinite(y_train[0]).all()
    assert (y_train[0] - y_eval).abs().max() > 1e-4
    assert (y_train[0] - y_train[1]).abs().max() > 1e-4


def test_cnn_lift_channels_match_jax():
    """The CNN's lift with a positional channel and a broadcast condition
    (the strong-label recipe's tag conditioning) against the JAX CNN, on
    its XLA path."""
    from pb_sed_tpu.models.base.model import (flatten_variables,
                                              unflatten_variables)
    from pb_sed_tpu.ops import cnn as jcnn
    from pb_sed_tpu_torch.ops import cnn as tcnn
    towers = {
        'cnn_2d': {'out_channels': [16, 16], 'pool_size': [[2, 1], 1],
                   'pre_activation': True},
        'cnn_1d': {'out_channels': [16], 'kernel_size': 3,
                   'pre_activation': True},
    }
    rng = np.random.RandomState(9)
    x = rng.randn(2, 12, 8).astype(np.float32)
    seq_len = np.array([12, 7], np.int32)
    cond = rng.rand(2, 3).astype(np.float32)
    # towers passed as modules, as the config glue does (the checkpoint
    # names them cnn_2d / cnn_1d then)
    jmod = jcnn.CNN(cnn_2d=jcnn.CNN2d(**towers['cnn_2d']),
                    cnn_1d=jcnn.CNN1d(**towers['cnn_1d']), input_height=8,
                    positional_encoding=True, conditional_dims=3)
    variables = jmod.init(jax.random.PRNGKey(0), x, seq_len, cond)
    flat = bridge.random_flat(flatten_variables(variables), 11)
    ref, ref_len = jmod.apply(unflatten_variables(flat), x, seq_len, cond)
    port = tcnn.CNN(tcnn.CNN2d(**towers['cnn_2d']),
                    tcnn.CNN1d(**towers['cnn_1d']), input_height=8,
                    positional_encoding=True, conditional_dims=3)
    port.build(1)
    bridge.load_flat(port, flat)
    with torch.inference_mode():
        got, got_len = port(torch.from_numpy(x), torch.from_numpy(seq_len),
                            torch.from_numpy(cond))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    _close(got.numpy(), ref)


def test_single_head_matches_the_paired_forward_head(models):
    """Without a backward head the forward head runs alone (D=1 GRU
    scans) and gives the paired model's y_fwd."""
    _, tmodel = models
    config = pickle.loads(pickle.dumps(CONFIG))
    config['rnn_bwd'] = None
    single = tweak.CRNN.from_config(tweak.CRNN.get_config(config),
                                    device='cpu')
    flat = bridge.export_flat(tmodel.module)
    single.load_state_dict({k: v for k, v in flat.items()
                            if '.rnn_bwd.' not in k})
    batch = _batches()[1]
    y_fwd, y_bwd, *_ = single._apply(batch, 'forward')
    assert y_bwd is None
    ref = tmodel._apply(batch, 'forward')[0]
    # the same plain-version arithmetic on the same inputs
    torch.testing.assert_close(y_fwd, ref, rtol=0, atol=1e-6)
    y, _ = single.tagging(batch)
    assert y.shape == (2, K, 1)
