"""The port's strong-label side against the JAX package: the bidirectional
GRU (``StackedGRU(bidirectional=True)``) and a tiny BiCRNN, plain and
tag-conditioned (16 mels, 16-wide towers, H = 16, two bidirectional
layers), with the same seeded numpy weights carried across by the weight
bridge and clips of unequal lengths; the weights a from-scratch run
starts from (``bridge.init_flat``); the full-width recipe's config and
flat keys.

The JAX side runs its Pallas kernels in interpret mode, as its own CPU
tests run them, or its XLA scan path; the port runs its kernels' plain
versions (CPU tensors). Tolerances: the GRU's 5.3e-3 (outputs) and
``5.3e-3 * max|ref|`` (gradients), the TPU kernel's measured drift
against the f32 scan (``tests/test_torch_gru.py``); the model's
``1e-4 + 3e-2 * max|ref|`` (``tests/test_torch_fbcrnn.py``) and the
gradient rule of ``tests/test_torch_train.py``.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import strong_label as jstrong
from pb_sed_tpu.models.base.model import flatten_variables
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import base as tbase
from pb_sed_tpu_torch.models import strong_label as tstrong
from pb_sed_tpu_torch.ops import rnn as trnn
from pb_sed_tpu_torch.ops.kernels import build

torch.set_num_threads(2)

K = 5
T = 50        # frames of a 0.5 s clip at shift 160
SAMPLES = 8000
CONFIG = {
    'feature_extractor': {
        'sample_rate': 16000, 'stft_size': 512, 'stft_shift': 160,
        'stft_window_length': 480, 'number_of_filters': 16,
    },
    'cnn': {
        'cnn_2d': {
            'out_channels': [16, 16, 16], 'kernel_size': 3,
            'pool_size': [1, [2, 1], [2, 1]],
            'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
            'pre_activation': True, 'use_pallas': True,
        },
        'cnn_1d': {'out_channels': [16, 16], 'kernel_size': [1, 3],
                   'norm': 'batch', 'norm_kwargs': {'eps': 1e-3},
                   'pre_activation': True},
    },
    'rnn': {
        'rnn': {'hidden_size': 16, 'num_layers': 2, 'bidirectional': True,
                'use_pallas': True},
        'output_net': {'out_channels': [16, K], 'kernel_size': 1,
                       'norm': 'batch', 'norm_kwargs': {'eps': 1e-3}},
    },
    'labelwise_metrics': ('fscore_strong',),
}
# conv biases that feed a training-mode batch norm (identically zero
# gradient in exact arithmetic)
BN_FED_BIASES = {
    'cnn.cnn_2d.conv_0.bias', 'cnn.cnn_2d.conv_1.bias',
    'cnn.cnn_2d.conv_2.bias', 'cnn.cnn_1d.conv_0.bias',
    'rnn.output_net.conv_0.bias',
}


def _close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    atol = 1e-4 + 3e-2 * float(np.max(np.abs(ref)))
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0)


def _cosine(a, b):
    a = np.ravel(a).astype(np.float64)
    b = np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.fixture
def pallas_mode():
    yield jrnn.set_pallas_mode
    jrnn.set_pallas_mode('auto')


# -- the bidirectional GRU ---------------------------------------------------

@pytest.mark.parametrize('mode', ['off', 'force_interpret'])
@pytest.mark.parametrize('num_layers', [1, 2])
def test_bidirectional_gru_matches_jax(num_layers, mode, pallas_mode):
    """``StackedGRU(bidirectional=True)`` with sequences well below T
    against the JAX one on its XLA scan path (``off``) and with its Pallas
    kernel in interpret mode: the outputs at every frame within 5.3e-3,
    and dx, dw_ih, dw_hh, db_ih, db_hh within 5.3e-3 * max|ref| of each.
    The XLA scan closes over a bf16 ``w_hh`` and so sums its ``dw_hh``
    over the steps in bf16, where the kernel (and the port) sum in f32:
    against that reference a gradient is held to the larger of the bound
    and twice the JAX package's own scan-vs-kernel gap on the same tensor
    (the rule of ``tests/test_torch_train.py``)."""
    b, t, f, h = 3, 23, 12, 16
    rng = np.random.RandomState(num_layers)
    x = rng.randn(b, t, f).astype(np.float32)
    seq_len = np.array([t, 11, 5], np.int32)
    g = rng.randn(b, t, 2 * h).astype(np.float32)
    jgru = jrnn.StackedGRU(h, num_layers=num_layers, bidirectional=True,
                           use_pallas=True)
    shapes = jax.eval_shape(jgru.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(seq_len))
    flat = bridge.random_flat(flatten_variables(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape), shapes)), 3)
    tgru = trnn.StackedGRU(h, num_layers=num_layers, bidirectional=True,
                           input_size=f)
    assert sorted(bridge.export_flat(tgru)) == sorted(flat)
    assert flat['params.layer_0_bi.w_ih'].shape == (2, f, 3 * h)
    assert flat['params.layer_0_bi.b_hh'].shape == (2, 1, 3 * h)
    if num_layers == 2:
        assert flat['params.layer_1_bi.w_ih'].shape == (2, 2 * h, 3 * h)
    bridge.load_flat(tgru, flat)
    jparams = {k[len('params.'):]: jnp.asarray(v) for k, v in flat.items()}

    def jax_vjp(jax_mode):
        pallas_mode(jax_mode)

        def apply(p, xx):
            tree = {}
            for key, value in p.items():
                layer, name = key.split('.')
                tree.setdefault(layer, {})[name] = value
            return jgru.apply({'params': tree}, xx, jnp.asarray(seq_len))

        y_ref, vjp = jax.vjp(apply, jparams, jnp.asarray(x))
        dparams, dx_ref = vjp(jnp.asarray(g))
        return y_ref, dict(dparams, x=dx_ref)

    y_ref, refs = jax_vjp(mode)
    gaps = {}
    if mode == 'off':
        _, kernel = jax_vjp('force_interpret')
        gaps = {k: float(np.abs(np.asarray(kernel[k]) - np.asarray(v)).max())
                for k, v in refs.items()}

    xt = torch.from_numpy(x).requires_grad_()
    build.reset_launches()
    y = tgru(xt, torch.from_numpy(seq_len))
    assert y.shape == (b, t, 2 * h)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref),
                               atol=5.3e-3, rtol=0)
    y.backward(torch.from_numpy(g))
    assert build.LAUNCHES['gru_scan'] == build.LAUNCHES['gru_scan_bwd'] == 0
    grads = dict(tgru.named_parameters(), x=xt)
    assert sorted(grads) == sorted(refs) and len(refs) == 1 + 4 * num_layers
    for name, tensor in grads.items():
        ref = np.asarray(refs[name], np.float32)
        bound = max(5.3e-3 * float(np.abs(ref).max()),
                    2 * gaps.get(name, 0.))
        np.testing.assert_allclose(tensor.grad.numpy(), ref, rtol=0,
                                   atol=bound, err_msg=name)


def test_backward_direction_never_sees_padding():
    """The backward direction's output at the valid frames of a clip does
    not depend on what its padding holds."""
    gru = trnn.StackedGRU(8, num_layers=2, bidirectional=True, input_size=6)
    bridge.load_flat(gru, bridge.random_flat(bridge.export_flat(gru), 1))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 15, 6).astype(np.float32))
    seq_len = torch.tensor([15, 6], dtype=torch.int32)
    noisy = x.clone()
    noisy[1, 6:] = 100. * torch.randn(9, 6)
    with torch.no_grad():
        a, b = gru(x, seq_len), gru(noisy, seq_len)
    assert torch.equal(a[1, :6], b[1, :6])
    assert not torch.equal(a[1, 6:], b[1, 6:])


# -- the BiCRNN --------------------------------------------------------------

def _config(tag_conditioning, **updates):
    config = pickle.loads(pickle.dumps(CONFIG))
    config['tag_conditioning'] = tag_conditioning
    config.update(updates)
    return config


def _batch(seed, tag_conditioning=True):
    """Three clips of 50, 31 and 17 frames (zeroed tails); strong targets
    with soft (.5) frames in the second and third clip, the first fully
    labelled; 0/1 tags as the condition."""
    rng = np.random.RandomState(seed)
    audio = (.3 * rng.randn(3, SAMPLES)).astype(np.float32)
    seq_len = np.array([T, 31, 17], np.int32)
    for i, sl in enumerate(seq_len):
        audio[i, sl * 160:] = 0.
    strong = (rng.rand(3, K, T) > .6).astype(np.float32)
    strong[1, 2, 5:12] = .5
    strong[2, :, :3] = .5
    batch = {'audio_data': audio, 'seq_len': seq_len,
             'strong_targets': strong,
             'example_id': ['clip0', 'clip1', 'clip2']}
    if tag_conditioning:
        batch['tag_condition'] = (rng.rand(3, K) > .5).astype(np.float32)
    return batch


def _arrays(batch):
    return {k: v for k, v in batch.items() if k != 'example_id'}


def _jax_shapes(cond):
    """The JAX BiCRNN's flat keys with zero arrays of their shapes
    (built abstractly with ``jax.eval_shape``)."""
    jmodel = jstrong.CRNN.from_config(jstrong.CRNN.get_config(_config(cond)))
    batch = {k: jnp.asarray(v) for k, v in _arrays(_batch(0, cond)).items()}
    tree = jax.eval_shape(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), batch)
    return flatten_variables(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), dict(tree)))


@pytest.fixture(scope='module')
def flats():
    """Seeded weights of both BiCRNNs in the flat layout (the JAX
    models' keys)."""
    return {cond: bridge.random_flat(_jax_shapes(cond), 7)
            for cond in (False, True)}


def _jax_model(flat, cond, **updates):
    model = jstrong.CRNN.from_config(jstrong.CRNN.get_config(
        _config(cond, **updates)))
    model.variables = jax.tree_util.tree_map(
        jnp.asarray, _unflatten(flat))
    return model


def _unflatten(flat):
    from pb_sed_tpu.models.base.model import unflatten_variables
    return unflatten_variables(flat)


def _port_model(flat, cond, **updates):
    model = tstrong.CRNN.from_config(tstrong.CRNN.get_config(
        _config(cond, **updates)), device='cpu')
    bridge.load_flat(model.module, flat)
    return model


@pytest.mark.parametrize('cond', [False, True], ids=['plain', 'conditioned'])
def test_bicrnn_keys_and_config_match_jax(flats, cond):
    tmodel = _port_model(flats[cond], cond)
    assert sorted(tmodel.state_dict()) == sorted(flats[cond])
    w_ih = flats[cond]['params.rnn.rnn.layer_0_bi.w_ih']
    assert w_ih.shape == (2, 16 + cond * K, 48)
    kernel = flats[cond]['params.cnn.cnn_2d.conv_0.kernel']
    assert kernel.shape == (3, 3, 1 + cond * K, 16)


@pytest.mark.parametrize('cond', [False, True], ids=['plain', 'conditioned'])
def test_bicrnn_inference_matches_jax(flats, cond, pallas_mode):
    """``tagging`` (max over the valid frames) and SED (masked frame
    scores) of three clips of unequal lengths, and the inference engine's
    SED with per-class median filters and a tag mask; the JAX side on its
    XLA path (the loss test below holds the forward against its Pallas
    kernels)."""
    pallas_mode('off')
    jmodel = _jax_model(flats[cond], cond)
    tmodel = _port_model(flats[cond], cond)
    batch = _batch(1, cond)
    for method in ('tagging', 'sound_event_detection',
                   'boundaries_detection'):
        jy, jsl = getattr(jmodel, method)(_arrays(batch))
        ty, tsl = getattr(tmodel, method)(batch)
        np.testing.assert_array_equal(tsl, jsl)
        _close(ty, jy)
        if method == 'tagging':
            assert ty.shape == (3, K, 1)
        else:
            assert ty.shape == (3, K, T) and not ty[2, :, 17:].any()
    tags = {c: (np.arange(K) % 2).astype(bool) for c in batch['example_id']}
    kwargs = dict(medfilt_length=np.array([1, 3, 5, 3, 1]),
                  apply_mask=np.array([True, False, True, True, False]),
                  masks=tags)
    from pb_sed_tpu.models import base as jbase
    jscores = jbase.sound_event_detection(
        [jmodel], [batch], auto_stack=False, mesh=None, **kwargs)
    tscores = tbase.sound_event_detection([tmodel], [batch], **kwargs)
    assert sorted(tscores) == sorted(jscores)
    for clip in jscores:
        _close(tscores[clip], jscores[clip])


def _jax_loss_and_grads(model, batch, mode):
    jrnn.set_pallas_mode(mode)
    variables = model.variables

    def loss_of(params):
        vs = dict(variables)
        vs['params'] = params
        return model.loss_fn(vs, batch, {}, training=True)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables['params'])
    return float(loss), aux, flatten_variables({'params': grads})


def _bicrnn_gradient_rule(tmodel, jgrads, xla_grads):
    """Every parameter's gradient within ``1e-4 + 3.5e-2 * max|ref|`` or
    three times the JAX package's own Pallas-vs-XLA gap on the same
    tensor, and, where the true gradient is not identically zero,
    ``1 - cos`` with JAX's within 0.01 or three times the JAX package's
    own ``1 - cos`` between its two paths. The rule of
    ``tests/test_torch_train.py`` with the factor of ``chip_smoke.py``'s
    card-vs-CPU check (three times the reference's own noise) in place of
    two: two bidirectional layers carry the bf16 rounding flips of their
    four recurrences into every gradient, so that the scores of the JAX
    package's two paths differ by 9.4e-3 and the port's lie 6.3e-3 and
    1.1e-2 from them (the plain model), and the two JAX paths' cosine on
    a bidirectional layer's biases is 0.991."""
    for name, p in tmodel.module.named_parameters():
        key = f'params.{name}'
        ref, xla, got = jgrads[key], xla_grads[key], p.grad.numpy()
        gap = float(np.abs(got - ref).max())
        jax_gap = float(np.abs(xla - ref).max())
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()), 3 * jax_gap)
        assert gap <= bound, (name, gap, bound)
        if name not in BN_FED_BIASES:
            miss = 1. - _cosine(got, ref)
            assert miss <= max(.01, 3 * (1. - _cosine(xla, ref))), (name,
                                                                   miss)


@pytest.mark.parametrize('cond', [False, True], ids=['plain', 'conditioned'])
def test_bicrnn_loss_buffers_and_gradients_match_jax(flats, cond,
                                                     pallas_mode):
    """The training loss (soft frames masked out of the sum and the
    count), its scalars, the review buffers (the frame scores of the one
    fully labelled clip) and every parameter's gradient
    (:func:`_bicrnn_gradient_rule`)."""
    batch = _arrays(_batch(2, cond))
    jmodel = _jax_model(flats[cond], cond)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jaux, jgrads = _jax_loss_and_grads(jmodel, jbatch,
                                              'force_interpret')
    _, _, xla_grads = _jax_loss_and_grads(jmodel, jbatch, 'off')
    tmodel = _port_model(flats[cond], cond)
    tmodel.module.train()
    loss, aux = tmodel.loss(tmodel.to_device(batch))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    for key, value in aux['scalars'].items():
        np.testing.assert_allclose(float(value), float(jaux[1][key]),
                                   rtol=1e-6)
    got = tmodel.review_from_aux(loss, aux)['buffers']
    ref = jmodel.review_from_aux(jloss, jaux)['buffers']
    assert ref['y_strong'].shape == (T, K)
    for key in ('y_strong', 'targets_strong'):
        _close(got[key], ref[key])
    _bicrnn_gradient_rule(tmodel, jgrads, xla_grads)


def test_bicrnn_segment_pooled_review_matches_jax(flats, pallas_mode):
    """``eval_segment_length`` 4: the review buffers hold the scores and
    targets max-pooled over blocks of 4 frames (12 of the 50), soft
    targets included, for the valid segments of the fully labelled
    clip; the JAX side on its XLA path (forward only)."""
    pallas_mode('off')
    batch = _arrays(_batch(2))
    jmodel = _jax_model(flats[True], True, eval_segment_length=4)
    loss_fn = jax.jit(lambda v, b: jmodel.loss_fn(v, b, {}, training=True))
    jloss, jaux = loss_fn(jmodel.variables,
                          {k: jnp.asarray(v) for k, v in batch.items()})
    tmodel = _port_model(flats[True], True, eval_segment_length=4)
    tmodel.module.train()
    with torch.no_grad():
        loss, aux = tmodel.loss(tmodel.to_device(batch))
    got = tmodel.review_from_aux(loss, aux)['buffers']
    ref = jmodel.review_from_aux(jloss, jaux)['buffers']
    assert ref['y_strong'].shape == (T // 4, K)
    assert {float(v) for v in np.unique(ref['targets_strong'])} <= {0., 1.}
    for key in ('y_strong', 'targets_strong'):
        _close(got[key], ref[key])
    np.testing.assert_array_equal(
        aux['buffers']['segment_mask'].numpy(),
        np.asarray(jaux[2]['segment_mask']))


def test_soft_targets_and_padding_leave_the_loss():
    """Frames whose target is soft (.5 from pseudo-labels, or .6) and
    padded frames add nothing to the loss's sum or its count: moving
    them leaves the loss unchanged in every bit. The loss is the BCE of
    the scores clipped to [1e-7, 1 - 1e-7] over the certain valid
    entries, divided by their count."""
    model = tstrong.CRNN.from_config(tstrong.CRNN.get_config(
        _config(True)), device='cpu')
    model.init_parameters(0)
    model.module.train()
    batch = model.to_device(_arrays(_batch(3)))
    t = batch['strong_targets']
    soft = (t > .01) & (t < .99)
    assert soft.any()
    loss, aux = model.loss(batch)
    moved = t.clone()
    moved[soft] = .6
    moved[2, :, 17:] = 1. - moved[2, :, 17:]          # clip 2's padding
    again, _ = model.loss(dict(batch, strong_targets=moved))
    assert torch.equal(loss, again)
    y = model.module(batch)[0].detach().double()
    valid = (torch.arange(T)[None, :] < batch['seq_len'][:, None])
    mask = (~soft & valid[:, None]).double()
    yc = y.clamp(1e-7, 1 - 1e-7)
    bce = -(t * yc.log() + (1 - t) * (1 - yc).log()) * mask
    assert float(loss) == pytest.approx(float(bce.sum() / mask.sum()),
                                        rel=1e-5)
    assert float(aux['scalars']['strong_label_rate']) == pytest.approx(
        float(mask.mean()))


# -- from-scratch weights, the full-width config -----------------------------

def test_init_flat_builds_a_bicrnn_like_jax():
    """``init_flat`` on the tag-conditioned BiCRNN: the JAX model's keys
    and shapes, per-direction orthonormal rows of each stacked ``w_hh (2,
    H, 3H)`` (the two directions drawn apart), as the JAX layers'
    initializer gives them, and ``w_ih (2, F, 3H)`` at the scale of flax's
    ``lecun_normal`` on that shape (fan_in = 2F)."""
    jflat = _jax_shapes(True)
    tmodel = tstrong.CRNN.from_config(tstrong.CRNN.get_config(
        _config(True)), device='cpu')
    assert tmodel.as_constructed()
    tmodel.init_parameters(seed=4)
    flat = tmodel.state_dict()
    assert {k: v.shape for k, v in flat.items()} == {
        k: np.shape(v) for k, v in jflat.items()}
    # the JAX layers' own initializer: one orthonormal (H, 3H) a direction
    jgru = jrnn.StackedGRU(16, num_layers=2, bidirectional=True)
    jinit = flatten_variables(jax.jit(jgru.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 19)),
        jnp.array([3], jnp.int32)))
    for layer in (0, 1):
        w = flat[f'params.rnn.rnn.layer_{layer}_bi.w_hh']
        ref = np.asarray(jinit[f'params.layer_{layer}_bi.w_hh'])
        assert w.shape == ref.shape == (2, 16, 48)
        for d in range(2):
            np.testing.assert_allclose(w[d] @ w[d].T, np.eye(16), atol=1e-5)
            np.testing.assert_allclose(ref[d] @ ref[d].T, np.eye(16),
                                       atol=1e-5)
        assert np.abs(w[0] - w[1]).max() > .1
    # lecun_normal on a stacked (2, F, 3H): the std is 1 / sqrt(2F)
    shape = (2, 64, 96)
    ref = np.asarray(jax.nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), shape))
    got = bridge.init_flat({'params.w_ih': np.zeros(shape)}, 0)[
        'params.w_ih']
    for sample in (ref, got):
        assert abs(sample.std() * np.sqrt(2 * 64) - 1.) < .03
    assert abs(got.std() / ref.std() - 1.) < .03


def test_full_width_config_and_keys_match_jax():
    """``get_config(bicrnn_config('shallow', tag_conditioning=True))`` of
    both packages, key by key once the factories' package is set aside
    (the user's ``num_layers`` 2 wins over the glue's 1; ``input_size``
    256 + 10), and the JAX model's flat keys and shapes (built abstractly
    with ``jax.eval_shape``) are the port's."""
    from pb_sed_tpu.models.net_configs import bicrnn_config as jax_config
    from pb_sed_tpu.utils.config import config_to_json as jax_to_json
    from pb_sed_tpu_torch.models.net_configs import bicrnn_config
    from pb_sed_tpu_torch.utils.config import config_to_json
    got = config_to_json(tstrong.CRNN.get_config(
        bicrnn_config('shallow', tag_conditioning=True)))
    ref = jax_to_json(jstrong.CRNN.get_config(
        jax_config('shallow', tag_conditioning=True)))

    def ported(node):
        if isinstance(node, dict):
            return {k: ported(v) for k, v in node.items()}
        if isinstance(node, list):
            return [ported(v) for v in node]
        if isinstance(node, str) and node.startswith('pb_sed_tpu.'):
            return 'pb_sed_tpu_torch.' + node[len('pb_sed_tpu.'):]
        return node

    assert got == ported(ref)
    rnn = got['rnn']['rnn']
    assert (rnn['num_layers'], rnn['input_size'], rnn['bidirectional']) == (
        2, 266, True)
    assert got['cnn']['conditional_dims'] == 10
    jmodel = jstrong.CRNN.from_config(jstrong.CRNN.get_config(
        jax_config('shallow', tag_conditioning=True)))
    batch = {'audio_data': jax.ShapeDtypeStruct((1, 16000), jnp.float32),
             'seq_len': jax.ShapeDtypeStruct((1,), jnp.int32),
             'tag_condition': jax.ShapeDtypeStruct((1, 10), jnp.float32)}
    tree = jax.eval_shape(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False), batch)
    shapes = {jax.tree_util.keystr(path, simple=True, separator='.'):
              tuple(leaf.shape) for path, leaf in
              jax.tree_util.tree_flatten_with_path(dict(tree))[0]}
    tmodel = tstrong.CRNN.from_config(tstrong.CRNN.get_config(
        bicrnn_config('shallow', tag_conditioning=True)), device='cpu')
    assert {k: v.shape for k, v in tmodel.state_dict().items()} == shapes
    assert shapes['params.rnn.rnn.layer_0_bi.w_ih'] == (2, 266, 768)
    assert shapes['params.rnn.rnn.layer_1_bi.w_ih'] == (2, 512, 768)
    assert shapes['params.cnn.cnn_2d.conv_0.kernel'] == (3, 3, 11, 16)
    assert shapes['params.rnn.output_net.conv_0.kernel'] == (1, 512, 256)
