"""The port's training slice against the JAX package on the tiny FBCRNN of
``tests/test_torch_fbcrnn.py`` (augmentation off, the same seeded numpy
weights through the bridge, the same batches with unequal lengths, soft
weak targets and partly labelled boundary targets): the loss and every
parameter's gradient, the mutated batch statistics, three ``Trainer``
steps, and a checkpoint written by the port's trainer restored in both
packages.

The JAX side runs its Pallas kernels in interpret mode, as its own CPU
tests do; the port runs its kernels' plain versions (CPU tensors).

Gradient tolerance. The stated bound ``1e-4 + 3.5e-2 * max|ref|`` (the
JAX package's packed-vs-XLA bound for one conv, ``tests/
test_pallas_conv.py:209``) is below the noise of this model's gradients:
the bf16 cotangents of the conv tower feed training-mode batch norms,
whose backward cancels most of them, and the JAX package's own two paths
(its Pallas kernels and its XLA path) disagree by up to 144x that bound
(conv biases) and 2-9x on most CNN tensors. So each gradient is held to
the larger of the stated bound and twice the JAX package's own
Pallas-vs-XLA gap on the same tensor, and, where the true gradient is
not identically zero, to a cosine similarity >= 0.99 with JAX's. A conv
bias that feeds a training-mode batch norm has an identically zero
gradient (the norm subtracts it again); both packages return bf16 noise
there.
"""
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.models.base.model import flatten_variables
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.train.hooks import LRAnnealingHook
from pb_sed_tpu.train.optimizer import Adam as JaxAdam
from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
from pb_sed_tpu.utils.config import config_to_json
from pb_sed_tpu.utils.misc import dump_json
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.ops.kernels import build
from pb_sed_tpu_torch.train.hooks import \
    LRAnnealingHook as PortLRAnnealingHook
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from tests.test_torch_fbcrnn import CONFIG, K, SAMPLES

torch.set_num_threads(2)

T = 50  # frames of a 0.5 s clip at shift 160
# conv biases that feed a training-mode batch norm (identically zero
# gradient in exact arithmetic)
BN_FED_BIASES = {
    'cnn.cnn_2d.conv_0.bias', 'cnn.cnn_2d.conv_1.bias',
    'cnn.cnn_2d.conv_2.bias', 'cnn.cnn_1d.conv_0.bias',
    'rnn_fwd.output_net.conv_0.bias', 'rnn_bwd.output_net.conv_0.bias',
}


def _config(**updates):
    config = pickle.loads(pickle.dumps(CONFIG))
    config.update(updates)
    return config


def _train_batch(seed):
    """Two clips, the second 33 of 50 frames (zeroed tail); soft weak
    targets (.5, .3) and a partly labelled boundary row (.5)."""
    rng = np.random.RandomState(seed)
    audio = (.3 * rng.randn(2, SAMPLES)).astype(np.float32)
    seq_len = np.array([T, 33], np.int32)
    audio[1, seq_len[1] * 160:] = 0.
    weak = (rng.rand(2, K) > .5).astype(np.float32)
    weak[0, 3], weak[1, 7] = .5, .3
    boundary = (rng.rand(2, K, T) > .6).astype(np.float32)
    boundary[1, :4] = .5
    return {'audio_data': audio, 'seq_len': seq_len,
            'weak_targets': weak, 'boundary_targets': boundary}


@pytest.fixture(scope='module')
def flat():
    """Seeded weights in the flat layout of the tiny FBCRNN."""
    jmodel = jweak.CRNN.from_config(jweak.CRNN.get_config(_config()))
    jmodel.variables = jax.jit(lambda b: jmodel.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(
            _train_batch(0))
    return bridge.random_flat(jmodel.state_dict(), 7)


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


def _jax_model(flat, **updates):
    model = jweak.CRNN.from_config(jweak.CRNN.get_config(_config(**updates)))
    model.load_state_dict(flat)
    return model


def _port_model(flat, **updates):
    model = tweak.CRNN.from_config(tweak.CRNN.get_config(_config(**updates)),
                                   device='cpu')
    bridge.load_flat(model.module, flat)
    return model


def _jax_loss_and_grads(model, batch, pallas_mode):
    jrnn.set_pallas_mode(pallas_mode)
    variables = model.variables

    def loss_of(params):
        vs = dict(variables)
        vs['params'] = params
        return model.loss_fn(vs, batch, {}, training=True)

    (loss, aux), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        variables['params'])
    return (float(loss), flatten_variables({'params': grads}),
            flatten_variables({'batch_stats': aux[0]['batch_stats']}))


def _cosine(a, b):
    a = np.ravel(a).astype(np.float64)
    b = np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize('updates', [
    {},
    {'slat': True, 'label_smoothing': .1,
     'class_weights': list(np.linspace(.5, 1.5, K))},
], ids=['weak_strong', 'slat_smoothing_weights'])
def test_loss_and_gradients_match_jax(flat, interpret_mode, updates):
    batch = _train_batch(1)
    jmodel = _jax_model(flat, **updates)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads, jstats = _jax_loss_and_grads(jmodel, jbatch,
                                                'force_interpret')
    _, xla_grads, _ = _jax_loss_and_grads(jmodel, jbatch, 'off')
    tmodel = _port_model(flat, **updates)
    tmodel.module.train()
    loss, aux = tmodel.loss(tmodel.to_device(batch))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    assert float(aux['scalars']['boundary_label_rate']) > 0.
    for name, p in tmodel.module.named_parameters():
        key = f'params.{name}'
        ref, got = jgrads[key], p.grad.numpy()
        gap = float(np.abs(got - ref).max())
        jax_gap = float(np.abs(xla_grads[key] - ref).max())
        bound = max(1e-4 + 3.5e-2 * float(np.abs(ref).max()), 2 * jax_gap)
        assert gap <= bound, (name, gap, bound)
        if name not in BN_FED_BIASES:
            assert _cosine(got, ref) >= .99, (name, _cosine(got, ref))
    stats = bridge.export_flat(tmodel.module)
    assert sorted(k for k in stats if k.startswith('batch_stats.')) == \
        sorted(jstats)
    for key, ref in jstats.items():
        np.testing.assert_allclose(
            stats[key], ref, rtol=0,
            atol=1e-4 + 3e-2 * float(np.max(np.abs(ref))))


@pytest.mark.parametrize('f,h', [(24, 32), (64, 64), (512, 512)])
def test_project_bias_rounds_once_like_jax(f, h):
    """``GRULayer.project`` adds the f32 ``b_ih`` to the f32 product and
    rounds once, as JAX does (``pb_sed_tpu/ops/rnn.py:95-101``, streamed
    as bf16 by ``ops/pallas/gru.py:178``): ``xw`` equals JAX's bit for bit
    but for at most 0.1% of its elements, each one bf16 ulp off (f32
    summation order), and ``b_ih``'s gradient is the f32 row sum of the
    cotangent (``1e-5 * max|ref|``). At the FBCRNN test width (H = 32),
    the deep test width (H = 64) and the deep recipe's (H = 512)."""
    from pb_sed_tpu.ops.rnn import GRULayer as JaxGRULayer
    from pb_sed_tpu_torch.ops.rnn import GRULayer
    rng = np.random.RandomState(2)
    b, t = 3, 20
    x = rng.randn(b, t, f).astype(np.float32)
    g = rng.randn(b, t, 3 * h).astype(np.float32)
    layer = GRULayer(h, f)
    params = {'w_ih': (rng.randn(f, 3 * h) / np.sqrt(f)).astype(np.float32),
              'w_hh': np.zeros((h, 3 * h), np.float32),
              'b_ih': rng.randn(3 * h).astype(np.float32),
              'b_hh': np.zeros(3 * h, np.float32)}
    bridge.load_flat(layer, {f'params.{k}': v for k, v in params.items()})
    jlayer = JaxGRULayer(h, f)

    def jax_xw(p):
        return jlayer.apply({'params': p}, jnp.asarray(x),
                            method=JaxGRULayer.project).astype(jnp.bfloat16)

    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    xw_ref, vjp = jax.vjp(jax_xw, jparams)
    (dparams,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    xw = layer.project(torch.from_numpy(x))
    assert xw.dtype == torch.bfloat16
    (xw.float() * torch.from_numpy(g).to(torch.bfloat16).float()).sum() \
        .backward()

    def bits(a):  # bf16 values -> their 16-bit patterns, ordered
        return (np.asarray(a, np.float32).view(np.uint32) >> 16).astype(
            np.int64)

    ulps = np.abs(bits(xw.float().detach().numpy()) - bits(xw_ref))
    d_db = float(np.abs(layer.b_ih.grad.numpy()
                        - np.asarray(dparams['b_ih'])).max())
    print(f'xw: {np.count_nonzero(ulps)} of {ulps.size} elements off by '
          f'{ulps.max()} ulp; max|d db_ih| {d_db:.3e}')
    assert ulps.max() <= 1
    assert np.count_nonzero(ulps) <= 1e-3 * ulps.size
    db_ref = np.asarray(dparams['b_ih'])
    np.testing.assert_allclose(layer.b_ih.grad.numpy(), db_ref, rtol=0,
                               atol=1e-5 * float(np.abs(db_ref).max()))


def _trainers(flat, storage=None):
    # Adam's first steps move each element by about sign(g) * lr; eps
    # 1e-2 (above the clipped gradients' elements) keeps the elements
    # whose gradient is bf16 noise at noise-sized steps, so the update
    # compares like the gradient
    kwargs = dict(lr=1e-3, gradient_clipping=.1, eps=1e-2)
    breakpoints = [(0, .5), (2, 1.), (10, .2)]  # ramp inside the 3 steps
    jtrainer = JaxTrainer(_jax_model(flat), optimizer=JaxAdam(**kwargs),
                          storage_dir=None, use_mesh=False,
                          stop_trigger=(3, 'iteration'))
    ttrainer = Trainer(_port_model(flat), optimizer=Adam(**kwargs),
                       storage_dir=storage, stop_trigger=(3, 'iteration'))
    # each trainer takes its own package's hook (the port's trainer reads
    # the schedule from its own LRAnnealingHook class)
    jtrainer.register_hook(LRAnnealingHook(breakpoints=breakpoints))
    ttrainer.register_hook(PortLRAnnealingHook(breakpoints=breakpoints))
    return jtrainer, ttrainer


def test_three_trainer_steps_match_jax(flat, interpret_mode):
    jtrainer, ttrainer = _trainers(flat)
    frozen = 'rnn_bwd.output_net.'
    batches = [_train_batch(seed) for seed in (1, 2, 3)]
    jtrainer._ensure_ready(batches[0])
    for trainer in (jtrainer, ttrainer):
        trainer.freeze(lambda path: path.startswith(frozen))
    p0 = bridge.export_flat(ttrainer.model.module)
    build.reset_launches()
    for step, batch in enumerate(batches):
        jloss = float(jtrainer.train_step(batch))
        tloss = float(ttrainer.train_step(batch))
        assert abs(tloss - jloss) <= 1e-4 + 3e-2 * abs(jloss), (step, tloss,
                                                                jloss)
        assert ttrainer.step_lr() == pytest.approx(
            1e-3 * [.75, 1., .9][step], rel=1e-6)
    assert all(v == 0 for v in build.LAUNCHES.values())
    # the clipping bit: the raw gradient norm is above the bound
    grad_norms = ttrainer._summary['scalars']['grad_norm']
    assert min(float(v) for v in grad_norms) > .1
    jflat = jtrainer.model.state_dict()
    tflat = bridge.export_flat(ttrainer.model.module)
    for key, before in p0.items():
        if key.startswith('params.'):
            name = key[len('params.'):]
            if name.startswith(frozen):
                np.testing.assert_array_equal(tflat[key], before)
                np.testing.assert_array_equal(jflat[key], before)
            elif name not in BN_FED_BIASES:
                cos = _cosine(tflat[key] - before, jflat[key] - before)
                assert cos >= .99, (name, cos)
        elif frozen in key:
            np.testing.assert_array_equal(tflat[key], before)
        else:
            np.testing.assert_allclose(
                tflat[key], jflat[key], rtol=0,
                atol=1e-4 + 3e-2 * float(np.max(np.abs(jflat[key]))))


def test_checkpoint_round_trip_into_both_packages(flat, interpret_mode,
                                                  tmp_path):
    """A checkpoint written by the port's trainer plus a JAX-style
    ``config.json`` restores in the JAX package and in the port, which
    then tag alike; the port's trainer resumes from it."""
    storage = tmp_path / 'run'
    trainer = Trainer(_port_model(flat), storage_dir=storage,
                      summary_trigger=(1, 'iteration'),
                      checkpoint_trigger=(2, 'iteration'),
                      stop_trigger=(2, 'iteration'))
    trainer.train([_train_batch(seed) for seed in (4, 5)])
    assert trainer.iteration == 2
    lines = (storage / 'summary.jsonl').read_text().splitlines()
    assert len(lines) == 2 and '"loss"' in lines[0]
    config = jweak.CRNN.get_config(_config())
    dump_json({'trainer': {'model': config_to_json(config)}},
              storage / '1' / 'config.json')
    name = 'ckpt_latest.pkl'
    jax_restored = jweak.CRNN.from_storage_dir(storage, checkpoint_name=name)
    port_restored = tweak.CRNN.from_storage_dir(storage, checkpoint_name=name,
                                                device='cpu')
    batch = {k: v for k, v in _train_batch(6).items()
             if k in ('audio_data', 'seq_len')}
    ref = np.asarray(jax_restored.tagging(batch)[0])
    got = port_restored.tagging(batch)[0]
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 + 3e-2 * float(np.abs(ref).max()))
    resumed = Trainer(_port_model(flat), storage_dir=storage,
                      stop_trigger=(3, 'iteration'))
    assert resumed.load_latest_checkpoint()
    assert resumed.iteration == 2
    assert resumed.opt_state['count'] == 2
    for key, value in bridge.export_flat(trainer.model.module).items():
        np.testing.assert_array_equal(
            bridge.export_flat(resumed.model.module)[key], value)


def test_jax_hook_on_port_trainer_raises(flat):
    """The JAX package's LRAnnealingHook is not the port's: registering
    it raises, naming the port's class, instead of dropping the ramp."""
    trainer = Trainer(_port_model(flat))
    with pytest.raises(TypeError,
                       match='pb_sed_tpu_torch.train.hooks.LRAnnealingHook'):
        trainer.register_hook(LRAnnealingHook(breakpoints=[(0, 1.)]))
    assert not any(isinstance(h, LRAnnealingHook) for h in trainer.hooks)


@pytest.mark.parametrize('option', ['steps_per_call', 'profile_at',
                                    'dropout'])
def test_unported_training_options_raise(flat, option):
    """One case per option of the JAX trainer that the port does not have
    yet: each raises where it is asked for. (Validation hooks and
    ``test_run`` are ported: ``tests/test_torch_validation.py``.)"""
    model = _port_model(flat)
    with pytest.raises(NotImplementedError):
        if option == 'steps_per_call':
            Trainer(model, steps_per_call=2)
        elif option == 'profile_at':
            Trainer(model, profile_at=3)
        else:
            model.module.cnn.cnn_2d.dropout = .1
            model.module.train()
            model.loss(model.to_device(_train_batch(1)))


def test_track_emissions_writes_the_jax_columns(flat, tmp_path):
    """``train(..., track_emissions=True)`` on the CPU appends one row to
    ``<storage_dir>/emissions.csv`` under the JAX package's header, with
    the platform read from torch."""
    import csv
    from pb_sed_tpu.train.emissions import EmissionsTracker as JaxTracker
    jax_dir = tmp_path / 'jax'
    tracker = JaxTracker(output_dir=jax_dir)
    tracker.start()
    tracker.stop()
    trainer = Trainer(_port_model(flat), storage_dir=tmp_path / 'port',
                      stop_trigger=(1, 'iteration'))
    trainer.train([_train_batch(1)], track_emissions=True)
    with (tmp_path / 'port' / 'emissions.csv').open() as fid:
        rows = list(csv.reader(fid))
    with (jax_dir / 'emissions.csv').open() as fid:
        header = next(csv.reader(fid))
    assert rows[0] == header == [
        'timestamp', 'duration_s', 'platform', 'num_devices',
        'energy_kwh_estimated', 'emissions_kg_estimated']
    assert len(rows) == 2 and rows[1][2] == 'cpu' and rows[1][3] == '1'
    assert float(rows[1][1]) >= 0. and float(rows[1][4]) >= 0.
