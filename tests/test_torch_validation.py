"""The port's trainer beyond the step, against the JAX package's, on the
tiny FBCRNN of ``tests/test_torch_fbcrnn.py`` (three classes here, the
synthetic database's) and batches from the port's own data pipeline:

- the training loss on a pipeline batch that carries ``warp_anchor_out``
  (the device-side time warp) agrees with the JAX ``loss_fn`` within the
  bound of ``tests/test_torch_train.py`` (``1e-4 + 3e-2 * |ref|``;
  augmentation off, the JAX side with its Pallas kernels in interpret
  mode);
- ``Trainer.validate`` of both packages on the same weights and the same
  validation set gives ``macro_fscore_weak``, ``macro_error_rate_weak``
  and ``lwlrap_weak`` within 1e-3 absolute (the metrics threshold and rank
  scores that differ at bf16 level between the packages) and writes
  ``ckpt_best_macro_fscore_weak.pkl``;
- back-off and early stopping follow the JAX trainer's on a stub metric
  sequence;
- ``test_run`` leaves parameters, running statistics, Adam's moments, the
  iteration, the generator's state and the run directory unchanged;
- ``load_partial_state_dict`` loads and skips the keys the JAX method
  does for a 527-class state dict with its output layer dropped.
"""
import copy
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.experiments.weak_label_crnn.training import \
    drop_output_layer as jax_drop_output_layer
from pb_sed_tpu.models import weak_label as jweak
from pb_sed_tpu.ops import rnn as jrnn
from pb_sed_tpu.train.optimizer import Adam as JaxAdam
from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.database.desed.provider import DESEDProvider
from pb_sed_tpu_torch.experiments.weak_label_crnn.training import \
    drop_output_layer
from pb_sed_tpu_torch.models import weak_label as tweak
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from pb_sed_tpu_torch.utils.checkpoint import load_payload
from tests.test_torch_fbcrnn import CONFIG
from tests.util_synth import EVENT_CLASSES, build_database

torch.set_num_threads(2)

METRICS = ('macro_fscore_weak', 'macro_error_rate_weak', 'lwlrap_weak')


def _config(num_events=len(EVENT_CLASSES)):
    config = copy.deepcopy(CONFIG)
    config['rnn_fwd']['output_net']['out_channels'] = [32, num_events]
    config['labelwise_metrics'] = ['fscore_weak']
    config['label_mapping'] = (list(EVENT_CLASSES) if num_events == 3
                               else None)
    return config


def _jax_model(flat=None, num_events=3):
    model = jweak.CRNN.from_config(jweak.CRNN.get_config(
        _config(num_events)))
    batch = {'audio_data': jnp.zeros((2, 8000)),
             'seq_len': jnp.array([50, 50], jnp.int32)}
    model.variables = jax.jit(lambda b: model.module.init(
        {'params': jax.random.PRNGKey(0)}, b, training=False))(batch)
    if flat is not None:
        model.load_state_dict(flat)
    return model


def _port_model(flat=None, num_events=3):
    model = tweak.CRNN.from_config(
        tweak.CRNN.get_config(_config(num_events)), device='cpu')
    if flat is not None:
        bridge.load_flat(model.module, flat)
    return model


@pytest.fixture(scope='module')
def flat():
    return bridge.random_flat(_jax_model().state_dict(), 7)


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Training batches (time warp on, so they carry ``warp_anchor_out``)
    and the validation set's batches from the port's ``DESEDProvider`` on
    the synthetic database."""
    root = tmp_path_factory.mktemp('data')
    _, json_path = build_database(root / 'db', num_train=8, num_weak=6,
                                  num_validate=10)
    config = DESEDProvider.get_config({
        'json_path': str(json_path),
        'train_set': {'train_weak': 1, 'train_strong': 1,
                      'train_synthetic20': 0, 'train_synthetic21': 0,
                      'train_unlabel_in_domain': 1},
        'discard_labelless_train_examples': False,
        'cached_datasets': None, 'min_audio_length': 0.2,
        'epoch_shuffle_seed': 3, 'storage_dir': str(root),
        'train_fetcher': {'batch_size': 4, 'prefetch_workers': 0,
                          'pad_to_multiple': 16,
                          'min_label_diversity_in_batch': 0,
                          'min_dataset_examples_in_batch': None},
        'test_fetcher': {'batch_size': 4, 'prefetch_workers': 0,
                         'pad_to_multiple': 16},
        'train_transform': {
            'stft': {'shift': 160, 'window_length': 480, 'size': 512},
            'provide_boundary_targets': True},
        'mix_interval': None,
    })
    provider = DESEDProvider.from_config(config)
    provider.train_transform.label_encoder.initialize_labels(
        labels=EVENT_CLASSES)
    provider.test_transform.label_encoder.initialize_labels()
    np.random.seed(0)
    train = list(provider.get_train_set())
    validate = list(provider.get_validate_set())
    assert len(train) >= 3 and len(validate) == 3
    assert 'warp_anchor_out' in train[0]
    return train, validate


@pytest.fixture
def interpret_mode():
    jrnn.set_pallas_mode('force_interpret')
    yield
    jrnn.set_pallas_mode('auto')


@pytest.fixture
def xla_mode():
    jrnn.set_pallas_mode('off')
    yield
    jrnn.set_pallas_mode('auto')


def _arrays(batch):
    return {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}


def test_loss_on_warped_pipeline_batch_matches_jax(flat, data,
                                                   interpret_mode):
    train, _ = data
    batch = next(b for b in train
                 if (b['weak_targets'] == .5).any()
                 and (b['weak_targets'] == 1.).any())
    assert batch['warp_anchor_in'].dtype == np.float32
    jmodel = _jax_model(flat)
    jbatch = {k: jnp.asarray(v) for k, v in _arrays(batch).items()}
    jloss, _ = jax.jit(lambda v, b: jmodel.loss_fn(v, b, {}, training=True))(
        jmodel.variables, jbatch)
    jloss = float(jloss)
    tmodel = _port_model(flat)
    tmodel.module.train()
    loss, aux = tmodel.loss(tmodel.to_device(batch))
    loss.backward()
    assert abs(float(loss.detach()) - jloss) <= 1e-4 + 3e-2 * abs(jloss)
    # the warp acted: without the anchors the loss is another one
    plain = {k: v for k, v in batch.items() if not k.startswith('warp_')}
    unwarped, _ = tmodel.loss(tmodel.to_device(plain))
    assert abs(float(unwarped.detach()) - float(loss.detach())) > 1e-6
    # and in eval mode it does not act
    tmodel.module.eval()
    with torch.no_grad():
        a, _ = tmodel.loss(tmodel.to_device(batch))
        b, _ = tmodel.loss(tmodel.to_device(plain))
    assert float(a) == float(b)


def test_validate_matches_jax_and_writes_best_checkpoint(flat, data,
                                                         interpret_mode,
                                                         tmp_path):
    train, validate = data
    jtrainer = JaxTrainer(_jax_model(flat), optimizer=JaxAdam(),
                          storage_dir=tmp_path / 'jax', use_mesh=False)
    jtrainer._ensure_ready(_arrays(validate[0]))
    jtrainer.register_validation_hook(validate, metric='macro_fscore_weak',
                                      maximize=True)
    ref = jtrainer.validate()
    ttrainer = Trainer(_port_model(flat), storage_dir=tmp_path / 'port')
    ttrainer.register_validation_hook(validate, metric='macro_fscore_weak',
                                      maximize=True)
    state = bridge.export_flat(ttrainer.model.module)
    got = ttrainer.validate()
    assert abs(got - ref) <= 1e-3
    import json
    lines = {}
    for name in ('jax', 'port'):
        (line,) = (tmp_path / name / 'summary.jsonl').read_text() \
            .splitlines()
        lines[name] = json.loads(line)
        assert lines[name]['prefix'] == 'validation'
    assert lines['port']['num_examples_weak'] == 10
    for key in METRICS:
        assert abs(lines['port'][key] - lines['jax'][key]) <= 1e-3, key
    assert abs(lines['port']['loss'] - lines['jax']['loss']) <= \
        1e-4 + 3e-2 * abs(lines['jax']['loss'])
    assert sorted(k for k in lines['port'] if k.startswith('z/')) == \
        sorted(k for k in lines['jax'] if k.startswith('z/')) == \
        [f'z/fscore_weak/{label}' for label in sorted(EVENT_CLASSES)]
    # validation ran in eval mode without gradients: nothing moved
    for key, value in bridge.export_flat(ttrainer.model.module).items():
        np.testing.assert_array_equal(value, state[key])
    assert all(p.grad is None for p in ttrainer.model.module.parameters())
    best = tmp_path / 'port' / 'checkpoints' / \
        'ckpt_best_macro_fscore_weak.pkl'
    payload = load_payload(best)
    assert sorted(payload['model']) == sorted(state)
    # either package restores it (the JAX package with pickle.load)
    with best.open('rb') as fid:
        jax_restored = _jax_model()
        jax_restored.load_state_dict(pickle.load(fid)['model'])
    assert not (tmp_path / 'port' / 'checkpoints' / 'ckpt_latest.pkl') \
        .exists()
    assert ttrainer.validation_hook['best'] == got


SEQUENCES = {
    # no gain after the first: back off after 2, again after 2 more, then
    # (n_back_off spent) count on to the early stop at 3
    'plateau': ([.5, .4, .4, .4, .4, .3, .3, .3], dict(
        back_off_patience=2, n_back_off=2, lr_update_factor=.5,
        early_stopping_patience=3)),
    'rising': ([.1, .2, .3, .4], dict(
        back_off_patience=1, n_back_off=1, lr_update_factor=.1,
        early_stopping_patience=1)),
    'minimize': ([.5, .6, .4, .7, .8], dict(
        maximize=False, back_off_patience=2, n_back_off=1,
        lr_update_factor=.2, early_stopping_patience=None)),
    'no_back_off': ([.5, .4, .3], dict(early_stopping_patience=2)),
}


@pytest.mark.parametrize('case', sorted(SEQUENCES))
def test_back_off_and_early_stopping_follow_jax(flat, data, xla_mode,
                                                tmp_path, case):
    _, validate = data
    values, kwargs = SEQUENCES[case]
    kwargs = dict({'maximize': True}, **kwargs)
    jtrainer = JaxTrainer(_jax_model(flat), optimizer=JaxAdam(lr=1e-3),
                          storage_dir=tmp_path / 'jax', use_mesh=False)
    jtrainer._ensure_ready(_arrays(validate[0]))
    ttrainer = Trainer(_port_model(flat), optimizer=Adam(lr=1e-3),
                       storage_dir=tmp_path / 'port')
    history = {}
    for name, trainer in (('jax', jtrainer), ('port', ttrainer)):
        trainer.register_validation_hook(validate[:1], metric='stub',
                                         **kwargs)
        it = iter(values)

        def stub(summary, it=it):
            return {'scalars': {'stub': next(it)}, 'buffers': {}}

        trainer.model.modify_summary = stub
        history[name] = []
        for step, _ in enumerate(values):
            trainer.iteration = step
            trainer.validate()
            hook = trainer.validation_hook
            history[name].append((
                trainer.lr_factor_backoff, hook['best'],
                hook['validations_since_best'], hook['back_offs_done'],
                trainer.stop_trigger.period,
                trainer.stop_trigger(trainer.iteration, 0)))
    assert history['port'] == history['jax']
    if case == 'plateau':
        assert history['port'][-1][0] == .25 and history['port'][-1][-1]
        assert ttrainer.step_lr() == pytest.approx(1e-3 * .25)
    if case == 'rising':
        assert history['port'][-1][0] == 1. and not history['port'][-1][-1]
    best = load_payload(tmp_path / 'port' / 'checkpoints'
                        / 'ckpt_best_stub.pkl')
    wanted = max(values) if kwargs['maximize'] else min(values)
    assert best['iteration'] == values.index(wanted)
    assert best['lr_factor_backoff'] == history['port'][
        values.index(wanted)][0] or case == 'plateau'


def test_validation_runs_after_checkpoints_and_at_the_end(flat, data,
                                                          tmp_path):
    """``train`` validates after each checkpoint trigger and once at the
    end, and ``summary.jsonl`` carries the metrics under both prefixes."""
    import json
    train, validate = data
    trainer = Trainer(_port_model(flat), optimizer=Adam(lr=1e-3),
                      storage_dir=tmp_path, summary_trigger=(2, 'iteration'),
                      checkpoint_trigger=(2, 'iteration'),
                      stop_trigger=(5, 'iteration'))
    trainer.register_validation_hook(validate, metric='macro_fscore_weak',
                                     maximize=True)
    trainer.train(train)
    rows = [json.loads(line) for line in
            (tmp_path / 'summary.jsonl').read_text().splitlines()]
    assert [(r['prefix'], r['iteration']) for r in rows] == [
        ('training', 2), ('validation', 2), ('training', 4),
        ('validation', 4), ('training', 5), ('validation', 5)]
    for row in rows:
        for key in METRICS + ('loss', 'num_examples_weak'):
            assert np.isfinite(row[key]), (row['prefix'], key)
    assert all('lr' in r and 'grad_norm' in r for r in rows
               if r['prefix'] == 'training')
    names = sorted(p.name for p in (tmp_path / 'checkpoints').iterdir())
    assert names == ['ckpt_5.pkl', 'ckpt_best_macro_fscore_weak.pkl',
                     'ckpt_latest.pkl']
    # a finished run resumed: no step, no further validation line
    again = Trainer(_port_model(flat), storage_dir=tmp_path,
                    stop_trigger=(5, 'iteration'))
    again.register_validation_hook(validate, metric='macro_fscore_weak',
                                   maximize=True)
    again.train(train, resume=True)
    assert len((tmp_path / 'summary.jsonl').read_text().splitlines()) == 6


def test_test_run_leaves_everything_as_it_was(flat, data, tmp_path):
    train, validate = data
    trainer = Trainer(_port_model(flat), optimizer=Adam(lr=1e-3),
                      storage_dir=tmp_path / 'run',
                      summary_trigger=(1, 'iteration'),
                      checkpoint_trigger=(1, 'iteration'))
    trainer.train_step(train[0])  # Adam's moments and the stats are live
    for path in (tmp_path / 'run').rglob('*'):
        if path.is_file():
            path.unlink()

    def snapshot():
        return (bridge.export_flat(trainer.model.module),
                [m.clone() for key in ('mu', 'nu')
                 for m in trainer.opt_state[key]],
                trainer.opt_state['count'], trainer.iteration, trainer.epoch,
                trainer.generator.get_state().clone(),
                trainer.checkpoint_trigger.last, trainer.summary_trigger.last,
                sorted(p for p in (tmp_path / 'run').rglob('*')
                       if p.is_file()))

    before = snapshot()
    trainer.test_run(train[1:], validate)
    after = snapshot()
    for key, value in before[0].items():
        np.testing.assert_array_equal(after[0][key], value)
    for a, b in zip(before[1], after[1]):
        assert torch.equal(a, b)
    assert before[2:5] == after[2:5] == (1, 1, 0)
    assert torch.equal(before[5], after[5])
    assert before[6:] == after[6:] and after[8] == []
    assert all(p.grad is None for p in trainer.model.module.parameters())
    assert not trainer._summary['scalars'] and not trainer._summary['raw']
    # the same step after it as without it
    twin = Trainer(_port_model(flat), optimizer=Adam(lr=1e-3))
    twin.train_step(train[0])
    assert float(trainer.train_step(train[2])) == \
        float(twin.train_step(train[2]))
    # a loss that is not finite stops the run there
    bad = dict(train[0], audio_data=np.full_like(train[0]['audio_data'],
                                                 np.nan))
    with pytest.raises(FloatingPointError, match='training loss'):
        trainer.test_run([bad])


def test_load_partial_state_dict_matches_jax():
    """A 527-class model's state dict (the AudioSet pre-training) through
    ``drop_output_layer`` into a 10-class model: both packages load and
    skip the same keys, and the loaded tensors arrive. The function is the
    JAX package's as it is: it looks for ``<head>.head.conv_<n>`` while
    the heads name their layers ``<head>.output_net.conv_<n>``, so it
    drops nothing of these models, and the 527-wide output layers are
    skipped by ``load_partial_state_dict``'s shape check instead. On a
    state dict that does name ``.head.conv_`` both drop the last layer of
    each head."""
    source = bridge.random_flat(_jax_model(num_events=527).state_dict(), 3)
    dropped = drop_output_layer(source)
    assert sorted(dropped) == sorted(jax_drop_output_layer(source)) == \
        sorted(source)
    named = {f'params.{head}.head.conv_{i}.kernel': np.zeros(1)
             for head in ('rnn_fwd', 'rnn_bwd') for i in (0, 1, 2)}
    assert sorted(drop_output_layer(named)) == \
        sorted(jax_drop_output_layer(named)) == sorted(
            k for k in named if '.conv_2.' not in k)
    # one more tensor of another shape and one unknown key: both skipped
    dropped['params.rnn_fwd.output_net.norm_0.scale'] = np.zeros(5)
    dropped['params.not_in_the_model'] = np.zeros(2)
    jmodel = _jax_model(num_events=10)
    jloaded, jskipped = jmodel.load_partial_state_dict(dropped,
                                                       verbose=False)
    tmodel = _port_model(num_events=10)
    before = tmodel.state_dict()
    loaded, skipped = tmodel.load_partial_state_dict(dropped, verbose=False)
    assert loaded == jloaded and skipped == jskipped
    assert sorted(skipped) == sorted(
        ['params.not_in_the_model', 'params.rnn_fwd.output_net.norm_0.scale']
        + [f'params.{head}.output_net.conv_1.{name}'
           for head in ('rnn_fwd', 'rnn_bwd')
           for name in ('kernel', 'bias')])
    after = tmodel.state_dict()
    for key in loaded:
        np.testing.assert_array_equal(after[key], dropped[key])
    for key in set(after) - set(loaded):
        np.testing.assert_array_equal(after[key], before[key])


def test_trainer_initializes_a_model_without_weights(data):
    """A model built from its config has zero weights; the trainer gives
    it the JAX package's initializers from its seed before the first step
    (LeCun-normal kernels with the spread of the JAX model's own
    initialization, orthonormal ``w_hh`` rows, unit scales, zero biases,
    fresh running statistics) and leaves a model with loaded weights as
    it is."""
    train, _ = data
    model = _port_model()
    assert model.as_constructed()
    trainer = Trainer(model, seed=5)
    trainer._ensure_ready()
    assert not model.as_constructed()
    state = model.state_dict()
    other = _port_model()
    other.init_parameters(5)
    for key, value in other.state_dict().items():
        np.testing.assert_array_equal(state[key], value)
    other.init_parameters(6)
    assert not np.array_equal(other.state_dict()['params.cnn.cnn_2d.'
                                                 'conv_1.kernel'],
                              state['params.cnn.cnn_2d.conv_1.kernel'])
    ref = _jax_model().state_dict()  # flax's own initialization
    assert sorted(ref) == sorted(state)
    for key, value in state.items():
        name = key.rsplit('.', 1)[-1]
        if name == 'w_hh':
            np.testing.assert_allclose(value @ value.T,
                                       np.eye(len(value)), atol=1e-5)
            np.testing.assert_allclose(ref[key] @ ref[key].T,
                                       np.eye(len(value)), atol=1e-5)
        elif value.ndim >= 2:
            fan_in = np.prod(value.shape[:-1])
            assert np.abs(value).max() <= 2. / (.8796 * np.sqrt(fan_in))
            if value.size >= 1024:
                assert value.std() == pytest.approx(ref[key].std(), rel=.1)
                assert abs(value.mean()) < .1 * value.std()
        else:
            np.testing.assert_array_equal(value, ref[key])
    # training from it moves every weight matrix
    for batch in train[:2]:
        assert np.isfinite(float(trainer.train_step(batch)))
    after = model.state_dict()
    assert all(not np.array_equal(after[k], state[k]) for k in state
               if k.endswith(('kernel', 'w_ih', 'w_hh')))
    # loaded weights are not touched
    loaded = _port_model(bridge.random_flat(state, 1))
    before = loaded.state_dict()
    Trainer(loaded, seed=5)._ensure_ready()
    for key, value in loaded.state_dict().items():
        np.testing.assert_array_equal(value, before[key])
