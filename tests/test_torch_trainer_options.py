"""The trainer options the port took over from the JAX package's
``Trainer``: the multi-step lane (``steps_per_call``), the profiler hook
(``profile_at``, ``profile_num_steps``) and its ``Timer``, and the
training CLI's overrides that reach them.

On the tiny FBCRNN of ``tests/test_torch_fbcrnn.py`` (the port's kernels
run their plain versions on CPU tensors):

- ``train_steps([b1, b2, b3])`` equals three ``train_step`` calls in every
  bit (parameters, statistics, generators, losses), with augmentation and
  dropout on;
- the checkpoints land at iterations 6, 9 and 12 for ``steps_per_call=3``
  and ``checkpoint_trigger=(4, 'iteration')`` (the JAX package's
  ``tests/test_trainer.py:324-343``);
- a stream of batches of two shapes drains the buffer early, and the
  calls and the final iteration after the stop equal the JAX trainer's
  own loop (its step functions replaced by counters, so only the loop
  runs);
- one 3-step call against JAX ``train_steps`` (augmentation off) under the
  update rule of ``tests/test_torch_train.py``: a cosine >= 0.99 between
  the two packages' updates of each tensor whose gradient is not
  identically zero, the statistics within ``1e-4 + 3e-2 * max|ref|``;
- the profiler writes a Chrome trace under ``storage_dir/profile`` with
  one window per profiled step, by the JAX trainer's rule (start before
  the step that crosses ``profile_at``, stop once ``iteration >=
  profile_at + profile_num_steps``), and stops when training ends early
  or raises.
"""
import copy
import pickle

import jax
import numpy as np
import pytest
import torch

from pb_sed_tpu.train.optimizer import Adam as JaxAdam
from pb_sed_tpu.train.trainer import Trainer as JaxTrainer
from pb_sed_tpu_torch import bridge
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.train.trainer import Trainer
from pb_sed_tpu_torch.utils.profiling import Timer, step_times_ms
from tests.test_torch_fbcrnn import CONFIG
from tests.test_torch_train import (  # noqa: F401 (fixtures: flat, ...)
    BN_FED_BIASES, _cosine, _jax_model, _port_model, _train_batch, flat,
    interpret_mode)

torch.set_num_threads(2)


def _dropout_model(flat):
    """The tiny FBCRNN with augmentation and dropout (towers .2, between
    the GRU layers .3)."""
    config = pickle.loads(pickle.dumps(CONFIG))
    config['feature_extractor'].update(
        n_time_masks=1, n_frequency_masks=1, max_noise_scale=.2)
    config['cnn']['cnn_2d']['dropout'] = .2
    config['cnn']['cnn_1d']['dropout'] = .2
    config['rnn_fwd']['rnn']['dropout'] = .3
    from pb_sed_tpu_torch.models import weak_label as tweak
    model = tweak.CRNN.from_config(tweak.CRNN.get_config(config),
                                   device='cpu')
    bridge.load_flat(model.module, flat)
    return model


def test_train_steps_equals_single_steps_in_every_bit(flat):
    batches = [_train_batch(seed) for seed in (1, 2, 3)]
    lane = Trainer(_dropout_model(flat), steps_per_call=3)
    single = Trainer(_dropout_model(flat))
    losses = lane.train_steps(batches)
    assert losses.shape == (3,) and lane.iteration == 3
    ref = torch.stack([single.train_step(b) for b in batches])
    assert torch.equal(losses, ref)
    assert lane.step_lr() == single.step_lr()
    for a, b in zip(lane.model.module.state_dict().values(),
                    single.model.module.state_dict().values()):
        assert torch.equal(a, b)
    for key in ('mu', 'nu'):
        for a, b in zip(lane.opt_state[key], single.opt_state[key]):
            assert torch.equal(a, b)
    for name in ('generator', 'dropout_generator'):
        assert torch.equal(getattr(lane, name).get_state(),
                           getattr(single, name).get_state())
    # one summary entry for the call, (3,)-stacked: its mean, as JAX's
    assert [tuple(v.shape) for v in lane._summary['scalars']['loss']] == [
        (3,)]
    assert len(lane._summary['raw']) == 1
    assert lane._summary['raw'][0]['y_weak'].shape[0] == 6


def test_checkpoints_land_where_jax_s_do(flat, tmp_path):
    """``steps_per_call=3``, a checkpoint every 4 iterations: the
    interval trigger fires on crossings, at 6, 9 and 12."""
    trainer = Trainer(_port_model(flat), storage_dir=tmp_path,
                      steps_per_call=3, checkpoint_trigger=(4, 'iteration'),
                      stop_trigger=(100, 'iteration'), keep_checkpoints=10)
    batch = _train_batch(1)
    for _ in range(4):
        trainer.train_steps([batch] * 3)
    names = sorted(int(p.stem.split('_')[1]) for p in
                   (tmp_path / 'checkpoints').glob('ckpt_[0-9]*.pkl'))
    assert names == [6, 9, 12]


def _short(batch, frames=40):
    """``batch`` cut to ``frames`` frames (another shape)."""
    return {'audio_data': batch['audio_data'][:, :frames * 160].copy(),
            'seq_len': np.minimum(batch['seq_len'], frames),
            'weak_targets': batch['weak_targets'],
            'boundary_targets': batch['boundary_targets'][..., :frames]}


def test_mixed_shapes_drain_early_and_stop_where_jax_does(flat):
    """Shapes A A A A A B B A A A with ``steps_per_call=3`` and a stop at
    7: calls of 3, 2 (B drains the two As), 2 (A drains the Bs), then the
    stop check sees 7 and the last A drains as one step after the loop:
    the run ends at 8, one past the stop, as the JAX trainer's does."""
    a = [_train_batch(seed) for seed in range(8)]
    stream = a[:5] + [_short(_train_batch(8)), _short(_train_batch(9))] \
        + a[5:]
    calls = {}

    jax_trainer = JaxTrainer(None, storage_dir=None, use_mesh=False,
                             steps_per_call=3, stop_trigger=(7, 'iteration'))
    calls['jax'] = []

    def jax_step(batch):
        calls['jax'].append(1)
        jax_trainer.iteration += 1

    def jax_steps(batches):
        calls['jax'].append(len(batches))
        jax_trainer.iteration += len(batches)

    jax_trainer.train_step, jax_trainer.train_steps = jax_step, jax_steps
    jax_trainer.train(stream)

    trainer = Trainer(_port_model(flat), steps_per_call=3,
                      stop_trigger=(7, 'iteration'))
    calls['port'] = []
    step, steps = trainer.train_step, trainer.train_steps

    def port_step(batch):
        calls['port'].append(1)
        return step(batch)

    def port_steps(batches):
        calls['port'].append(len(batches))
        assert len({b['audio_data'].shape for b in batches}) == 1
        return steps(batches)

    trainer.train_step, trainer.train_steps = port_step, port_steps
    trainer.train(stream)
    assert calls['port'] == calls['jax'] == [3, 2, 2, 1]
    assert trainer.iteration == jax_trainer.iteration == 8


def test_one_call_of_three_steps_matches_jax(flat, interpret_mode):
    kwargs = dict(lr=1e-3, gradient_clipping=.1, eps=1e-2)
    batches = [_train_batch(seed) for seed in (1, 2, 3)]
    jtrainer = JaxTrainer(_jax_model(flat), optimizer=JaxAdam(**kwargs),
                          storage_dir=None, use_mesh=False, steps_per_call=3)
    jtrainer._ensure_ready(batches[0])
    ttrainer = Trainer(_port_model(flat), optimizer=Adam(**kwargs),
                       steps_per_call=3)
    p0 = bridge.export_flat(ttrainer.model.module)
    jlosses = np.asarray(jtrainer.train_steps(batches))
    tlosses = ttrainer.train_steps(batches).numpy()
    np.testing.assert_allclose(tlosses, jlosses, rtol=0,
                               atol=1e-4 + 3e-2 * float(np.abs(jlosses).max()))
    assert jtrainer.iteration == ttrainer.iteration == 3
    jflat = jtrainer.model.state_dict()
    tflat = bridge.export_flat(ttrainer.model.module)
    for key, before in p0.items():
        if key.startswith('params.'):
            if key[len('params.'):] not in BN_FED_BIASES:
                cos = _cosine(tflat[key] - before, jflat[key] - before)
                assert cos >= .99, (key, cos)
        else:
            np.testing.assert_allclose(
                tflat[key], jflat[key], rtol=0,
                atol=1e-4 + 3e-2 * float(np.max(np.abs(jflat[key]))))


def _traced(storage_dir, **kwargs):
    return Trainer(_port_model_cached(), storage_dir=storage_dir,
                   summary_trigger=(100, 'iteration'),
                   checkpoint_trigger=(100, 'iteration'), **kwargs)


_MODELS = {}


def _port_model_cached():
    """A fresh copy of one tiny model (the profiler tests only time)."""
    if 'model' not in _MODELS:
        from pb_sed_tpu_torch.models import weak_label as tweak
        model = tweak.CRNN.from_config(tweak.CRNN.get_config(
            pickle.loads(pickle.dumps(CONFIG))), device='cpu')
        model.init_parameters(0)
        _MODELS['model'] = model
    return copy.deepcopy(_MODELS['model'])


def _windows(storage_dir):
    traces = sorted((storage_dir / 'profile').glob('trace_*.json'))
    assert len(traces) == 1, traces
    return step_times_ms(traces[0])


def test_profiler_traces_the_steps_of_the_jax_rule(tmp_path, capsys):
    """A 4-step run with ``profile_at=2, profile_num_steps=2``: the trace
    starts before step 2 (iteration 1 + 1 crosses 2) and stops after step
    4 (iteration 4 >= 2 + 2), the JAX trainer's rule, so it holds the
    windows of steps 2, 3 and 4; each step's host and device ms are
    printed."""
    trainer = _traced(tmp_path, stop_trigger=(4, 'iteration'),
                      profile_at=2, profile_num_steps=2)
    trainer.train([_train_batch(seed) for seed in range(4)])
    windows = _windows(tmp_path)
    assert sorted(windows) == [2, 3, 4]
    assert all(host > 0. and device == 0. for host, device in
               windows.values())  # no device events on the CPU
    out = capsys.readouterr().out
    assert 'Profiler trace written to' in out
    assert out.count('Profiled step') == 3
    assert trainer._profile is None and trainer._profile_done


def test_profiler_stops_when_training_ends_early(tmp_path):
    """The stop trigger (3) comes before ``profile_at + profile_num_steps``
    (2 + 5): ``train``'s end stops the trace; so does an error from the
    data, in the multi-step lane too."""
    trainer = _traced(tmp_path / 'stop', stop_trigger=(3, 'iteration'),
                      profile_at=2, profile_num_steps=5)
    trainer.train([_train_batch(seed) for seed in range(3)])
    assert trainer._profile is None
    assert sorted(_windows(tmp_path / 'stop')) == [2, 3]

    def failing():
        for seed in range(4):
            yield _train_batch(seed)
        raise RuntimeError('the loader failed')

    trainer = _traced(tmp_path / 'error', stop_trigger=(10, 'iteration'), steps_per_call=2,
                      profile_at=1, profile_num_steps=8)
    with pytest.raises(RuntimeError, match='the loader failed'):
        trainer.train(failing())
    assert trainer._profile is None
    assert sorted(_windows(tmp_path / 'error')) == [1, 2, 3, 4]


def test_timer_counts_as_jax_s():
    """The JAX package's ``test_misc_features`` use of ``Timer``."""
    timer = Timer()
    with timer('stage'):
        pass
    with timer('stage'):
        pass
    assert timer.summary()['stage']['count'] == 2
    assert timer.summary()['stage']['total_s'] >= 0.


def test_cli_overrides_reach_the_trainer():
    """The training CLI's overrides of the new options build the trainer
    they name: ``trainer.steps_per_call``, ``trainer.profile_at`` /
    ``profile_num_steps``, the towers' and the head's dropout and a
    Transformer ``rnn_fwd.factory`` (whose backward head is its reversed
    copy), with the same trainer config as the JAX CLI's for the same
    overrides. As in the JAX CLI, the recipe's ``rnn`` values (2 layers of
    256) stay where the override names only the factory; the head's own
    defaults fill the rest (``d_ff`` 1024, 8 heads)."""
    from pb_sed_tpu.experiments.weak_label_crnn import training as jtraining
    from pb_sed_tpu.utils.config import config_to_json as jax_json
    from pb_sed_tpu_torch.experiments.core import parse_cli_overrides
    from pb_sed_tpu_torch.experiments.weak_label_crnn import training
    from pb_sed_tpu_torch.ops.rnn import TransformerEncoder
    from pb_sed_tpu_torch.utils.config import config_to_json
    argv = ['with', 'timestamp=t', 'group_name=g', 'storage_dir=/nowhere',
            'trainer.steps_per_call=4', 'trainer.profile_at=3',
            'trainer.profile_num_steps=2',
            'trainer.model.cnn.cnn_2d.dropout=0.1',
            'trainer.model.cnn.cnn_1d.dropout=0.1',
            'trainer.model.rnn_fwd.rnn.dropout=0.2',
            'trainer.model.rnn_fwd.factory={}.TransformerEncoder']
    configs = {}
    for name, module, package in (('port', training, 'pb_sed_tpu_torch'),
                                  ('jax', jtraining, 'pb_sed_tpu')):
        updates = parse_cli_overrides(
            argv[:-1] + [argv[-1].format(f'{package}.ops.rnn')])
        cfg = module.ex.build_config(updates)
        to_json = config_to_json if name == 'port' else jax_json
        configs[name] = to_json(dict(cfg['trainer']))
    port = configs['port']
    for key, value in (('steps_per_call', 4), ('profile_at', 3),
                       ('profile_num_steps', 2)):
        assert port[key] == value
    assert port['model']['rnn_bwd']['reverse'] is True
    assert port['model']['rnn_fwd']['rnn']['dropout'] == .2
    assert port['model']['cnn']['cnn_2d']['dropout'] == .1
    text = repr(configs['jax']).replace("'pb_sed_tpu.", "'pb_sed_tpu_torch.")
    assert repr(port) == text
    trainer = Trainer.from_config(training.ex.build_config(
        parse_cli_overrides(argv[:-1] + [argv[-1].format(
            'pb_sed_tpu_torch.ops.rnn')]))['trainer'])
    module = trainer.model.module
    assert isinstance(module.rnn_fwd, TransformerEncoder)
    assert isinstance(module.rnn_bwd, TransformerEncoder)
    assert module.rnn_bwd.reverse and not module.rnn_fwd.reverse
    assert module.rnn_fwd.num_layers == 2 and module.rnn_fwd.dropout == .2
    assert module.rnn_fwd.num_heads == 8 and module.rnn_fwd.d_ff == 1024
    assert module.cnn.cnn_2d.dropout == .1 and not module.cnn.cnn_2d.fused
    assert trainer.steps_per_call == 4 and trainer.profile_at == 3
    assert jax.devices()[0].platform == 'cpu'


def _events(storage_dir):
    """(scalars {tag: [(step, value)]}, images {tag: [(step, width,
    height)]}) of the event files in ``storage_dir``, read back with
    tensorboard's event reader."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)
    acc = EventAccumulator(str(storage_dir), size_guidance={
        'scalars': 0, 'images': 0})
    acc.Reload()
    tags = acc.Tags()
    return ({tag: [(e.step, e.value) for e in acc.Scalars(tag)]
             for tag in tags['scalars']},
            {tag: [(e.step, e.width, e.height) for e in acc.Images(tag)]
             for tag in tags['images']})


def test_tensorboard_events_match_the_jax_trainer(flat, tmp_path):
    """Two summaries (one a step) of the port's trainer and of the JAX
    trainer (``use_mesh=False``, its XLA path) on the same two steps: the
    event files hold the same scalar tags at the same steps, with values
    within ``1e-4 + 3e-2 * |ref|`` (the loss rule of ``tests/
    test_torch_train.py``; ``steps_per_second`` is each host's clock),
    and the same 2-D image (the features' grid) at the same steps and
    size; the port's event scalars are its ``summary.jsonl`` lines."""
    import json
    from pb_sed_tpu.ops import rnn as jrnn
    batches = [_train_batch(seed) for seed in (1, 2)]
    kwargs = dict(summary_trigger=(1, 'iteration'),
                  checkpoint_trigger=(100, 'iteration'),
                  stop_trigger=(2, 'iteration'))
    jax_dir, port_dir = tmp_path / 'jax', tmp_path / 'port'
    jrnn.set_pallas_mode('off')
    try:
        trainer = JaxTrainer(_jax_model(flat), storage_dir=jax_dir,
                             use_mesh=False, **kwargs)
        trainer.train(batches)
        # the JAX trainer flushes its tensorboardX writer, which leaves the
        # events its writer thread still queues unwritten: closed here
        # before the files are read (the port's trainer closes its own)
        if trainer._writer:
            trainer._writer.close()
    finally:
        jrnn.set_pallas_mode('auto')
    Trainer(_port_model(flat), storage_dir=port_dir, **kwargs).train(
        batches)
    scalars, images = _events(port_dir)
    ref_scalars, ref_images = _events(jax_dir)
    assert sorted(scalars) == sorted(ref_scalars)
    assert {'training/loss', 'training/grad_norm', 'training/lr'} <= set(
        scalars)
    for tag, ref in ref_scalars.items():
        got = scalars[tag]
        assert [s for s, _ in got] == [s for s, _ in ref] == (
            [2] if tag.endswith('steps_per_second') else [1, 2]), tag
        if not tag.endswith('steps_per_second'):
            for (_, value), (_, ref_value) in zip(got, ref):
                assert abs(value - ref_value) <= 1e-4 + 3e-2 * abs(
                    ref_value), (tag, got, ref)
    assert images == ref_images
    assert list(images) == ['training/features']
    lines = [json.loads(line) for line in
             (port_dir / 'summary.jsonl').read_text().splitlines()]
    assert [line['iteration'] for line in lines] == [1, 2]
    for line in lines:
        for key, value in line.items():
            if key in ('iteration', 'prefix', 'time'):
                continue
            (event,) = [v for s, v in scalars[f'{line["prefix"]}/{key}']
                        if s == line['iteration']]
            assert event == pytest.approx(value, rel=1e-6, abs=1e-12), key
