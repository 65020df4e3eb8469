"""Trainer: the training loop of the JAX package's ``Trainer``
(``pb_sed_tpu/train/trainer.py``) on one device, eagerly.

What it does, with the JAX surface: ``__init__`` triggers
(``(N, 'iteration')`` summary / checkpoint / stop), ``register_hook``
(``LRAnnealingHook``), ``train(train_set, resume=...)``,
``train_step(batch)``, ``freeze(predicate, freeze_norm_stats)``,
``register_validation_hook`` / ``validate`` (metric tracking,
``ckpt_best_<metric>.pkl``, learning-rate back-off, early stopping),
``test_run``, ``save_checkpoint`` and ``load_latest_checkpoint``. One
step:

    lr = optimizer.lr * lr_factor_backoff * interp(iteration, xs, ys)
    with dropout_rng(dropout_generator):
        loss, aux = model.loss(batch, generator)   # module in train mode
    loss.backward()                                # the backward kernels
    updates = Adam(grads)  (grad_norm of the raw gradients)
    frozen updates -> 0;  p <- p - lr * u;  frozen BN stats restored

The learning-rate schedule is the one ``LRAnnealingHook``'s breakpoints,
interpolated at the iteration before the step as the JAX step does
(``trainer.py:184-193``). The step runs on the model's device: the card,
unless the model was built or moved with ``device='cpu'``
(``models/base/model.py:default_device``). The augmentation draws from a
``torch.Generator`` on that device, seeded with ``seed``, and dropout
from another, seeded from ``seed`` apart from it (:func:`dropout_seed`;
the JAX step's ``augment`` and ``dropout`` streams): a model without
dropout draws the augmentation it drew before dropout was ported.
Checkpoints are ``{'model': flat, 'iteration', 'epoch',
'lr_factor_backoff', 'optimizer', 'rng', 'dropout_rng'}`` pickles with
the model in the JAX package's flat layout (``bridge.py``), so both
packages restore the model; the optimizer state is the port's own layout
(``{'count': int, 'mu': {flat key: array}, 'nu': {...}}``) and the rngs
the generators' states (a checkpoint without ``dropout_rng``, an older
one or the JAX trainer's, leaves the dropout generator at its seed's
state). ``summary.jsonl`` gets one line per summary
trigger (prefix ``training``) and per validation (prefix ``validation``):
``{'iteration', 'prefix', 'time', **scalars}``, the scalars being the
means of the steps' scalars and the metrics the model computes from the
steps' buffered clip scores (``SoundEventModel.modify_summary``:
``macro_fscore_weak``, ``lwlrap_weak``, ...). Validation runs after each
checkpoint trigger and at the end of ``train``, with the module in eval
mode under ``torch.no_grad()``.

The multi-step lane (``steps_per_call = K > 1``, the JAX trainer's
``trainer.py:319-324, 401-475``): ``train`` buffers batches of one shape
(a batch of another shape drains the buffer first) and runs K of them as
one :meth:`train_steps` call, K steps of the one step body in a loop,
each reading the learning rate at its own iteration; hooks see one
``pre_step`` and one ``post_step`` (with the last batch and the (K,)
losses) a call, the call's scalars enter the summary K-stacked (one
entry, as JAX's), and the triggers are polled after the call: the
interval triggers fire on crossings, and the stop check sits in the
batch loop, so a run may end up to K - 1 steps past its stop trigger, as
JAX's does. The call runs eagerly.

The profiler (``profile_at``, ``profile_num_steps``; the JAX trainer's
``trainer.py:338-367``): with a ``storage_dir``, a ``torch.profiler``
trace (``utils/profiling.py:torch_profile``) starts before the step
whose iteration crosses ``profile_at`` and stops once ``iteration >=
profile_at + profile_num_steps``, or when ``train`` ends; it goes to
``<storage_dir>/profile`` as a Chrome trace. Each profiled step runs in
a ``record_function`` window named ``train_step_<iteration>`` that ends
with a device synchronize, and the host and device milliseconds of each
window are printed from the trace.

``use_mesh`` and ``loss_scale`` are accepted for config compatibility:
the port trains on the model's one device, and the JAX trainer never
reads ``loss_scale``.
"""
import contextlib
import json
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from pb_sed_tpu_torch.bridge import param_keys
from pb_sed_tpu_torch.ops.dropout import dropout_rng
from pb_sed_tpu_torch.train.emissions import EmissionsTracker
from pb_sed_tpu_torch.train.hooks import (EndTrigger, Hook, IntervalTrigger,
                                          LRAnnealingHook)
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.utils.checkpoint import adam_moments, load_payload
from pb_sed_tpu_torch.utils.config import Configurable
from pb_sed_tpu_torch.utils.profiling import step_times_ms, torch_profile


def dropout_seed(seed):
    """The dropout generator's seed, drawn from ``seed`` apart from the
    augmentation generator's (``seed`` itself)."""
    return int(np.random.SeedSequence([seed, 1]).generate_state(1)[0])


class Trainer(Configurable):
    def __init__(self, model, optimizer=None, storage_dir=None,
                 summary_trigger=(100, 'iteration'),
                 checkpoint_trigger=(1000, 'iteration'),
                 stop_trigger=(10000, 'iteration'),
                 keep_checkpoints=1, seed=0, use_mesh=True,
                 loss_scale=None, steps_per_call=1,
                 profile_at=None, profile_num_steps=3):
        self.model = model
        self.optimizer = optimizer if optimizer is not None else Adam()
        self.storage_dir = Path(storage_dir) if storage_dir else None
        self.summary_trigger = IntervalTrigger(summary_trigger)
        self.checkpoint_trigger = IntervalTrigger(checkpoint_trigger)
        self.stop_trigger = EndTrigger(stop_trigger)
        self.keep_checkpoints = keep_checkpoints
        self.seed = seed
        self.iteration = 0
        self.epoch = 0
        self.hooks = []
        self.lr_factor_annealing = 1.
        self.lr_factor_backoff = 1.
        self.validation_hook = None
        self.opt_state = None
        self.generator = None
        self.dropout_generator = None
        self.steps_per_call = steps_per_call
        self.profile_at = profile_at
        self.profile_num_steps = profile_num_steps
        self._profile = None        # the open trace of the profiled steps
        self._profile_done = False
        self._batch_buffer = []
        self._frozen = set()
        self._frozen_stats = set()
        self._summary = _empty_summary()
        self._last_flush = None

    @classmethod
    def finalize_dogmatic_config(cls, config):
        config['optimizer'] = {'factory': Adam}

    # -- registration ---------------------------------------------------------
    def register_hook(self, hook):
        if not isinstance(hook, Hook):
            # A hook of another package (e.g. the JAX package's
            # LRAnnealingHook) would be silently ignored by the schedule.
            raise TypeError(
                f'expected a pb_sed_tpu_torch.train.hooks.Hook (e.g. '
                f'pb_sed_tpu_torch.train.hooks.LRAnnealingHook), got '
                f'{type(hook).__module__}.{type(hook).__qualname__}')
        self.hooks.append(hook)

    def register_validation_hook(
            self, validate_set, metric='loss', maximize=False,
            back_off_patience=None, n_back_off=0, lr_update_factor=1.,
            early_stopping_patience=None):
        """Validate on ``validate_set`` after every checkpoint trigger and
        at the end of training: track ``metric``, keep the best model as
        ``ckpt_best_<metric>.pkl``, scale ``lr_factor_backoff`` by
        ``lr_update_factor`` after ``back_off_patience`` validations
        without a gain (at most ``n_back_off`` times) and stop after
        ``early_stopping_patience`` of them."""
        self.validation_hook = {
            'validate_set': validate_set,
            'metric': metric,
            'maximize': maximize,
            'back_off_patience': back_off_patience,
            'n_back_off': n_back_off,
            'back_offs_done': 0,
            'lr_update_factor': lr_update_factor,
            'early_stopping_patience': early_stopping_patience,
            'best': -np.inf if maximize else np.inf,
            'validations_since_best': 0,
        }

    def freeze(self, predicate, freeze_norm_stats=True):
        """Freeze the parameters whose path (the flat key without
        ``params.``) satisfies ``predicate``: they get zero updates; with
        ``freeze_norm_stats`` the matching running statistics (path
        without ``batch_stats.``) are restored after each step."""
        module = self.model.module
        self._frozen = {name for name, _ in module.named_parameters()
                        if predicate(name)}
        params = {name for name, _ in module.named_parameters()}
        self._frozen_stats = (
            {name for name in module.state_dict()
             if name not in params and predicate(name)}
            if freeze_norm_stats else set())

    def num_frozen(self):
        """How many tensors (parameters and running statistics)
        :meth:`freeze` froze."""
        return len(self._frozen) + len(self._frozen_stats)

    # -- learning rate --------------------------------------------------------
    def _annealing_points(self):
        """The one iteration-unit LRAnnealingHook's breakpoints (xs, ys),
        or None (the JAX trainer's rule, ``trainer.py:145-168``)."""
        hooks = [h for h in self.hooks
                 if isinstance(h, LRAnnealingHook) and h.breakpoints]
        if not hooks:
            return None
        if len(hooks) > 1:
            raise NotImplementedError(
                'multiple LRAnnealingHooks: merge the breakpoints into one')
        if hooks[0].unit != 'iteration':
            raise NotImplementedError(
                f'LRAnnealingHook(unit={hooks[0].unit!r}): the schedule '
                f'interpolates over iterations')
        xs = np.array([float(x) for x, _ in hooks[0].breakpoints])
        ys = np.array([float(y) for _, y in hooks[0].breakpoints])
        return xs, ys

    def step_lr(self):
        """The learning rate of the next step."""
        lr = np.float32(self.optimizer.lr) * np.float32(self.lr_factor_backoff)
        points = self._annealing_points()
        if points is not None:
            lr = lr * np.float32(np.interp(np.float32(self.iteration),
                                           *points))
        return float(lr)

    # -- train loop -----------------------------------------------------------
    def _ensure_ready(self):
        """Place the model, initialize its weights from ``seed`` if none
        were loaded (as the JAX trainer initializes the variables of a
        model that has none), and create the optimizer state and the
        generator. Returns the parameters."""
        device = self.model.placed_device()
        if self.opt_state is None and self.model.as_constructed():
            self.model.init_parameters(self.seed)
            print(f'Initialized the parameters from seed {self.seed}')
        params = [p for _, p in self.model.module.named_parameters()]
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(params)
        if self.generator is None:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(self.seed)
            self.dropout_generator = torch.Generator(device=device)
            self.dropout_generator.manual_seed(dropout_seed(self.seed))
        return params

    def train(self, train_set, resume=False, device=None,
              track_emissions=False):
        """Train until the stop trigger; with ``track_emissions`` (and a
        ``storage_dir``) the run's estimated energy goes to
        ``<storage_dir>/emissions.csv`` (``train/emissions.py``)."""
        if device is not None:
            self.model.to(device)
        tracker = None
        if track_emissions and self.storage_dir is not None:
            tracker = EmissionsTracker(output_dir=self.storage_dir)
            tracker.start()
        try:
            if resume:
                self.load_latest_checkpoint()
            first_iteration = self.iteration
            while not self.stop_trigger(self.iteration, self.epoch):
                for batch in train_set:
                    if self.stop_trigger(self.iteration, self.epoch):
                        break
                    if self.steps_per_call > 1:
                        self._enqueue_batch(batch)
                    else:
                        self.train_step(batch)
                self._drain_batch_buffer()
                self.epoch += 1
            # final validation and checkpoint (resuming a run that had
            # finished takes no step and validates nothing)
            self._flush_summary(prefix='training')
            if (self.validation_hook is not None
                    and self.iteration > first_iteration):
                self.validate()
            self.save_checkpoint()
        finally:
            self._maybe_stop_profile(force=True)
            if tracker is not None:
                tracker.stop()

    # -- profiler -------------------------------------------------------------
    def _maybe_start_profile(self):
        # a crossing (>=): the multi-step lane advances the iteration in
        # strides and can step over an exact profile_at
        if (self.profile_at is not None and self._profile is None
                and not self._profile_done
                and self.iteration + 1 >= self.profile_at
                and self.storage_dir is not None):
            cuda = self.model.placed_device().type == 'cuda'
            self._profile = torch_profile(self.storage_dir / 'profile',
                                          cuda=cuda).__enter__()

    def _maybe_stop_profile(self, force=False):
        if self._profile is None or not (
                force or self.iteration
                >= self.profile_at + self.profile_num_steps):
            return
        trace, self._profile = self._profile, None
        self._profile_done = True
        trace.__exit__(None, None, None)
        print(f'Profiler trace written to {trace.path}')
        for step, (host, device) in step_times_ms(trace.path).items():
            print(f'Profiled step {step}: {host:.2f} ms on the host, '
                  f'{device:.2f} ms of device work (trace)')

    @contextlib.contextmanager
    def _step_window(self):
        """While profiling: the step as a ``record_function`` window
        ``train_step_<iteration>`` that ends once the device is done."""
        if self._profile is None:
            yield
            return
        with torch.profiler.record_function(
                f'train_step_{self.iteration + 1}'):
            yield
            if self._profile.cuda:
                torch.cuda.synchronize()

    # -- steps ----------------------------------------------------------------
    def _step(self, params, batch):
        """One optimizer step on ``batch``, the body of both lanes;
        returns ``(loss, scalars, buffers)`` as device tensors."""
        module = self.model.module
        lr = self.step_lr()
        frozen_stats = {name: t.detach().clone()
                        for name, t in module.state_dict().items()
                        if name in self._frozen_stats}
        module.train()
        with self._step_window():
            for p in params:
                p.grad = None
            with dropout_rng(self.dropout_generator):
                loss, aux = self.model.loss(self.model.to_device(batch),
                                            self.generator)
            loss.backward()
            grads = [torch.zeros_like(p) if p.grad is None else p.grad
                     for p in params]
            updates, grad_norm = self.optimizer.update(
                grads, self.opt_state, params)
            with torch.no_grad():
                for i, (name, _) in enumerate(module.named_parameters()):
                    if name in self._frozen:
                        updates[i].zero_()
                torch._foreach_add_(params, updates, alpha=-lr)
                state = module.state_dict()
                for name, saved in frozen_stats.items():
                    state[name].copy_(saved)
            for p in params:
                p.grad = None
        self.iteration += 1
        # device tensors: they are read on the host only at a flush
        scalars = dict(aux['scalars'], loss=loss.detach(),
                       grad_norm=grad_norm, lr=lr)
        return loss.detach(), scalars, aux['buffers']

    def _after_call(self, scalars, buffers):
        """Summary entry and triggers after a call of either lane."""
        for key, value in scalars.items():
            self._summary['scalars'].setdefault(key, []).append(value)
        self._summary['raw'].append(buffers)
        if self.summary_trigger(self.iteration, self.epoch):
            self._flush_summary(prefix='training')
        if self.checkpoint_trigger(self.iteration, self.epoch):
            self.save_checkpoint()
            if self.validation_hook is not None:
                self.validate()

    def train_step(self, batch):
        """One optimizer step on ``batch`` (numpy arrays or tensors);
        returns the loss (a 0-dim device tensor)."""
        params = self._ensure_ready()
        self._maybe_start_profile()
        for hook in self.hooks:
            hook.pre_step(self)
        loss, scalars, buffers = self._step(params, batch)
        self._after_call(scalars, buffers)
        for hook in self.hooks:
            hook.post_step(self, batch, loss, None)
        self._maybe_stop_profile()
        return loss

    # -- the multi-step lane (steps_per_call > 1) ----------------------------
    def _enqueue_batch(self, batch):
        if self._batch_buffer and not _same_shapes(self._batch_buffer[0],
                                                   batch):
            self._drain_batch_buffer()
        self._batch_buffer.append(batch)
        if len(self._batch_buffer) >= self.steps_per_call:
            self._drain_batch_buffer()

    def _drain_batch_buffer(self):
        batches, self._batch_buffer = self._batch_buffer, []
        if len(batches) == 1:
            self.train_step(batches[0])
        elif batches:
            self.train_steps(batches)

    def train_steps(self, batches):
        """``len(batches)`` optimizer steps as one call (batches of one
        shape); returns the (K,) losses. The same values as as many
        :meth:`train_step` calls; the summary gets the call's scalars
        K-stacked, and the triggers are polled after the call."""
        params = self._ensure_ready()
        self._maybe_start_profile()
        for hook in self.hooks:
            hook.pre_step(self)
        steps = [self._step(params, batch) for batch in batches]
        device = steps[0][0].device
        losses = torch.stack([loss for loss, _, _ in steps])
        scalars = {key: torch.stack([
            torch.as_tensor(s[key], dtype=torch.float32, device=device)
            for _, s, _ in steps]) for key in steps[0][1]}
        buffers = {key: torch.cat([b[key] for _, _, b in steps])
                   for key in steps[0][2]}
        self._after_call(scalars, buffers)
        for hook in self.hooks:
            hook.post_step(self, batches[-1], losses, None)
        self._maybe_stop_profile()
        return losses

    # -- validation -----------------------------------------------------------
    def _validation_loss(self, batch):
        """``model.loss`` on ``batch`` in eval mode without gradients."""
        self.model.module.eval()
        with torch.no_grad():
            return self.model.loss(self.model.to_device(batch), None)

    def validate(self):
        """One pass over the validation set: the summary line, then the
        hook's policy on its metric. Returns the metric's value."""
        hook = self.validation_hook
        summary = _empty_summary()
        for batch in hook['validate_set']:
            loss, aux = self._validation_loss(batch)
            summary['scalars'].setdefault('loss', []).append(float(loss))
            for key, value in aux['scalars'].items():
                summary['scalars'].setdefault(key, []).append(float(value))
            summary['raw'].append(aux['buffers'])
        summary = self._reviewed(summary)
        self._write_summary(summary['scalars'], prefix='validation')
        metric_name = hook['metric']
        value = summary['scalars'].get(metric_name)
        if value is None:
            raise KeyError(f'the validation summary has no {metric_name!r}: '
                           f'{sorted(summary["scalars"])}')
        improved = (value > hook['best'] if hook['maximize']
                    else value < hook['best'])
        if improved:
            hook['best'] = value
            hook['validations_since_best'] = 0
            self.save_checkpoint(name=f'ckpt_best_{metric_name}.pkl')
        else:
            hook['validations_since_best'] += 1
            patience = hook['back_off_patience']
            if (patience is not None
                    and hook['back_offs_done'] < hook['n_back_off']
                    and hook['validations_since_best'] >= patience):
                self.lr_factor_backoff *= hook['lr_update_factor']
                hook['back_offs_done'] += 1
                hook['validations_since_best'] = 0
                print(f'Backing off lr to {self.learning_rate}')
        print(f'Validation {metric_name}: {value:.4f} '
              f'(best {hook["best"]:.4f})')
        es = hook['early_stopping_patience']
        if es is not None and hook['validations_since_best'] >= es:
            print('Early stopping')
            self.stop_trigger.period = 0
        return value

    @property
    def learning_rate(self):
        return (self.optimizer.lr * self.lr_factor_annealing
                * self.lr_factor_backoff)

    def test_run(self, train_set, validate_set=None):
        """A forward and backward pass on the first training batch and a
        validation pass on the first validation batch, with nothing kept:
        no update, no trigger, no checkpoint, no summary; the running
        statistics the training-mode forward moved and the generators'
        states are restored. Raises if a loss is not finite."""
        print('Starting test run')
        module = self.model.module
        params = self._ensure_ready()
        rng_states = [(g, g.get_state())
                      for g in (self.generator, self.dropout_generator)]
        buffers = [(b, b.detach().clone()) for b in module.buffers()]
        module.train()
        with dropout_rng(self.dropout_generator):
            loss, _ = self.model.loss(
                self.model.to_device(next(iter(train_set))), self.generator)
        loss.backward()
        loss = loss.detach()
        for p in params:
            p.grad = None
        with torch.no_grad():
            for buffer, saved in buffers:
                buffer.copy_(saved)
        for generator, state in rng_states:
            generator.set_state(state)
        if not np.isfinite(float(loss)):
            raise FloatingPointError(f'test run: training loss {float(loss)}')
        if validate_set is not None:
            vloss, _ = self._validation_loss(next(iter(validate_set)))
            if not np.isfinite(float(vloss)):
                raise FloatingPointError(
                    f'test run: validation loss {float(vloss)}')
        print('Finished test run')

    # -- summaries ------------------------------------------------------------
    def _reviewed(self, summary):
        """``summary`` with its steps' raw buffers reviewed by the model
        (``review_from_aux``: the labeled examples' scores on the host)
        and the model's ``modify_summary`` applied: scalar means and the
        buffered scores' metrics."""
        for buffers in summary.pop('raw'):
            review = self.model.review_from_aux(
                0., {'scalars': {}, 'buffers': buffers})
            for key, value in review['buffers'].items():
                summary['buffers'].setdefault(key, []).append(value)
        return self.model.modify_summary(summary)

    def _flush_summary(self, prefix):
        """Mean of each scalar since the last flush (converted to host
        floats only here) and the metrics of the buffered scores as one
        ``summary.jsonl`` line."""
        if not self._summary['scalars']:
            return
        summary, self._summary = self._summary, _empty_summary()
        # a multi-step call's entry is (K,)-stacked: its mean, as JAX's
        summary['scalars'] = {key: [_host_mean(v) for v in values]
                              for key, values in summary['scalars'].items()}
        now = time.time()
        if self._last_flush is not None:
            it_last, t_last = self._last_flush
            summary['scalars']['steps_per_second'] = [
                (self.iteration - it_last) / max(now - t_last, 1e-9)]
        self._last_flush = (self.iteration, now)
        summary = self._reviewed(summary)
        self._write_summary(summary['scalars'], prefix=prefix)

    def _write_summary(self, scalars, prefix):
        if self.storage_dir is None:
            return
        self.storage_dir.mkdir(parents=True, exist_ok=True)
        with (self.storage_dir / 'summary.jsonl').open('a') as fid:
            fid.write(json.dumps({'iteration': self.iteration,
                                  'prefix': prefix, 'time': time.time(),
                                  **scalars}) + '\n')

    # -- checkpointing --------------------------------------------------------
    @property
    def checkpoint_dir(self):
        if self.storage_dir is None:
            raise ValueError('the trainer has no storage_dir')
        return self.storage_dir / 'checkpoints'

    def _optimizer_payload(self):
        if self.opt_state is None:
            return None
        names = param_keys(self.model.module)
        return {'count': self.opt_state['count'],
                **{key: {n: t.detach().cpu().numpy()
                         for n, t in zip(names, self.opt_state[key])}
                   for key in ('mu', 'nu')}}

    def save_checkpoint(self, name=None):
        if self.storage_dir is None:
            return
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        payload = {
            'model': self.model.state_dict(),
            'iteration': self.iteration,
            'epoch': self.epoch,
            'lr_factor_backoff': self.lr_factor_backoff,
            'optimizer': self._optimizer_payload(),
            'rng': (None if self.generator is None
                    else self.generator.get_state().numpy()),
            'dropout_rng': (None if self.dropout_generator is None
                            else self.dropout_generator.get_state().numpy()),
        }
        if name is None:
            path = self.checkpoint_dir / f'ckpt_{self.iteration}.pkl'
            with path.open('wb') as fid:
                pickle.dump(payload, fid)
            shutil.copyfile(path, self.checkpoint_dir / 'ckpt_latest.pkl')
            ckpts = sorted(self.checkpoint_dir.glob('ckpt_[0-9]*.pkl'),
                           key=lambda p: int(p.stem.split('_')[1]))
            for old in ckpts[:-max(self.keep_checkpoints, 1)]:
                old.unlink()
        else:
            with (self.checkpoint_dir / name).open('wb') as fid:
                pickle.dump(payload, fid)

    def load_latest_checkpoint(self):
        """Resume from ``ckpt_latest.pkl``, written by this trainer or by
        the JAX package's (read with ``utils.checkpoint.load_payload``,
        which needs no optax for the latter's optimizer state). Adam's
        moments are restored by flat parameter key from either; a state
        that holds none raises a ``ValueError`` naming the cause. The JAX
        trainer's rng is a uint32 key, not a ``torch.Generator`` state:
        the generator then keeps the state its seed gave it, and the log
        says so. A checkpoint without ``dropout_rng`` (the JAX trainer's,
        or one written before dropout was ported) leaves the dropout
        generator at its seed's state. Returns whether a checkpoint was
        found."""
        path = self.checkpoint_dir / 'ckpt_latest.pkl'
        if not path.exists():
            print('No checkpoint to resume from')
            return False
        payload = load_payload(path)
        self.model.load_state_dict(payload['model'])
        self.iteration = payload['iteration']
        self.epoch = payload.get('epoch', 0)
        self.lr_factor_backoff = payload.get('lr_factor_backoff', 1.)
        self._ensure_ready()
        if payload.get('optimizer') is not None:
            count, mu, nu = adam_moments(payload['optimizer'])
            names = param_keys(self.model.module)
            missing = [n for n in names if n not in mu or n not in nu]
            if missing:
                raise KeyError(f'the optimizer state of {path} has no '
                               f'moments for {missing}')
            self.opt_state['count'] = count
            for key, moments in (('mu', mu), ('nu', nu)):
                for t, n in zip(self.opt_state[key], names):
                    t.copy_(torch.from_numpy(
                        np.array(moments[n], np.float32)).reshape(t.shape))
        if payload.get('rng') is not None:
            rng = np.asarray(payload['rng'])
            if rng.dtype == np.uint8:
                self.generator.set_state(torch.from_numpy(rng.copy()))
            else:
                print(f'The rng of {path} is a JAX key ({rng.dtype}, shape '
                      f'{rng.shape}), not a torch.Generator state: the '
                      f'generator keeps the state of seed {self.seed}')
        if payload.get('dropout_rng') is not None:
            self.dropout_generator.set_state(torch.from_numpy(
                np.asarray(payload['dropout_rng']).copy()))
        for trigger in (self.checkpoint_trigger, self.summary_trigger):
            if trigger.unit == 'iteration':
                trigger.last = self.iteration
        print(f'Resumed from iteration {self.iteration}')
        return True


def _empty_summary():
    return {'scalars': {}, 'buffers': {}, 'raw': []}


def _host_mean(value):
    """A summary entry (a number, a 0-dim or (K,) tensor) as a float."""
    if isinstance(value, torch.Tensor):
        return float(value.float().mean())
    return float(np.mean(value))


def _same_shapes(batch_a, batch_b):
    """Whether ``batch_b`` has every array of ``batch_a`` in its shape
    (the JAX trainer's ``_same_shapes``)."""
    for key, value in batch_a.items():
        if isinstance(value, (np.ndarray, torch.Tensor)):
            other = batch_b.get(key)
            if other is None or np.shape(other) != np.shape(value):
                return False
    return True
