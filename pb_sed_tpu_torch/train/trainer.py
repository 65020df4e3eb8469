"""Trainer: the training loop of the JAX package's ``Trainer``
(``pb_sed_tpu/train/trainer.py``) on one device, eagerly.

What it does, with the JAX surface: ``__init__`` triggers
(``(N, 'iteration')`` summary / checkpoint / stop), ``register_hook``
(``LRAnnealingHook``), ``train(train_set, resume=...)``,
``train_step(batch)``, ``freeze(predicate, freeze_norm_stats)``,
``save_checkpoint`` and ``load_latest_checkpoint``. One step:

    lr = optimizer.lr * lr_factor_backoff * interp(iteration, xs, ys)
    loss, aux = model.loss(batch, generator)       # module in train mode
    loss.backward()                                # the backward kernels
    updates = Adam(grads)  (grad_norm of the raw gradients)
    frozen updates -> 0;  p <- p - lr * u;  frozen BN stats restored

The learning-rate schedule is the one ``LRAnnealingHook``'s breakpoints,
interpolated at the iteration before the step as the JAX step does
(``trainer.py:184-193``). The step runs on the model's device: the card,
unless the model was built or moved with ``device='cpu'``
(``models/base/model.py:default_device``). The augmentation draws from a
``torch.Generator`` on that device, seeded with ``seed``.
Checkpoints are ``{'model': flat, 'iteration', 'epoch',
'lr_factor_backoff', 'optimizer', 'rng'}`` pickles with the model in the
JAX package's flat layout (``bridge.py``), so both packages restore the
model; the optimizer state is the port's own layout
(``{'count': int, 'mu': {flat key: array}, 'nu': {...}}``) and the rng
the generator's state. ``summary.jsonl`` gets one line per summary
trigger: ``{'iteration', 'prefix', 'time', **mean scalars}``.

Not ported yet (raise): validation hooks with back-off and early
stopping, the multi-step lane (``steps_per_call > 1``), the profiler
(``profile_at``), emissions tracking. ``use_mesh`` and ``loss_scale`` are
accepted for config compatibility: the port trains on the model's one
device, and the JAX trainer never reads ``loss_scale``.
"""
import json
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from pb_sed_tpu_torch.bridge import param_keys
from pb_sed_tpu_torch.train.hooks import (EndTrigger, Hook, IntervalTrigger,
                                          LRAnnealingHook)
from pb_sed_tpu_torch.train.optimizer import Adam
from pb_sed_tpu_torch.utils.config import Configurable


class Trainer(Configurable):
    def __init__(self, model, optimizer=None, storage_dir=None,
                 summary_trigger=(100, 'iteration'),
                 checkpoint_trigger=(1000, 'iteration'),
                 stop_trigger=(10000, 'iteration'),
                 keep_checkpoints=1, seed=0, use_mesh=True,
                 loss_scale=None, steps_per_call=1,
                 profile_at=None, profile_num_steps=3):
        if steps_per_call != 1:
            raise NotImplementedError(
                'steps_per_call > 1 (the multi-step lane) is not ported yet')
        if profile_at is not None:
            raise NotImplementedError('the profiler hook is not ported yet')
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
        self.opt_state = None
        self.generator = None
        self._frozen = set()
        self._frozen_stats = set()
        self._summary = {}
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

    def register_validation_hook(self, *args, **kwargs):
        raise NotImplementedError(
            'validation hooks (metric tracking, back-off, early stopping) '
            'are not ported yet')

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
        device = self.model.placed_device()
        params = [p for _, p in self.model.module.named_parameters()]
        if self.opt_state is None:
            self.opt_state = self.optimizer.init(params)
        if self.generator is None:
            self.generator = torch.Generator(device=device)
            self.generator.manual_seed(self.seed)
        return params

    def train(self, train_set, resume=False, device=None,
              track_emissions=False):
        if track_emissions:
            raise NotImplementedError('emissions tracking is not ported yet')
        if device is not None:
            self.model.to(device)
        if resume:
            self.load_latest_checkpoint()
        while not self.stop_trigger(self.iteration, self.epoch):
            for batch in train_set:
                if self.stop_trigger(self.iteration, self.epoch):
                    break
                self.train_step(batch)
            self.epoch += 1
        self._flush_summary(prefix='training')
        self.save_checkpoint()

    def train_step(self, batch):
        """One optimizer step on ``batch`` (numpy arrays or tensors);
        returns the loss (a 0-dim device tensor)."""
        module = self.model.module
        params = self._ensure_ready()
        for hook in self.hooks:
            hook.pre_step(self)
        lr = self.step_lr()
        frozen_stats = {name: t.detach().clone()
                        for name, t in module.state_dict().items()
                        if name in self._frozen_stats}
        module.train()
        for p in params:
            p.grad = None
        loss, aux = self.model.loss(self.model.to_device(batch),
                                    self.generator)
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        updates, grad_norm = self.optimizer.update(grads, self.opt_state,
                                                   params)
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
        scalars = dict(aux['scalars'], loss=loss.detach(),
                       grad_norm=grad_norm, lr=lr)
        for key, value in scalars.items():
            self._summary.setdefault(key, []).append(value)
        if self.summary_trigger(self.iteration, self.epoch):
            self._flush_summary(prefix='training')
        if self.checkpoint_trigger(self.iteration, self.epoch):
            self.save_checkpoint()
        for hook in self.hooks:
            hook.post_step(self, batch, loss, None)
        return loss.detach()

    # -- summaries ------------------------------------------------------------
    def _flush_summary(self, prefix):
        """Mean of each scalar since the last flush (converted to host
        floats only here) as one ``summary.jsonl`` line."""
        if not self._summary:
            return
        scalars = {key: float(np.mean([float(v) for v in values]))
                   for key, values in self._summary.items()}
        self._summary = {}
        now = time.time()
        if self._last_flush is not None:
            it_last, t_last = self._last_flush
            scalars['steps_per_second'] = (
                (self.iteration - it_last) / max(now - t_last, 1e-9))
        self._last_flush = (self.iteration, now)
        if self.storage_dir is None:
            return
        self.storage_dir.mkdir(parents=True, exist_ok=True)
        with (self.storage_dir / 'summary.jsonl').open('a') as fid:
            fid.write(json.dumps({'iteration': self.iteration,
                                  'prefix': prefix, 'time': now,
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
        """Resume from ``ckpt_latest.pkl`` (written by this trainer; only
        load checkpoints you trust: unpickling runs code). Returns
        whether one was found."""
        path = self.checkpoint_dir / 'ckpt_latest.pkl'
        if not path.exists():
            print('No checkpoint to resume from')
            return False
        with path.open('rb') as fid:
            payload = pickle.load(fid)
        self.model.load_state_dict(payload['model'])
        self.iteration = payload['iteration']
        self.epoch = payload.get('epoch', 0)
        self.lr_factor_backoff = payload.get('lr_factor_backoff', 1.)
        self._ensure_ready()
        optimizer = payload.get('optimizer')
        if isinstance(optimizer, dict) and 'mu' in optimizer:
            names = param_keys(self.model.module)
            self.opt_state['count'] = int(optimizer['count'])
            for key in ('mu', 'nu'):
                for t, n in zip(self.opt_state[key], names):
                    t.copy_(torch.from_numpy(np.asarray(optimizer[key][n])))
        if payload.get('rng') is not None:
            self.generator.set_state(torch.from_numpy(
                np.asarray(payload['rng'], np.uint8)))
        for trigger in (self.checkpoint_trigger, self.summary_trigger):
            if trigger.unit == 'iteration':
                trigger.last = self.iteration
        print(f'Resumed from iteration {self.iteration}')
        return True
