"""Trainer triggers and hooks.

Capability parity with padertorch's trigger/hook surface used by the
reference (``experiments/weak_label_crnn/training.py:18-19,369-396``):
``(N, 'iteration')`` interval triggers, ``AllTrigger`` / ``EndTrigger`` /
``NotTrigger`` composition, ``LRAnnealingHook`` with piecewise-linear
breakpoints, and the validation hook policy (metric tracking, best
checkpoints, LR back-off, early stopping) which lives in the Trainer.

The port's own copy of ``pb_sed_tpu/train/hooks.py``: the port imports
nothing of the JAX package. Keep the two in step.
"""


class IntervalTrigger:
    """Fires every ``period`` units; accepts the ``(N, 'iteration')`` form."""

    def __init__(self, period, unit='iteration'):
        if isinstance(period, (tuple, list)):
            period, unit = period
        assert unit in ('iteration', 'epoch'), unit
        self.period = int(period)
        self.unit = unit
        self.last = None

    def peek(self, iteration, epoch=0):
        """Would-fire result WITHOUT consuming the boundary (no state
        change). Composite triggers use peek so a boundary crossing is
        only committed when the composite actually fires."""
        index = iteration if self.unit == 'iteration' else epoch
        last = self.last
        if last is None:
            # first-ever call: fire at index 0 (epoch-style triggers) or
            # if a period boundary already lies behind us
            return index == 0 or index >= self.period
        if index == last:
            return False
        return index // self.period > last // self.period

    def commit(self, iteration, epoch=0):
        self.last = iteration if self.unit == 'iteration' else epoch

    def __call__(self, iteration, epoch=0):
        # fire on period-boundary CROSSINGS, not exact multiples: the
        # multi-step lane advances the iteration by steps_per_call per
        # call, so exact-multiple matching would silently stretch the
        # effective period to lcm(period, steps_per_call). Repeated
        # calls at the same index stay deduped, and resume sets
        # ``last`` to the restored iteration so the first post-resume
        # call cannot immediately re-fire.
        fired = self.peek(iteration, epoch)
        self.commit(iteration, epoch)
        return fired


class EndTrigger(IntervalTrigger):
    """True once ``iteration >= period`` (stop condition)."""

    def __call__(self, iteration, epoch=0):
        index = iteration if self.unit == 'iteration' else epoch
        return index >= self.period

    peek = __call__  # stateless

    def commit(self, iteration, epoch=0):
        pass


def _peek(trigger, iteration, epoch):
    """Side-effect-free evaluation; plain callables are stateless."""
    if hasattr(trigger, 'peek'):
        return trigger.peek(iteration, epoch)
    return trigger(iteration, epoch)


def _commit(trigger, iteration, epoch):
    if hasattr(trigger, 'commit'):
        trigger.commit(iteration, epoch)


class AllTrigger:
    """Composite AND. Implements the same peek/commit protocol as
    IntervalTrigger so composites NEST without consuming boundaries:
    members are only committed when the outermost composite fires."""

    def __init__(self, *triggers):
        self.triggers = [
            t if callable(t) else IntervalTrigger(t) for t in triggers]

    def peek(self, iteration, epoch=0):
        # peek every member (no short-circuit, no state change): a
        # boundary crossing one member sees while another evaluates
        # False must NOT be consumed, or the composite would skip that
        # boundary forever (its ``last`` would already lie past it)
        return all([_peek(t, iteration, epoch) for t in self.triggers])

    def commit(self, iteration, epoch=0):
        for t in self.triggers:
            _commit(t, iteration, epoch)

    def __call__(self, iteration, epoch=0):
        fired = self.peek(iteration, epoch)
        if fired:
            self.commit(iteration, epoch)
        return fired


class AnyTrigger:
    """Composite OR with the peek/commit protocol (see AllTrigger).

    Committing non-fired members is safe: a member whose peek is False
    has no boundary in (last, index], so advancing ``last`` consumes
    nothing."""

    def __init__(self, *triggers):
        self.triggers = [
            t if callable(t) else IntervalTrigger(t) for t in triggers]

    def peek(self, iteration, epoch=0):
        return any([_peek(t, iteration, epoch) for t in self.triggers])

    def commit(self, iteration, epoch=0):
        for t in self.triggers:
            _commit(t, iteration, epoch)

    def __call__(self, iteration, epoch=0):
        fired = self.peek(iteration, epoch)
        self.commit(iteration, epoch)
        return fired


class NotTrigger:
    def __init__(self, trigger):
        self.trigger = trigger if callable(trigger) else IntervalTrigger(
            trigger)

    def peek(self, iteration, epoch=0):
        inner = (self.trigger.peek(iteration, epoch)
                 if hasattr(self.trigger, 'peek')
                 else self.trigger(iteration, epoch))
        return not inner

    def commit(self, iteration, epoch=0):
        if hasattr(self.trigger, 'commit'):
            self.trigger.commit(iteration, epoch)

    def __call__(self, iteration, epoch=0):
        fired = self.peek(iteration, epoch)
        self.commit(iteration, epoch)
        return fired


class Hook:
    def pre_step(self, trainer):
        pass

    def post_step(self, trainer, batch, loss, summary):
        pass

    def close(self, trainer):
        pass


class LRAnnealingHook(Hook):
    """Piecewise-linear learning-rate factor over iterations.

    ``breakpoints = [(it, factor), ...]``: the factor is linearly
    interpolated between breakpoints and held constant after the last one
    (rampup = [(0, 0), (n, 1)]; decay steps = duplicated breakpoints with a
    factor jump), matching the reference's usage
    (``training.py:380-396``).
    """

    def __init__(self, trigger=None, breakpoints=(), unit='iteration',
                 name=None):
        self.trigger = trigger
        self.breakpoints = sorted(breakpoints, key=lambda x: x[0])
        self.unit = unit
        self.name = name

    def factor(self, iteration):
        bps = self.breakpoints
        if not bps:
            return 1.
        if iteration <= bps[0][0]:
            return float(bps[0][1])
        for (x0, y0), (x1, y1) in zip(bps[:-1], bps[1:]):
            if x0 <= iteration <= x1:
                if x1 == x0:
                    return float(y1)
                t = (iteration - x0) / (x1 - x0)
                return float(y0 + t * (y1 - y0))
        return float(bps[-1][1])

    def pre_step(self, trainer):
        trainer.lr_factor_annealing = self.factor(trainer.iteration)
