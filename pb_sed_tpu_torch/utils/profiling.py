"""Profiling and timing utilities.

The port's copy of ``pb_sed_tpu/utils/profiling.py``: ``Timer`` as it is
there, and :func:`torch_profile` for the JAX package's ``jax_profile``:
a ``torch.profiler`` trace (CPU activity, and CUDA activity on the card)
written as a Chrome trace into ``logdir``, readable in Perfetto or
``chrome://tracing``. :func:`step_times_ms` reads a trace back: per
``record_function`` window named ``<prefix><step>``, the host
milliseconds and the device milliseconds of the kernels, copies and
memsets that started inside it (the trainer's profiled steps; it
synchronizes the card at the end of each profiled step, so a step's
device work lies inside its window). The counterpart of the JAX
package's ``utils/xplane.py`` (its TPU XPlane reader) is
``utils/trace.py``, built on :func:`trace_events`, :func:`step_windows`
and :func:`device_events`.
"""
import contextlib
import json
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')


class torch_profile:
    """Capture a ``torch.profiler`` trace into ``logdir`` (a Chrome trace,
    ``trace_<pid>_<ns>.json``; ``self.path`` once the context exits).
    ``cuda`` (default: whether a card is there) adds CUDA activity.

    Usage::

        with torch_profile(storage_dir / 'profile') as trace:
            trainer.train_step(batch)
        print(trace.path)
    """

    def __init__(self, logdir, cuda=None):
        self.logdir = Path(logdir)
        self.cuda = torch.cuda.is_available() if cuda is None else cuda
        self.profiler = None
        self.path = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.logdir.mkdir(parents=True, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        self.profiler = profile(activities=activities)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        self.path = self.logdir / f'trace_{os.getpid()}_{time.time_ns()}.json'
        self.profiler.export_chrome_trace(str(self.path))
        return False


def trace_events(path):
    """The complete (``ph == 'X'``) events of a Chrome trace."""
    with open(path) as fid:
        trace = json.load(fid)
    return [e for e in trace['traceEvents'] if e.get('ph') == 'X']


def step_windows(events, prefix='train_step_'):
    """{step: (start µs, end µs)} of the host ``record_function`` windows
    named ``<prefix><step>``."""
    return {int(e['name'][len(prefix):]): (e['ts'], e['ts'] + e['dur'])
            for e in events if e.get('cat') == 'user_annotation'
            and e['name'].startswith(prefix)}


def device_events(events, start, end):
    """The device events (kernels, copies, memsets) that started in
    [start, end)."""
    return [e for e in events if e.get('cat') in DEVICE_CATEGORIES
            and start <= e['ts'] < end]


def step_times_ms(path, prefix='train_step_'):
    """{step: (host ms, device ms)} of the windows of a trace."""
    events = trace_events(path)
    return {step: ((end - start) / 1e3,
                   sum(e['dur'] for e in device_events(events, start, end))
                   / 1e3)
            for step, (start, end) in sorted(step_windows(
                events, prefix).items())}


class Timer:
    """Accumulating named wall-clock timers for host-side stages."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self):
        return {
            name: {'total_s': self.totals[name],
                   'count': self.counts[name],
                   'mean_ms': 1000. * self.totals[name]
                   / max(self.counts[name], 1)}
            for name in self.totals
        }

    def print_summary(self):
        for name, stats in sorted(self.summary().items()):
            print(f'{name}: {stats["mean_ms"]:.2f} ms x '
                  f'{stats["count"]} = {stats["total_s"]:.2f} s')
