"""A reader of ``torch.profiler``'s Chrome traces: device time per step,
busy time, time by kernel and idle gaps.

Counterpart of ``pb_sed_tpu/utils/xplane.py``, which decodes a TPU
XPlane. There an "XLA Modules" line carries one event per executed
program (a training step) and an "XLA Ops" line the device ops. Here the
windows are the host's ``record_function`` events (category
``user_annotation``; the trainer's profiled steps are ``train_step_<n>``,
``utils/profiling.py:step_windows``) and the device ops are the trace's
kernels, copies and memsets (``utils/profiling.py:device_events``). A
trace holds one card's events: the one process's card.

- :func:`device_step_times_ms`: per step, the union of the device
  intervals of the work that started in its window.
- :func:`module_spans_by_name` and :func:`module_busy_times_ms`: the
  windows' spans by name, and per window its span and its busy time (the
  union of the device intervals clipped to it).
- :func:`op_breakdown_ms`: device time by kernel name, templates and
  argument lists collapsed.
- :func:`stall_gaps_ms`: the device's idle gaps inside the longest
  window, each with the host op or ``record_function`` that spans it.
- :func:`duty_cycle_summary`: median span, busy time and their ratio.

Every function takes a trace's path or its events (``trace_events``).
"""
import re

import numpy as np

from pb_sed_tpu_torch.utils.profiling import (DEVICE_CATEGORIES,
                                              device_events, step_windows,
                                              trace_events)

# host-side events that can stand behind a device gap
HOST_CATEGORIES = ('user_annotation', 'cpu_op', 'cuda_runtime',
                   'cuda_driver', 'python_function')


def _events(trace):
    return trace if isinstance(trace, list) else trace_events(trace)


def _interval(event):
    return event['ts'], event['ts'] + event['dur']


def _union_length(intervals):
    """Total covered length of (start, stop) intervals."""
    total = 0.
    last_stop = None
    for start, stop in sorted(intervals):
        if last_stop is None or start >= last_stop:
            total += stop - start
            last_stop = stop
        elif stop > last_stop:
            total += stop - last_stop
            last_stop = stop
    return total


def _clipped(events, start, end):
    """The device intervals of ``events`` that overlap [start, end),
    clipped to it."""
    return [(max(a, start), min(b, end)) for a, b in map(_interval, events)
            if a < end and b > start]


def _windows(events, prefix):
    """[(name, start, end)] of the ``record_function`` windows whose name
    starts with ``prefix``."""
    return [(e['name'], *_interval(e)) for e in events
            if e.get('cat') == 'user_annotation'
            and e['name'].startswith(prefix)]


def _device(events):
    return [e for e in events if e.get('cat') in DEVICE_CATEGORIES]


def device_step_times_ms(trace, prefix='train_step_'):
    """{step: device ms}: the union of the intervals of the device work
    that started in each ``<prefix><step>`` window."""
    events = _events(trace)
    return {step: _union_length(map(_interval, device_events(
                events, start, end))) / 1e3
            for step, (start, end) in sorted(step_windows(
                events, prefix).items())}


def module_spans_by_name(trace, prefix='', collapse=True):
    """{window name: [span ms, ...]} of the ``record_function`` windows;
    with ``collapse`` a trailing ``_<number>`` is dropped, so the steps
    ``train_step_<n>`` count as one name."""
    out = {}
    for name, start, end in _windows(_events(trace), prefix):
        if collapse:
            name = re.sub(r'_\d+$', '', name)
        out.setdefault(name, []).append((end - start) / 1e3)
    return out


def module_busy_times_ms(trace, prefix='train_step_'):
    """[(span ms, busy ms)] per window: busy is the union of the device
    intervals clipped to the window, the time the device computed while
    the window was open (span much larger than busy: the device waited
    on the host)."""
    events = _events(trace)
    device = _device(events)
    return [((end - start) / 1e3,
             _union_length(_clipped(device, start, end)) / 1e3)
            for _, start, end in sorted(_windows(events, prefix),
                                        key=lambda w: w[1])]


def collapse_name(name):
    """A kernel's name without ``void``, template arguments and argument
    lists: ``void k<64, 3>(Params)`` -> ``k``."""
    if name.startswith('void '):
        name = name[5:]
    closing = {'<': '>', '(': ')'}
    stack = []
    out = []
    for ch in name:
        if ch in closing:
            stack.append(closing[ch])
        elif stack:
            if ch == stack[-1]:
                stack.pop()
        else:
            out.append(ch)
    return ''.join(out).strip() or name


def op_breakdown_ms(trace, top=None, collapse=True):
    """{kernel name: (total ms, count)} over the device events, by total
    time descending (``collapse``: :func:`collapse_name`; the exact names
    otherwise); the ``top`` first where given."""
    totals = {}
    for e in _device(_events(trace)):
        name = collapse_name(e['name']) if collapse else e['name']
        t, c = totals.get(name, (0., 0))
        totals[name] = (t + e['dur'] / 1e3, c + 1)
    out = sorted(totals.items(), key=lambda kv: -kv[1][0])
    if top:
        out = out[:top]
    return {k: (round(v[0], 3), v[1]) for k, v in out}


def _gaps(span, intervals, min_gap):
    """Uncovered holes of ``span`` of at least ``min_gap``."""
    s0, s1 = span
    gaps = []
    cur = s0
    for a, b in sorted(intervals):
        if a - cur >= min_gap and cur < s1:
            gaps.append((cur, min(a, s1)))
        cur = max(cur, b)
        if cur >= s1:
            break
    if s1 - cur >= min_gap:
        gaps.append((cur, s1))
    return gaps


def _host_label(host, a, b):
    """The innermost host event that covers the middle of the gap [a, b):
    an op or runtime call, else the ``record_function`` window itself
    (the host ran Python between ops)."""
    mid = (a + b) / 2
    covering = [e for e in host if e['ts'] <= mid < e['ts'] + e['dur']]
    return min(covering, key=lambda e: e['dur'])['name'] if covering \
        else None


def stall_gaps_ms(trace, min_gap_ms=0.1, top=20, prefix='train_step_'):
    """The device's idle time inside the longest ``<prefix>*`` window:
    ``{'span_ms', 'busy_ms', 'gap_ms', 'n_gaps', 'gaps': [(gap ms, offset
    ms into the window, host op), ...]}``, the ``top`` longest gaps of at
    least ``min_gap_ms``, each with the host event (op, runtime call or
    ``record_function``) that spans its middle; ``{}`` without a window."""
    events = _events(trace)
    windows = _windows(events, prefix)
    if not windows:
        return {}
    _, start, end = max(windows, key=lambda w: w[2] - w[1])
    busy = _clipped(_device(events), start, end)
    gaps = _gaps((start, end), busy, min_gap_ms * 1e3)
    host = [e for e in events if e.get('cat') in HOST_CATEGORIES]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        'span_ms': round((end - start) / 1e3, 3),
        'busy_ms': round(_union_length(busy) / 1e3, 3),
        'gap_ms': round(sum(b - a for a, b in gaps) / 1e3, 3),
        'n_gaps': len(gaps),
        'gaps': [(round((b - a) / 1e3, 3), round((a - start) / 1e3, 3),
                  _host_label(host, a, b))
                 for a, b in longest],
    }


def duty_cycle_summary(trace, prefix='train_step_', min_span_ms=0.):
    """{'span_ms': median window span, 'busy_ms': median busy time,
    'duty_cycle': busy / span, 'n_windows'} over the windows of at least
    ``min_span_ms`` that held device work; ``{}`` where none did."""
    pairs = [(s, b) for s, b in module_busy_times_ms(trace, prefix)
             if b > 0 and s >= min_span_ms]
    if not pairs:
        return {}
    span = float(np.median([s for s, _ in pairs]))
    busy = float(np.median([b for _, b in pairs]))
    return {
        'span_ms': round(span, 3),
        'busy_ms': round(busy, 3),
        'duty_cycle': round(busy / span, 4) if span > 0 else None,
        'n_windows': len(pairs),
    }
