"""Exact threshold-free operating-point enumeration (change points).

The reference's evaluation backend (sed_scores_eval, consumed at
``pb_sed/models/base/tuning.py:284-343`` and
``pb_sed/experiments/weak_label_crnn/inference.py:326-355``) computes
PSDS ROCs and collar-based best-F over ALL distinct score values, not a
fixed threshold grid: scores are piecewise constant in time, so a clip's
detection statistics change only at the clip's unique score values. The
dataset-level curve is the sum of per-clip staircases, evaluated at the
union of all change points via delta merging.

Conventions:
- Detection at threshold ``t`` = maximal runs of ``score > t``.
- A clip/class staircase is described by its ascending unique score
  values ``levels`` plus a ``base`` statistic for ``t < levels[0]`` (all
  frames detected); the statistic at ``t`` is the value at the largest
  level ``<= t``.
- :class:`CurveAccumulator` merges staircases from many clips into one
  global curve over the union of change points.

The port's own copy of ``pb_sed_tpu/evaluation/changepoints.py``: the port
imports nothing of the JAX package. Keep the two in step.
"""
import numpy as np


def level_detections(scores_col, timestamps):
    """Detection intervals of one clip/class at every change point.

    Args:
        scores_col: (T,) scores (piecewise constant over frames).
        timestamps: (T+1,) frame boundary times.

    Returns:
        (levels, detections): ``levels`` is the ascending (U,) unique
        score values; ``detections`` is a list of U+1 interval arrays
        ``(n_i, 2)`` of (onset, offset) rows, where ``detections[0]``
        holds the base (threshold below all values -> every frame
        detected) and ``detections[i + 1]`` the detections for
        thresholds in ``[levels[i], levels[i + 1])`` (i.e. frames with
        ``score > levels[i]``).
    """
    scores_col = np.asarray(scores_col, dtype=float)
    timestamps = np.asarray(timestamps, dtype=float)
    levels = np.unique(scores_col)
    t = scores_col.shape[0]
    # thresholds row 0 = base (below every value -> all frames);
    # processed in level CHUNKS so memory stays O(chunk x T) even for
    # long-form clips where U ~ T (continuous neural scores)
    thresholds = np.concatenate(([levels[0] - 1.], levels))
    detections = []
    chunk = max(1, min(len(thresholds), 4_000_000 // max(t, 1)))
    for start in range(0, len(thresholds), chunk):
        block = thresholds[start:start + chunk]
        above = scores_col[None, :] > block[:, None]  # (chunk, T)
        edges = np.diff(above.astype(np.int8), axis=1,
                        prepend=np.zeros((len(block), 1), np.int8),
                        append=np.zeros((len(block), 1), np.int8))
        on_rows, on_t = np.nonzero(edges == 1)
        off_rows, off_t = np.nonzero(edges == -1)
        # np.nonzero returns row-major order: group via searchsorted
        on_bounds = np.searchsorted(on_rows, np.arange(len(block) + 1))
        off_bounds = np.searchsorted(off_rows, np.arange(len(block) + 1))
        for i in range(len(block)):
            ons = timestamps[on_t[on_bounds[i]:on_bounds[i + 1]]]
            offs = timestamps[off_t[off_bounds[i]:off_bounds[i + 1]]]
            detections.append(np.stack((ons, offs), axis=1))
    return levels, detections


class CurveAccumulator:
    """Merges per-clip statistic staircases into one global curve."""

    def __init__(self, stat_size):
        self.stat_size = stat_size
        self.base = np.zeros(stat_size)
        self._thresholds = []
        self._deltas = []

    def add(self, levels, stats, base):
        """Add one clip's staircase.

        Args:
            levels: (U,) ascending change points.
            stats: (U, S) statistic at each level.
            base: (S,) statistic below ``levels[0]``.
        """
        base = np.asarray(base, dtype=float)
        stats = np.asarray(stats, dtype=float).reshape(len(levels),
                                                       self.stat_size)
        self.base += base
        prev = base
        for v, s in zip(levels, stats):
            self._thresholds.append(float(v))
            self._deltas.append(s - prev)
            prev = s

    def merged(self):
        """Returns (breakpoints (N,), curve (N+1, S)).

        ``curve[0]`` is the global statistic for thresholds below every
        change point; ``curve[i + 1]`` for thresholds in
        ``[breakpoints[i], breakpoints[i + 1])``.
        """
        if not self._deltas:
            return np.zeros(0), self.base[None].copy()
        thr = np.asarray(self._thresholds)
        deltas = np.stack(self._deltas)
        order = np.argsort(thr, kind='mergesort')
        thr = thr[order]
        cum = self.base[None] + np.cumsum(deltas[order], axis=0)
        # collapse duplicate thresholds: keep the last cumulative value
        last = np.flatnonzero(np.diff(thr, append=np.inf) != 0)
        curve = np.concatenate((self.base[None], cum[last]))
        return thr[last], curve


def representative_thresholds(breakpoints, margin=1e-3):
    """One applicable threshold per curve row (N+1 for N breakpoints).

    Row 0 (everything detected) gets ``breakpoints[0] - margin``; interior
    rows the midpoint of their validity interval; the top row (nothing
    detected) ``breakpoints[-1] + margin`` — any threshold in a row's
    interval reproduces that row's statistics when applied as
    ``score > threshold``.
    """
    breakpoints = np.asarray(breakpoints, dtype=float)
    if breakpoints.size == 0:
        return np.array([0.])
    mids = (breakpoints[:-1] + breakpoints[1:]) / 2
    return np.concatenate((
        [breakpoints[0] - margin], mids, [breakpoints[-1] + margin]))
