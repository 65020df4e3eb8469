"""1-D score filters along the time axis (numpy).

Counterpart of the numpy half of ``pb_sed_tpu/ops/filters.py`` (that
module imports ``jax.numpy`` at the top, so it cannot be imported where
the port runs): ``medfilt``, ``stepfilt`` and ``boundariesfilt`` with the
same zero-padding edge semantics, on vectorized sliding windows.
"""
import numpy as np


def _sliding_windows(x, n, axis=-1, pad_front=None, pad_back=None,
                     pad_value=0.):
    """Zero-padded sliding windows of length n along axis (numpy view)."""
    axis = axis % x.ndim
    if pad_front is None:
        pad_front = (n - 1) // 2
    if pad_back is None:
        pad_back = n - 1 - pad_front
    pad = [(0, 0)] * x.ndim
    pad[axis] = (pad_front, pad_back)
    x = np.pad(x, pad, mode='constant', constant_values=pad_value)
    x = np.moveaxis(x, axis, -1)
    view = np.lib.stride_tricks.sliding_window_view(x, n, axis=-1)
    return view, axis


def medfilt(x, n, axis=-1):
    """Zero-padded median filter (identity for n == 1)."""
    if n == 1:
        return np.asarray(x)
    assert n % 2 == 1, n
    x = np.asarray(x, dtype=float)
    view, axis = _sliding_windows(x, n, axis)
    out = np.median(view, axis=-1)
    return np.moveaxis(out, -1, axis)


def stepfilt(x, n, axis=-1):
    """Edge-detector filter for boundary detection.

    Kernel ``concat(-ones(n//2), ones(n//2)) / (n//2)``, padded ``n//2``
    front / ``n//2 - 1`` back, 'valid' correlation -> output length == input
    length. High response where scores step from low to high.
    """
    assert n % 2 == 0, n
    x = np.asarray(x, dtype=float)
    kernel = np.concatenate((-np.ones(n // 2), np.ones(n // 2))) / (n // 2)
    view, axis = _sliding_windows(x, n, axis, pad_front=n // 2,
                                  pad_back=n // 2 - 1)
    out = view @ kernel
    return np.moveaxis(out, -1, axis)


def boundariesfilt(score_arr, stepfilt_length, axis=-1):
    """min(cummax(fwd-stepfilt), reverse cummax(bwd-stepfilt)).

    Reference semantics from ``pb_sed/models/base/inference.py:266-289``:
    turns onset/offset edge responses into a single boundary span per class.
    """
    if stepfilt_length > 0:
        fwd = stepfilt(score_arr, stepfilt_length, axis=axis)
        bwd = stepfilt(np.flip(score_arr, axis=axis), stepfilt_length,
                       axis=axis)
    else:
        fwd = score_arr
        bwd = np.flip(score_arr, axis=axis)
    return np.minimum(
        np.maximum.accumulate(fwd, axis=axis),
        np.flip(np.maximum.accumulate(bwd, axis=axis), axis=axis),
    )
