"""1-D score filters along the time axis, on numpy arrays and on tensors.

Counterpart of ``pb_sed_tpu/ops/filters.py`` (that module imports
``jax.numpy`` at the top, so it cannot be imported where the port runs),
with the same zero-padding edge semantics (``pb_sed/filters.py:6-135``):
``correlate``, ``meanfilt``, ``medfilt``, ``maxfilt``, ``stepfilt`` and
``boundariesfilt`` on numpy arrays, on vectorized sliding windows; and
their device versions on tensors, which run on the tensor's device:

=====================  ======================
JAX (``jnp``)          port (``torch``)
=====================  ======================
``medfilt_jax``        ``medfilt_torch``
``meanfilt_jax``       ``meanfilt_torch``
``maxfilt_jax``        ``maxfilt_torch``
``stepfilt_jax``       ``stepfilt_torch``
``boundariesfilt_jax`` ``boundariesfilt_torch``
``jax_cummax``         ``torch_cummax``
=====================  ======================

JAX computes those with ``jnp`` outside any Pallas kernel, so plain
PyTorch is their port: windows by ``Tensor.unfold`` over the zero-padded
axis, the median as the mean of the middle two sorted values for an even
window (``jnp.median``).
"""
import numpy as np
import torch


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


def correlate(x, filt, axis=-1, mode='same'):
    """Cross-correlate ``x`` with a 1-D kernel along ``axis``
    (reference ``pb_sed/filters.py:6-36`` public surface; vectorized
    windows instead of per-row ``np.correlate``)."""
    assert mode in ('valid', 'same', 'full'), mode
    x = np.asarray(x, dtype=float)
    filt = np.asarray(filt, dtype=float)
    n = len(filt)
    if n == 0:
        raise ValueError('empty filter')
    if mode == 'same':
        pad_front = n // 2 if n % 2 == 0 else (n - 1) // 2
        pad_back = n - 1 - pad_front
    elif mode == 'full':
        pad_front = pad_back = n - 1
    else:  # valid
        pad_front = pad_back = 0
    view, axis = _sliding_windows(
        x, n, axis, pad_front=pad_front, pad_back=pad_back)
    out = view @ filt
    return np.moveaxis(out, -1, axis)


def meanfilt(x, n, axis=-1):
    """Zero-padded moving average ('same')."""
    if n <= 1:
        return np.asarray(x, dtype=float) if n == 1 else np.asarray(x)
    x = np.asarray(x, dtype=float)
    # 'same' correlation with ones/n: window centered with front (n-1)//2
    # zeros -- numpy.correlate centers the kernel this way for even n too.
    view, axis = _sliding_windows(x, n, axis, pad_front=n // 2 if n % 2 == 0
                                  else (n - 1) // 2)
    out = view.mean(-1)
    return np.moveaxis(out, -1, axis)


def medfilt(x, n, axis=-1):
    """Zero-padded median filter (identity for n == 1)."""
    if n == 1:
        return np.asarray(x)
    assert n % 2 == 1, n
    x = np.asarray(x, dtype=float)
    view, axis = _sliding_windows(x, n, axis)
    out = np.median(view, axis=-1)
    return np.moveaxis(out, -1, axis)


def maxfilt(x, n, axis=-1):
    """Zero-padded sliding maximum."""
    assert n % 2 == 1, n
    x = np.asarray(x)
    view, axis = _sliding_windows(x, n, axis)
    out = view.max(-1)
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


# ----------------------------------------------------------------------
# tensor versions (same semantics as the JAX ``*_jax`` functions)
# ----------------------------------------------------------------------

def _torch_windows(x, n, axis, pad_front, pad_back):
    """(..., T', n) zero-padded windows of ``x`` along ``axis`` moved
    last, and the axis."""
    axis = axis % x.dim()
    x = torch.nn.functional.pad(torch.movedim(x, axis, -1),
                                (pad_front, pad_back))
    return x.unfold(-1, n, 1), axis


def medfilt_torch(x, n, axis=-1):
    if n == 1:
        return x
    view, axis = _torch_windows(x, n, axis, (n - 1) // 2, (n - 1) // 2)
    v = view.sort(-1).values
    k = v.shape[-1]
    out = v[..., k // 2] if k % 2 else (v[..., k // 2 - 1]
                                        + v[..., k // 2]) / 2
    return torch.movedim(out, -1, axis)


def meanfilt_torch(x, n, axis=-1):
    if n <= 1:
        return x
    pad_front = n // 2 if n % 2 == 0 else (n - 1) // 2
    view, axis = _torch_windows(x, n, axis, pad_front, n - 1 - pad_front)
    return torch.movedim(view.mean(-1), -1, axis)


def maxfilt_torch(x, n, axis=-1):
    if n == 1:
        return x
    view, axis = _torch_windows(x, n, axis, (n - 1) // 2, (n - 1) // 2)
    return torch.movedim(view.amax(-1), -1, axis)


def stepfilt_torch(x, n, axis=-1):
    assert n % 2 == 0, n
    kernel = torch.cat([-torch.ones(n // 2, dtype=x.dtype, device=x.device),
                        torch.ones(n // 2, dtype=x.dtype,
                                   device=x.device)]) / (n // 2)
    view, axis = _torch_windows(x, n, axis, n // 2, n // 2 - 1)
    return torch.movedim(view @ kernel, -1, axis)


def boundariesfilt_torch(x, stepfilt_length, axis=-1):
    if stepfilt_length > 0:
        fwd = stepfilt_torch(x, stepfilt_length, axis=axis)
        bwd = stepfilt_torch(torch.flip(x, (axis,)), stepfilt_length,
                             axis=axis)
    else:
        fwd = x
        bwd = torch.flip(x, (axis,))
    return torch.minimum(
        torch_cummax(fwd, axis=axis),
        torch.flip(torch_cummax(bwd, axis=axis), (axis,)),
    )


def torch_cummax(x, axis=-1):
    return torch.cummax(x, dim=axis % x.dim()).values
