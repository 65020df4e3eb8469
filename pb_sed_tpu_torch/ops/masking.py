"""Sequence masks and masked reductions over padded batches.

Counterpart of ``pb_sed_tpu/ops/masking.py``: padded frames never reach
pooled outputs. ``reverse_sequence`` is one gather here (the JAX
package's flip-and-roll custom VJP avoided a TPU gather lowering).
"""
import torch


def sequence_mask(seq_len, max_len, dtype=torch.float32):
    """(B,) lengths -> (B, max_len) {0, 1} mask."""
    steps = torch.arange(max_len, device=seq_len.device)
    return (steps[None, :] < seq_len[:, None]).to(dtype)


def compute_mask(x, seq_len, sequence_axis=-1, batch_axis=0):
    """Mask broadcastable to ``x`` with ones on valid frames."""
    axis = sequence_axis % x.dim()
    mask = sequence_mask(seq_len, x.shape[axis], x.dtype)  # (B, T)
    shape = [1] * x.dim()
    shape[batch_axis % x.dim()] = x.shape[batch_axis % x.dim()]
    shape[axis] = x.shape[axis]
    return mask.reshape(shape)


def masked_mean(x, seq_len, axis=-1, keepdims=False):
    mask = compute_mask(x, seq_len, sequence_axis=axis)
    total = (x * mask).sum(dim=axis, keepdim=keepdims)
    count = mask.sum(dim=axis, keepdim=keepdims)
    return total / count.clamp(min=1.)


def masked_max(x, seq_len, axis=-1, keepdims=False):
    """Max over the valid frames (padding set to the dtype's lowest
    value, as the JAX package does)."""
    mask = compute_mask(x, seq_len, sequence_axis=axis)
    low = torch.finfo(x.dtype).min
    return torch.where(mask > 0, x, torch.full_like(x, low)).amax(
        dim=axis, keepdim=keepdims)


def take_last(x, seq_len, axis=-1, keepdims=False):
    """Value at the last valid frame of each example."""
    axis = axis % x.dim()
    idx = (seq_len.long() - 1).clamp(0, x.shape[axis] - 1)  # (B,)
    shape = [1] * x.dim()
    shape[0] = x.shape[0]
    idx = idx.reshape(shape).expand(
        *x.shape[:axis], 1, *x.shape[axis + 1:])
    out = torch.gather(x, axis, idx)
    return out if keepdims else out.squeeze(axis)


def reverse_sequence(x, seq_len, axis=-1):
    """Flip the valid frames of each example, keeping padding at the end:
    ``out[..., t] == x[..., sl - 1 - t]`` for ``t < sl``.

    Padded positions receive the same values as in the JAX package (flip,
    then roll each example left by ``T - sl``), so the two agree on every
    frame. ``seq_len=None`` means every sequence is full: a plain flip.
    """
    axis = axis % x.dim()
    if seq_len is None:
        return torch.flip(x, dims=(axis,))
    t = x.shape[axis]
    steps = torch.arange(t, device=x.device)
    offset = (t - seq_len.long()) % max(t, 1)                 # (B,)
    src = t - 1 - (steps[None, :] + offset[:, None]) % max(t, 1)  # (B, T)
    shape = [1] * x.dim()
    shape[0], shape[axis] = x.shape[0], t
    src = src.reshape(shape).expand(x.shape)
    return torch.gather(x, axis, src)
