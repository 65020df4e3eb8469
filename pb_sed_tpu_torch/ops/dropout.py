"""Dropout with the semantics of flax's ``nn.Dropout`` and of the attention
dropout of ``nn.MultiHeadDotProductAttention``, drawn from an explicit
``torch.Generator``.

``torch.nn.functional.dropout`` takes no generator, so the masks are
drawn here: ``keep = rand(shape, generator) < 1 - p``, and the kept
values are ``x / (1 - p)`` in ``x``'s dtype (flax: ``select(mask,
x / keep_prob, 0)``). The attention's mask is one (Tq, Tk) draw shared
by the batch and the heads (flax's ``broadcast_dropout=True``), applied
as ``weights * (keep / keep_prob)``, flax's multiplier.

The modules draw from the stream that :func:`dropout_rng` opens around a
training call in the calling thread (the way flax's ``rngs`` reach its
``nn.Dropout``): the trainer opens one on its dropout generator, which is
not the augmentation's (the JAX step keeps ``augment`` and ``dropout``
streams apart). Dropout that would act (``p > 0`` in training) outside
such a stream raises. ``dropout_rng(generator, record=True)`` keeps the
masks it drew, in the order drawn (``stream.masks``), so a test can hand
them to the JAX package and a run can check their keep rate.
"""
import contextlib
import threading

import torch

_OPEN = threading.local()  # .stream: the calling thread's open stream


class DropoutStream:
    """A generator and, with ``record``, the masks drawn from it."""

    def __init__(self, generator, record=False):
        self.generator = generator
        self.masks = [] if record else None

    def keep_mask(self, shape, keep_prob, device):
        """A bool mask of ``shape`` that is True with ``keep_prob``."""
        mask = torch.rand(shape, generator=self.generator,
                          device=device) < keep_prob
        if self.masks is not None:
            self.masks.append(mask)
        return mask


@contextlib.contextmanager
def dropout_rng(generator, record=False):
    """Draw every dropout mask of the calls inside from ``generator``;
    yields the :class:`DropoutStream`."""
    outer = getattr(_OPEN, 'stream', None)
    _OPEN.stream = DropoutStream(generator, record)
    try:
        yield _OPEN.stream
    finally:
        _OPEN.stream = outer


def _stream(module_name):
    stream = getattr(_OPEN, 'stream', None)
    if stream is None:
        raise RuntimeError(
            f'{module_name}: dropout > 0 in training draws its masks from a '
            f'generator: call the module inside '
            f'ops.dropout.dropout_rng(generator) (the Trainer does)')
    return stream


def keep_mask(shape, rate, device, module_name='dropout'):
    """A bool mask of ``shape`` that keeps with probability ``1 - rate``,
    drawn from the open stream."""
    return _stream(module_name).keep_mask(shape, 1. - rate, device)


def apply_keep(x, keep, rate):
    """``x`` where ``keep``, scaled by ``1 / (1 - rate)``, else 0 (flax's
    ``select(mask, x / keep_prob, 0)``), in ``x``'s dtype."""
    return torch.where(keep, x / (1. - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x, rate, training, module_name='dropout'):
    """flax ``nn.Dropout(rate)(x, deterministic=not training)``."""
    if rate == 0. or not training:
        return x
    if rate == 1.:
        return torch.zeros_like(x)
    return apply_keep(x, keep_mask(x.shape, rate, x.device, module_name),
                      rate)


def attention_dropout(weights, rate, training):
    """The attention dropout of flax's ``dot_product_attention_weights``
    with ``broadcast_dropout=True`` on (B, heads, Tq, Tk) weights: one
    (1, 1, Tq, Tk) mask for every example and head."""
    if rate == 0. or not training:
        return weights
    keep = keep_mask((1, 1) + tuple(weights.shape[-2:]), rate,
                     weights.device, 'attention')
    return weights * (keep.to(weights.dtype) / (1. - rate))
