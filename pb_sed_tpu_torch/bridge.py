"""Weight bridge between the JAX package's flat variable dict and the
port's modules.

The JAX package stores a model as a flat dotted-key dict of numpy arrays
(``pb_sed_tpu/models/base/model.py:flatten_variables``):
``params.<module path>.<name>`` for parameters and
``batch_stats.<module path>.<name>`` for running statistics. The port
keeps the same module paths, parameter names and layouts (HWIO conv
kernels, ``w_ih (F, 3H)``/``w_hh (H, 3H)`` in r, z, n order), so the
bridge is a renaming: an ``nn.Parameter`` at ``path`` is
``params.path``, a persistent buffer at ``path`` is
``batch_stats.path``. Missing or extra keys and shape mismatches raise.
"""
import numpy as np
import torch


def _entries(module):
    """{flat key: tensor} over the module's parameters and persistent
    buffers."""
    params = {name for name, _ in module.named_parameters()}
    out = {}
    for name, tensor in module.state_dict(keep_vars=True).items():
        prefix = 'params.' if name in params else 'batch_stats.'
        out[prefix + name] = tensor
    return out


def param_keys(module):
    """Flat keys of the module's parameters in ``named_parameters``
    order (the order of the trainer's optimizer state)."""
    return [f'params.{name}' for name, _ in module.named_parameters()]


def export_flat(module):
    """The module's state as the JAX package's flat dict (float32
    numpy)."""
    return {key: t.detach().cpu().float().numpy().copy()
            for key, t in _entries(module).items()}


def load_flat(module, flat):
    """Fill the module's parameters and buffers from a flat dict (keys
    and shapes must match exactly)."""
    entries = _entries(module)
    missing = sorted(set(entries) - set(flat))
    extra = sorted(set(flat) - set(entries))
    if missing or extra:
        raise KeyError(f'flat dict does not match the model: missing '
                       f'{missing}, extra {extra}')
    with torch.no_grad():
        for key, tensor in entries.items():
            value = np.array(flat[key], dtype=np.float32)
            if tuple(value.shape) != tuple(tensor.shape):
                raise ValueError(f'{key}: shape {value.shape} != '
                                 f'{tuple(tensor.shape)}')
            tensor.copy_(torch.from_numpy(value))


def random_flat(template, seed):
    """Seeded random values (numpy ``RandomState``) for the keys and
    shapes of the flat dict ``template`` (e.g. ``export_flat(module)``):
    scales near 1, shifts, biases and means near 0, variances in [1, 1.1],
    weights ~ N(0, 1/fan_in). For tests and smoke runs."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(template):
        shape = np.shape(template[key])
        name = key.rsplit('.', 1)[-1]
        if name == 'initialized':
            value = np.ones(shape)
        elif name == 'var':
            value = 1. + .1 * rng.rand(*shape)
        elif name == 'scale':
            value = 1. + .1 * rng.randn(*shape)
        elif name in ('shift', 'bias', 'b_ih', 'b_hh', 'mean'):
            value = .1 * rng.randn(*shape)
        else:
            fan_in = int(np.prod(shape[:-1])) or 1
            value = rng.randn(*shape) / np.sqrt(fan_in)
        out[key] = value.astype(np.float32)
    return out


def init_flat(template, seed):
    """The initial state of a model that is trained from scratch, for the
    keys and shapes of the flat dict ``template``: the JAX package's
    initializers drawn from a seeded numpy ``RandomState``. Weight
    matrices and conv kernels are LeCun normal (a normal truncated at two
    standard deviations with variance 1 / fan_in, fan_in the product of
    all but the last axis: 2F for a bidirectional layer's stacked
    ``w_ih (2, F, 3H)``, as flax counts it), the recurrent ``w_hh``
    (H, 3H) has orthonormal rows, each direction's of a stacked
    (2, H, 3H), scales are one, biases and shifts zero, and the running
    statistics are those of a fresh module (mean 0, var 1,
    not yet initialized)."""
    rng = np.random.RandomState(seed)
    out = {}
    for key in sorted(template):
        shape = np.shape(template[key])
        name = key.rsplit('.', 1)[-1]
        if name in ('var', 'scale'):
            value = np.ones(shape)
        elif name == 'w_hh':
            # one orthonormal (H, 3H) per direction of a stacked
            # (2, H, 3H), as the JAX package's _stacked_orthogonal
            value = np.stack([_orthogonal(rng, *shape[-2:])
                              for _ in range(int(np.prod(shape[:-2])))])
            value = value.reshape(shape)
        elif len(shape) >= 2:
            fan_in = int(np.prod(shape[:-1]))
            value = rng.randn(*shape)
            outside = np.abs(value) > 2.
            while outside.any():  # redraw the tails
                value[outside] = rng.randn(int(outside.sum()))
                outside = np.abs(value) > 2.
            # .8796...: the standard deviation of the truncated normal
            value = value / (.87962566103423978 * np.sqrt(fan_in))
        else:
            value = np.zeros(shape)
        out[key] = value.astype(np.float32)
    return out


def _orthogonal(rng, rows, cols):
    """A (rows, cols) matrix with orthonormal rows or columns (whichever
    are fewer), from a normal draw's QR with the signs of R's diagonal."""
    q, r = np.linalg.qr(rng.randn(max(rows, cols), min(rows, cols)))
    q = q * np.sign(np.diag(r))
    return q.T if rows < cols else q
