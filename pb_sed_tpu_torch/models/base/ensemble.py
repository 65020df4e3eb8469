"""Stacked ensemble execution.

Counterpart of ``pb_sed_tpu/models/base/ensemble.py``. When all members
share one architecture, their parameters and buffers are stacked on a
leading member axis once, on the members' device, and the module runs
under ``torch.func.vmap`` over that axis (``functional_call`` of the
member module, the batch unbatched: JAX's ``vmap(..., in_axes=(0,
None))``). Every kernel Function has a ``vmap`` rule that serves all
members in ONE launch (``ops/kernels/conv.py``, ``ops/kernels/gru.py``,
``ops/linear.py``): the convs on their member axis, the pools over the
members' clips, the GRU with the members folded into its direction axis.
So an N-member ensemble costs the launches of one model per layer, where
running the members in turn costs N times as many. What does not depend
on the members' state (the STFT and the mel filterbank, a non-persistent
buffer) is computed once for all of them.

Scores are the member mean, in f32 on the device. The stacked lane
serves (eval mode, no gradients); a failure inside it raises, there is no
fallback to running the members in turn.

Over the ranks of a ``parallel.mesh.Mesh`` (one device a rank; the JAX
``shard_map`` and data-only lanes, ``pb_sed_tpu/models/base/
ensemble.py:222-270``): with an ``ensemble`` axis of E, the rank at
ensemble index e stacks members ``[e·N/E, (e+1)·N/E)`` (one launch a
layer for its share) and the member mean is the all-reduced sum of the
E shares' means over E (JAX's ``pmean``); along the ``data`` axis of D
ranks the batch is padded to a multiple of D (copies of the last row)
and split, each rank evaluates its rows, and the rows are gathered back
and trimmed. Without an ensemble axis (coprime counts) every rank stacks
every member and the batch alone splits. Every rank returns the whole
scores.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from pb_sed_tpu_torch.models.base.model import to_numpy
from pb_sed_tpu_torch.parallel.mesh import Mesh, gather_rows


def _hyper(value):
    """A comparable form of one module attribute: numbers, strings and
    containers as they are, a function by its name (``torch.relu``, the
    identity lambda), a dataclass (the STFT geometry) by its fields."""
    if isinstance(value, (bool, int, float, str, type(None))):
        return value
    if isinstance(value, (list, tuple)):
        return tuple(_hyper(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return tuple(sorted(_hyper(v) for v in value))
    if isinstance(value, dict):
        return tuple(sorted((k, _hyper(v)) for k, v in value.items()))
    if dataclasses.is_dataclass(value):
        return (type(value).__qualname__, _hyper(dataclasses.asdict(value)))
    if callable(value):
        return getattr(value, '__qualname__', type(value).__qualname__)
    return (type(value).__qualname__, repr(value))


def module_config(module):
    """What makes two modules the same architecture (the JAX package
    compares its flax modules, whose fields are their hyper-parameters):
    per submodule its class and its plain attributes, per parameter and
    buffer its name, shape and dtype."""
    layers = tuple(
        (name, type(sub).__qualname__,
         tuple(sorted((k, _hyper(v)) for k, v in vars(sub).items()
                      if not k.startswith('_') and k != 'training')))
        for name, sub in module.named_modules())
    tensors = tuple((name, tuple(t.shape), str(t.dtype))
                    for name, t in (*module.named_parameters(),
                                    *module.named_buffers()))
    return layers, tensors


def same_architecture(models):
    if len(models) < 2:
        return True
    first = module_config(models[0].module)
    return all(type(m) is type(models[0])
               and module_config(m.module) == first for m in models[1:])


class _Method(nn.Module):
    """``member.<method>(batch, **kwargs)`` as a forward, so that
    ``functional_call`` can run any of the module's methods."""

    def __init__(self, member):
        super().__init__()
        self.member = member

    def forward(self, batch, method, kwargs):
        return getattr(self.member, method)(batch, **kwargs)


def _rows(value, lo, hi, pad):
    """Rows ``lo:hi`` of an array, tensor or per-example list, the last
    row repeated ``pad`` times."""
    part = value[lo:hi]
    if not pad:
        return part
    if isinstance(value, list):
        return part + part[-1:] * pad
    if isinstance(value, torch.Tensor):
        return torch.cat([part, part[-1:].expand(pad, *part.shape[1:])])
    return np.concatenate([part, np.repeat(part[-1:], pad, axis=0)])


class StackedEnsemble:
    """Drop-in for a list of SoundEventModels of one architecture on one
    device (or over a mesh's ranks): the same inference API, scores the
    member mean.

    ``chunk_size`` evaluates a batch in chunks of that many examples (the
    last padded by repeating its last row, the outputs trimmed), every
    chunk dispatched before any is converted. Left None, sliding-window
    SED still runs in chunks, of ceil(examples / members): its buffers
    (every window of every clip, for every member) grow with members x
    clips, and so the stacked lane holds no more of them at once than
    serving the members in turn does, one member at a time. Tagging and
    boundaries detection run the whole batch at once unless
    ``chunk_size`` is given."""

    def __init__(self, models, mesh=None, ensemble_axis='ensemble',
                 chunk_size=None):
        """``mesh`` (a ``parallel.mesh.Mesh``, or None for this process's
        device) shards the members over its ``ensemble_axis`` and the
        batch over its ``data`` axis; every rank passes all members."""
        models = list(models)
        if not models:
            raise ValueError('StackedEnsemble needs at least one model')
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f'mesh: a pb_sed_tpu_torch.parallel.mesh.Mesh '
                            f'or None, got {type(mesh).__qualname__}')
        if not same_architecture(models):
            raise ValueError('StackedEnsemble: the members\' architectures '
                             'differ')
        devices = {m.placed_device() for m in models}
        if len(devices) != 1:
            raise ValueError(f'StackedEnsemble: the members lie on '
                             f'{sorted(map(str, devices))}; stacking needs '
                             f'them on one device')
        self.models = models
        self.module = models[0].module
        self.device = devices.pop()
        self.chunk_size = chunk_size
        self._call = _Method(self.module)
        members = models
        if mesh is not None and ensemble_axis in mesh.axis_names:
            shards = mesh.shape[ensemble_axis]
            if len(models) % shards:
                raise ValueError(f'{len(models)} members do not split over '
                                 f'an ensemble axis of {shards}')
            share = len(models) // shards
            e = mesh.coords[ensemble_axis]
            members = models[e * share:(e + 1) * share]
            self._ensemble = (mesh.groups[ensemble_axis], shards)
        else:
            self._ensemble = None
        self._data = (None if mesh is None or 'data' not in mesh.axis_names
                      else (mesh.groups['data'], mesh.shape['data'],
                            mesh.coords['data']))
        self.local_members = members         # the members stacked here
        for m in models:                     # the stacked lane serves
            m.module.eval()
        params, buffers = stack_module_state([m.module for m in members])
        # a non-persistent buffer (the mel filterbank) is the config's,
        # the same in every member: one copy, unbatched
        persistent = set(self.module.state_dict())
        shared = {name: buf for name, buf in self.module.named_buffers()
                  if name not in persistent}
        state = {**params, **buffers, **shared}
        self.state = {f'member.{k}': v.detach() for k, v in state.items()}
        self.in_dims = {f'member.{k}': (None if k in shared else 0)
                        for k in state}

    def __len__(self):
        return len(self.models)

    # -- evaluation ------------------------------------------------------
    def _apply(self, batch, method, windows=False, **kwargs):
        """The member mean of ``module.<method>(batch, **kwargs)``, in
        chunks of ``chunk_size`` examples where the batch is larger (with
        ``windows``, the sliding-window SED, of ceil(examples / members)
        where ``chunk_size`` is None)."""
        arrays = {k for k, v in batch.items()
                  if isinstance(v, (np.ndarray, torch.Tensor))
                  and v.ndim >= 1}
        lens = {len(batch[k]) for k in arrays}
        cs = self.chunk_size
        if windows and not cs and lens:
            cs = -(-max(lens) // len(self))
        if not cs or not lens or max(lens) <= cs:
            return self._apply_chunk(batch, method, **kwargs)
        if len(lens) != 1:
            raise ValueError(f'batch entries of unequal lengths {lens}')
        n = lens.pop()
        # per-example lists (example ids) are cut alongside the arrays
        rows = arrays | {k for k, v in batch.items()
                         if isinstance(v, list) and len(v) == n}
        outs = []
        for lo in range(0, n, cs):
            hi = min(lo + cs, n)
            chunk = {k: _rows(v, lo, hi, cs - (hi - lo)) if k in rows else v
                     for k, v in batch.items()}
            outs.append((hi - lo,
                         self._apply_chunk(chunk, method, **kwargs)))
        # convert after every chunk is dispatched: a conversion waits for
        # the device
        ys = [to_numpy(y)[:k] for k, (y, _) in outs]
        sls = [to_numpy(sl) for _, (_, sl) in outs]
        sls = [sl[:k] if sl.ndim >= 1 else sl
               for (k, _), sl in zip(outs, sls)]
        return (np.concatenate(ys),
                np.concatenate(sls) if sls[0].ndim >= 1 else sls[0])

    def _apply_chunk(self, batch, method, **kwargs):
        self.module.eval()
        call = self._call

        def one(state, device_batch):
            return functional_call(call, state,
                                   (device_batch, method, kwargs))

        n = None
        if self._data is not None:
            batch, n = self._data_rows(batch)
        with torch.inference_mode():
            device_batch = self.models[0].to_device(batch)
            y, seq_len = vmap(one, in_dims=(self.in_dims, None))(
                self.state, device_batch)
            y, seq_len = y.mean(0), seq_len[0]
            if self._ensemble is not None:
                group, shards = self._ensemble
                dist.all_reduce(y, group=group)
                y = y / shards
            if n is not None:
                group, size, index = self._data
                counts = [y.shape[0]] * size
                y = gather_rows(y, group, counts, index)[:n]
                if seq_len.dim() >= 1:
                    seq_len = gather_rows(seq_len, group, counts,
                                          index)[:n]
            return y, seq_len

    def _data_rows(self, batch):
        """This rank's rows of ``batch`` padded to a multiple of the data
        axis (copies of the last row), and the batch's length."""
        _, size, index = self._data
        lens = {len(v) for v in batch.values()
                if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1}
        if len(lens) != 1:
            raise ValueError(f'batch entries of unequal lengths {lens}')
        n = lens.pop()
        per = -(-n // size)
        rows = np.minimum(np.arange(index * per, (index + 1) * per), n - 1)

        def take(value):
            if isinstance(value, list) and len(value) == n:
                return [value[i] for i in rows]
            if isinstance(value, (np.ndarray, torch.Tensor)) \
                    and value.ndim >= 1:
                return value[rows]
            return value

        return {k: take(v) for k, v in batch.items()}, n

    # -- inference API ---------------------------------------------------
    def _sed(self, batch, window_length, window_shift, materialize):
        from pb_sed_tpu_torch.models.weak_label.crnn import multi_window_sed
        return multi_window_sed(
            lambda win_len: self._apply(
                batch, 'sed_windows', windows=True, window_length=win_len,
                window_shift=int(window_shift)),
            window_length, materialize=materialize)

    def dispatch(self, method, batch, **params):
        """The public methods' values as device tensors where possible
        (returns before the device is done; a chunked batch comes back as
        numpy)."""
        windows = hasattr(self.module, 'sed_windows')
        if method == 'sound_event_detection' and windows \
                and params.get('window_length') is not None:
            return self._sed(batch, params.pop('window_length'),
                             params.pop('window_shift', 1), False)
        if method == 'sound_event_detection' and not windows:
            params.pop('window_length', None)
            params.pop('window_shift', None)
        return self._apply(batch, method, **params)

    def tagging(self, batch, **params):
        y, seq_len = self._apply(batch, 'tagging', **params)
        return to_numpy(y), to_numpy(seq_len)

    def boundaries_detection(self, batch, **params):
        y, seq_len = self._apply(batch, 'boundaries_detection', **params)
        return to_numpy(y), to_numpy(seq_len)

    def sound_event_detection(self, batch, window_length=None,
                              window_shift=1, **params):
        if hasattr(self.module, 'sed_windows') and window_length is not None:
            return self._sed(batch, window_length, window_shift, True)
        y, seq_len = self._apply(batch, 'sound_event_detection', **params)
        return to_numpy(y), to_numpy(seq_len)


def _same_kwargs(a, b):
    """Equal keyword arguments (array values, per-class window lengths,
    compared by value)."""
    return a.keys() == b.keys() and all(
        np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def maybe_stack(models, model_kwargs, mesh=None):
    """Stack when architectures and per-model kwargs agree; else leave the
    models to run in turn."""
    if len(models) < 2:
        return models, model_kwargs
    if isinstance(models[0], StackedEnsemble):
        return models, model_kwargs
    if not same_architecture(models):
        return models, model_kwargs
    if not all(_same_kwargs(kw, model_kwargs[0]) for kw in model_kwargs[1:]):
        return models, model_kwargs
    return [StackedEnsemble(models, mesh=mesh)], [model_kwargs[0]]
