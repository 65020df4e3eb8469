"""A device mesh over ``torch.distributed`` ranks, one process and one
device a rank.

Counterpart of ``pb_sed_tpu/parallel/mesh.py``. There a ``jax.sharding.
Mesh`` has a ``data`` axis (and optionally an ``ensemble`` axis), the
batch is sharded over ``data``, the parameters are replicated, and GSPMD
inserts the reductions that keep the program's meaning: a step on N
devices is the step one device takes on the whole batch. Here each rank
runs the model on its own rows, and the port places those reductions by
hand (the ``data_parallel`` context below, read by the masked batch norm,
the feature normalization, the losses and the dropout and augmentation
draws), and the trainer reduces the gradients.

- :func:`initialize_distributed` forms the default process group from
  torchrun's variables, the counterpart of ``jax.distributed.initialize``
  under ``JAX_COORDINATOR_ADDRESS``; without them it does nothing.
- :class:`Mesh`: axis names, shape, the grid of ranks and one process
  group per axis. :func:`get_mesh` and :func:`default_ensemble_mesh` are
  the JAX functions of the same names; without a process group there is
  no mesh (``None``), which is the one-process path.
- The collectives are built from ``all_reduce`` alone (gloo takes CUDA
  tensors for ``all_reduce`` and ``broadcast`` but not for
  ``all_gather``): :class:`AllReduceSum`, a sum whose backward is the
  same sum of the cotangents (the pattern of ``SyncBatchNorm``), and
  :func:`gather_rows`, an all-reduce of a zero buffer that each rank
  fills at its offset. Host objects travel with ``all_gather_object``.

**How a rank's rows map onto the JAX rule.** JAX's multi-process global
batch is the processes' local batches concatenated in process order
(``make_global_batch``), padded to a multiple of the mesh size by
:func:`pad_batch_to_multiple` (copies of the last row with soft 0.5
targets, which the losses ignore and the batch-norm moments do not).
Here the global batch is the data axis's ranks' local batches
concatenated in rank order; :func:`shard_batch` pads it by the same rule
and rank i keeps rows ``[i·n, (i+1)·n)`` of the padded batch, ``n`` its
size over the axis. The fetcher's exact batch-level shards (equal,
contiguous slices of one padded global batch) already have that layout,
and then no row moves; otherwise the rows are exchanged.

Every collective is called by every rank of its group in the same order,
and none is wrapped in a ``try``: a failure raises, and a rank that
raises leaves the others waiting until the process group's ``timeout``.
"""
import contextlib
import datetime
import math
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

TORCHRUN_VARIABLES = ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT')
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_GROUPS = {}                 # sorted ranks -> process group, made once
_ACTIVE = threading.local()  # .shard: the calling thread's DataShard


def initialize_distributed(backend=None, device=None,
                           timeout=DEFAULT_TIMEOUT):
    """Form the default process group from torchrun's variables (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK``
    picks the card); without them, or with a group already formed, do
    nothing. ``backend`` defaults to NCCL on the card (``device`` None:
    the card, which must be there) and gloo for ``device='cpu'``; any
    other backend is an explicit argument."""
    if dist.is_initialized() or not all(
            name in os.environ for name in TORCHRUN_VARIABLES):
        return
    if backend is None:
        from pb_sed_tpu_torch.models.base.model import default_device
        backend = ('gloo' if default_device(device).type == 'cpu'
                   else 'nccl')
    if backend == 'nccl':
        torch.cuda.set_device(int(os.environ.get('LOCAL_RANK', 0)))
    dist.init_process_group(backend, timeout=timeout)


def is_main_process():
    """Whether this process writes the run's files: rank 0, or the one
    process of a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    """Wait for every rank (nothing to wait for without a group)."""
    if dist.is_initialized():
        dist.barrier()


def broadcast_object(obj, src=0):
    """Rank ``src``'s ``obj`` on every rank (``obj`` itself without a
    process group)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def _group(ranks):
    """The process group of ``ranks`` (the default group when they are
    the whole world). Every rank makes every group, in one order."""
    ranks = tuple(sorted(int(r) for r in ranks))
    if ranks == tuple(range(dist.get_world_size())):
        return dist.group.WORLD
    if ranks not in _GROUPS:
        _GROUPS[ranks] = dist.new_group(list(ranks))
    return _GROUPS[ranks]


class Mesh:
    """Named axes over a grid of ranks. ``shape[axis]`` is the axis size,
    ``coords[axis]`` this rank's index along it and ``groups[axis]`` the
    process group of the ranks that differ from this one along that axis
    only. A rank outside the grid has no coordinates."""

    def __init__(self, grid, axis_names):
        grid = np.asarray(grid, dtype=int)
        if grid.ndim != len(axis_names):
            raise ValueError(f'a {grid.ndim}-D grid for axes {axis_names}')
        self.grid = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        rank = dist.get_rank()
        self.coords = {}
        self.groups = {}
        for i, axis in enumerate(self.axis_names):
            lines = np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i])
            for line in lines:
                group = _group(line)
                if rank in line:
                    self.groups[axis] = group
                    self.coords[axis] = int(np.nonzero(
                        np.sort(line) == rank)[0][0])

    def __repr__(self):
        return f'Mesh({self.shape}, ranks={self.grid.tolist()})'


def get_mesh(axis_name='data', ranks=None, ensemble_size=None):
    """A 1-D ``axis_name`` mesh over ``ranks`` (default: every rank), or a
    2-D ``('ensemble', axis_name)`` one with ``ensemble_size`` rows.
    ``None`` without a process group: the one-process path."""
    if not dist.is_initialized():
        return None
    ranks = np.arange(dist.get_world_size()) if ranks is None \
        else np.asarray(ranks)
    if ensemble_size is not None and ensemble_size > 1:
        if len(ranks) % ensemble_size:
            raise ValueError(f'{len(ranks)} ranks do not split into an '
                             f'ensemble axis of {ensemble_size}')
        return Mesh(ranks.reshape(ensemble_size, -1),
                    ('ensemble', axis_name))
    return Mesh(ranks.reshape(-1), (axis_name,))


def default_ensemble_mesh(n_models):
    """The engine's mesh for ``n_models`` members (JAX
    ``default_ensemble_mesh``): ``None`` at world 1; members over an
    ``ensemble`` axis of gcd(n_models, world) and the batch over
    ``data``; a data-only mesh when the counts are coprime."""
    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return None
    ensemble_size = math.gcd(int(n_models), dist.get_world_size())
    if ensemble_size <= 1:
        return get_mesh()
    return get_mesh(ensemble_size=ensemble_size)


def pad_batch_to_multiple(batch, multiple):
    """Pad the batch axis by repeating the last example so it divides the
    data-mesh size. Padded examples carry all-soft (0.5) weak targets so
    losses and metric buffers ignore them (soft-label masking). Returns
    ``(batch, pad)``."""
    arrays = {k: v for k, v in batch.items()
              if isinstance(v, np.ndarray) and v.ndim >= 1}
    if not arrays:
        return batch, 0
    b = next(iter(arrays.values())).shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch, 0
    out = dict(batch)
    for key, value in batch.items():
        if isinstance(value, np.ndarray) and value.ndim >= 1 \
                and value.shape[0] == b:
            reps = np.concatenate([value, np.repeat(
                value[-1:], pad, axis=0)], axis=0)
            if key.endswith('_targets'):
                reps[b:] = 0.5
            out[key] = reps
        elif isinstance(value, list) and len(value) == b:
            out[key] = value + [value[-1]] * pad
    return out, pad


# -- collectives --------------------------------------------------------------
class AllReduceSum(torch.autograd.Function):
    """The sum of ``x`` over ``group``; the backward is the same sum of
    the cotangents: every rank's output feeds that rank's share of the
    loss, so the cotangent of the sum is the sum of the ranks' cotangents
    (``SyncBatchNorm``'s pattern, and what GSPMD inserts for a reduction
    over a sharded axis)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _reducible(x):
    """``x`` in a dtype every backend sums (and sums exactly when all
    but one rank add zeros)."""
    if x.dtype in (torch.float16, torch.bfloat16):
        return x.float()
    if not x.is_floating_point():
        return x.long()
    return x


def all_sum(x, group):
    """The sum of ``x`` over ``group`` (differentiable)."""
    return AllReduceSum.apply(x, group)


def gather_rows(x, group, counts, index):
    """The rows of every rank of ``group`` concatenated in rank order,
    on every rank: ``x`` holds ``counts[index]`` rows. An all-reduce of a
    zero buffer that each rank fills at its offset, in ``x``'s dtype
    again (no gradient)."""
    if x.shape[0] != counts[index]:
        raise ValueError(f'{x.shape[0]} rows where {counts[index]} were '
                         f'announced')
    offset = sum(counts[:index])
    y = _reducible(x.detach())
    buf = torch.zeros((sum(counts),) + tuple(x.shape[1:]), dtype=y.dtype,
                      device=x.device)
    buf[offset:offset + x.shape[0]] = y
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def gather_objects(obj, group):
    """Every rank's ``obj`` of ``group``, in rank order."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


# -- the data-parallel context ------------------------------------------------
class DataShard:
    """This rank's rows ``[offset, offset + rows)`` of a global batch of
    ``total`` rows split over ``mesh``'s ``axis`` (``counts`` rows a rank
    along it), and the reductions over that axis."""

    def __init__(self, mesh, axis, counts):
        self.group = mesh.groups[axis]
        self.index = mesh.coords[axis]
        self.counts = [int(c) for c in counts]
        self.offset = sum(self.counts[:self.index])
        self.rows = self.counts[self.index]
        self.total = sum(self.counts)

    def sum(self, *xs):
        """Each of ``xs`` summed over the axis, in one collective
        (differentiable); one tensor, or a tuple of them."""
        flat = torch.cat([x.reshape(-1).float() for x in xs])
        flat = all_sum(flat, self.group)
        out = tuple(part.reshape(x.shape).to(x.dtype) for part, x in zip(
            flat.split([x.numel() for x in xs]), xs))
        return out[0] if len(xs) == 1 else out

    def gather(self, x):
        """The global batch's rows of the batch-first ``x``."""
        return gather_rows(x, self.group, self.counts, self.index)

    def local(self, x):
        """This rank's rows of the global batch-first ``x``."""
        return x[self.offset:self.offset + self.rows]


@contextlib.contextmanager
def data_parallel(shard):
    """Inside, the model's batch reductions run over ``shard``'s axis (a
    ``None`` shard: over the local batch, the one-process path)."""
    outer = getattr(_ACTIVE, 'shard', None)
    _ACTIVE.shard = shard
    try:
        yield shard
    finally:
        _ACTIVE.shard = outer


def active_shard():
    """The open :class:`DataShard` of the calling thread, or None."""
    return getattr(_ACTIVE, 'shard', None)


def global_sum(*xs):
    """``xs`` summed over the open shard's axis (themselves outside one)."""
    shard = active_shard()
    if shard is None:
        return xs[0] if len(xs) == 1 else xs
    return shard.sum(*xs)


def global_mean(x):
    """The mean of the batch-first ``x`` over the global batch
    (``x.mean()`` outside a shard)."""
    shard = active_shard()
    if shard is None:
        return x.mean()
    return shard.sum(x.float().sum()) / (
        shard.total * math.prod(x.shape[1:]))


def global_rows(x):
    """The global batch's rows of the batch-first ``x`` (``x`` outside a
    shard)."""
    shard = active_shard()
    return x if shard is None else shard.gather(x)


def local_rows(x):
    """This rank's rows of the global batch-first ``x`` (``x`` outside a
    shard)."""
    shard = active_shard()
    return x if shard is None else shard.local(x)


# -- batches -----------------------------------------------------------------
def _rows_of(batch):
    arrays = [v for v in batch.values()
              if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1]
    return len(arrays[0]) if arrays else 0


def _host(value):
    return value.cpu().numpy() if isinstance(value, torch.Tensor) else value


def shard_batch(batch, mesh, axis='data'):
    """This rank's rows of the global batch (the local batches of the
    axis's ranks, in rank order, padded by :func:`pad_batch_to_multiple`
    to a multiple of the axis size) and its :class:`DataShard`. Where
    the local batches already are that split (equal sizes), nothing
    moves; otherwise the batches are gathered and re-split."""
    n = mesh.shape[axis]
    rows = _rows_of(batch)
    layout = {k: tuple(np.shape(v)[1:]) for k, v in batch.items()
              if isinstance(v, (np.ndarray, torch.Tensor)) and v.ndim >= 1}
    group = mesh.groups[axis]
    announced = gather_objects((rows, layout), group)
    counts = [r for r, _ in announced]
    if any(lay != layout for _, lay in announced):
        raise ValueError(f'the ranks\' batches differ in shape beyond the '
                         f'batch axis: {[lay for _, lay in announced]}')
    if len(set(counts)) == 1:
        return batch, DataShard(mesh, axis, counts)
    parts = gather_objects({k: _host(v) for k, v in batch.items()}, group)
    merged = {}
    for key, value in parts[0].items():
        if isinstance(value, np.ndarray) and value.ndim >= 1:
            merged[key] = np.concatenate([p[key] for p in parts])
        elif isinstance(value, list) and all(
                len(p[key]) == c for p, c in zip(parts, counts)):
            merged[key] = [x for p in parts for x in p[key]]
        else:
            merged[key] = value
    merged, _ = pad_batch_to_multiple(merged, n)
    total = _rows_of(merged)
    per = total // n
    lo = mesh.coords[axis] * per
    local = {k: (v[lo:lo + per] if (isinstance(v, np.ndarray)
                                    and v.ndim >= 1)
                 or (isinstance(v, list) and len(v) == total) else v)
             for k, v in merged.items()}
    return local, DataShard(mesh, axis, [per] * n)
