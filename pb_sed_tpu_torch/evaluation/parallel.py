"""Multiprocessing for per-clip and per-threshold evaluation sweeps.

Counterpart of ``pb_sed_tpu/evaluation/parallel.py`` (``num_jobs=8``
everywhere, as in the reference's evaluation): ``parallel_map`` runs
``[fn(item, *data) for item in items]`` on a pool of ``num_jobs`` worker
processes, one pool a call.

The workers come from a ``forkserver`` context, where the JAX package
takes ``spawn``. Both start workers from a process that holds no device
state (the inference engine has just used the card), and both import the
parent's main module in every worker of every pool: the training CLI or
``chip_smoke.py``, so torch. A spawned worker does that from scratch, for
each of the ~140 pools of a tuning run at the recipe's grids; a worker
forked from the server finds the main module's imports loaded, since the
server imports the main module once by its name (Python 3.12's
forkserver does not preload ``__main__`` by itself: it drops the path).
``chip_smoke.py`` (phase 8) times a pool's start both ways. The
evaluation modules import numpy only.

``POOL_STATS`` counts the pools started, the host seconds from a pool's
creation until the last of its workers that ran an item was ready, and
the seconds to shut the pools down (``reset_pool_stats`` sets them to
0). ``stop_pools`` stops the server and the resource tracker.
"""
import multiprocessing as mp
import os
import sys
import time
from pathlib import Path

POOL_STATS = {'pools': 0, 'start_s': 0., 'close_s': 0.}

_WORKER_FN = None
_WORKER_DATA = None
_READY_AT = None


def reset_pool_stats():
    POOL_STATS.update(pools=0, start_s=0., close_s=0.)


def _init_worker(fn, data):
    global _WORKER_FN, _WORKER_DATA, _READY_AT
    _WORKER_FN, _WORKER_DATA = fn, data
    _READY_AT = time.time()


def _run_item(item):
    return _READY_AT, _WORKER_FN(item, *_WORKER_DATA)


def _context():
    """The forkserver context, its server told to import the parent's main
    module by name: the module of ``python -m``, or a script's file stem
    (importable from the script's directory, the first entry of the
    ``sys.path`` that the server is given)."""
    ctx = mp.get_context('forkserver')
    main = sys.modules.get('__main__')
    spec = getattr(main, '__spec__', None)
    path = getattr(main, '__file__', None)
    if spec is not None:
        ctx.set_forkserver_preload([spec.name])
    elif path is not None:
        ctx.set_forkserver_preload([Path(path).stem])
    return ctx


def stop_pools():
    """Stop the forkserver and the resource tracker that the pools started.

    Both otherwise outlive the last pool: they exit only when they read
    the end of their pipe from this process, which is after it has exited.
    A caller that must leave no process behind when it returns (a smoke
    script) calls this once its last pool is closed; a later pool starts
    both anew. The server goes first, since its workers hold the tracker's
    pipe."""
    from multiprocessing import forkserver, resource_tracker
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def parallel_map(fn, items, data, num_jobs=1):
    """``[fn(item, *data) for item in items]``, optionally with a
    ``num_jobs``-process pool.

    ``fn`` must be a module-level function (picklable); ``data`` is
    shipped to each worker once via the pool initializer, not per item.
    Falls back to the serial loop when ``num_jobs <= 1``, there is at
    most one item, or only one CPU is available.
    """
    items = list(items)
    cpus = os.cpu_count() or 1
    if num_jobs is None or num_jobs <= 1 or len(items) <= 1 or cpus <= 1:
        return [fn(item, *data) for item in items]
    n = min(num_jobs, len(items), cpus)
    started = time.time()
    with _context().Pool(n, initializer=_init_worker,
                         initargs=(fn, data)) as pool:
        out = pool.map(
            _run_item, items, chunksize=max(1, len(items) // n))
        closing = time.time()
    POOL_STATS['pools'] += 1
    POOL_STATS['start_s'] += max(ready for ready, _ in out) - started
    POOL_STATS['close_s'] += time.time() - closing
    return [result for _, result in out]
