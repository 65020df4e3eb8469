"""Run a function on a local world of ranks, one spawned process each,
with a deadline.

``torchrun`` is how a user starts the port on several cards. This is the
launcher for a world on one host started from a running program (the
tests on the CPU with gloo, ``chip_smoke.py`` on the card): each process
gets torchrun's variables, forms the default process group through
``mesh.initialize_distributed`` and runs ``target(rank, world_size,
*args)``. The launcher joins every rank with a deadline. A rank that
raises, exits without a result or outlives the deadline fails the run:
the other ranks are killed (a rank left waiting in a collective would
wait until the process group's timeout) and a ``RuntimeError`` carries
the failing rank's traceback.
"""
import datetime
import multiprocessing as mp
import os
import queue as queue_module
import socket
import time
import traceback

import torch.distributed as dist


def free_port():
    """A TCP port on ``localhost`` that nothing listens on now."""
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def _rank_main(target, rank, world_size, port, backend, args, timeout_s,
               results):
    os.environ.update(MASTER_ADDR='localhost', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK='0')
    from pb_sed_tpu_torch.parallel.mesh import initialize_distributed
    try:
        initialize_distributed(
            backend=backend,
            timeout=datetime.timedelta(seconds=timeout_s))
        results.put((rank, True, target(rank, world_size, *args)))
    except BaseException:   # reported to the launcher, which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs):
    for proc in procs:
        if proc.is_alive():
            proc.kill()
    for proc in procs:
        proc.join(timeout=10)


def run_ranks(target, world_size, args=(), backend='gloo', timeout_s=300.):
    """``[target(rank, world_size, *args) for rank in range(world_size)]``,
    each in a spawned process of a ``world_size``-rank group on
    ``backend``; ``target`` must be importable by its module and name,
    its results picklable. Raises ``RuntimeError`` with the traceback of
    the first rank that fails, or when ``timeout_s`` passes."""
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        target, rank, world_size, port, backend, args, timeout_s, results))
        for rank in range(world_size)]
    for proc in procs:
        proc.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise RuntimeError(
                    f'ranks {sorted(set(range(world_size)) - set(out))} '
                    f'did not finish within {timeout_s} s')
            try:
                rank, ok, value = results.get(timeout=min(remaining, 1.))
            except queue_module.Empty:
                gone = [r for r, proc in enumerate(procs)
                        if r not in out and proc.exitcode is not None]
                if gone:
                    # a result may be in flight from a rank that just ended
                    try:
                        rank, ok, value = results.get(timeout=5.)
                    except queue_module.Empty:
                        raise RuntimeError(
                            f'rank {gone[0]} exited with code '
                            f'{procs[gone[0]].exitcode} and no result')
                else:
                    continue
            if not ok:
                raise RuntimeError(f'rank {rank} of {world_size} failed:\n'
                                   f'{value}')
            out[rank] = value
    finally:
        _stop(procs)
    return [out[rank] for rank in range(world_size)]
