"""A/B of the port's GRU kernels and its max-pool forward between two
checkouts, on one CUDA card.

    python3 scripts/gru_ab.py TREE_A TREE_B [--rounds 2]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``). The trees are timed in turns, A B B A (``--rounds`` pairs), each
in a process of its own that imports that tree's ``pb_sed_tpu_torch`` and
builds its kernels there. A process times the forward kernel
(``pbsed_gru_scan``) and the split backward kernel (``pbsed_gru_scan_bwd``,
the sweep alone, without the wrapper's weight-gradient contraction) on
prepared buffers at the training and tagging shape (2, 32, 500, H) and the
sliding-window shape (2, 16 000, 51, H), H = 256, 512, 768 and 1024 (a
tree whose backward above 512 takes a workspace gets one); at the
training shapes up to H = 512 also the fused backward's wrapper
(``gru_scan_bwd(..., split=False)``: its workspace, the sweep and the
reduction of the partials); and the max-pool forward's wrapper
(``maxpool_freq2``) at the 8
pools of the shallow and deep towers (B = 32, T = 500), replayed from a
CUDA graph of 10 calls (its kernel takes less than the wrapper's host
time). Each time is the median of 5 CUDA-event times after 2 warm-up
calls. The report gives per shape and pass the best time of
each tree over its rounds, the time per serial step (GRU) or the share of
the bound (pool: bytes at 3.35 TB/s), B / A, and, where the tree can say,
the design that ran; a pass where B is more than 5% slower than A is
marked ``SLOWER``. The card's name and power limit come first.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import ab

SHAPES = [(2, 32, 500, 256), (2, 16000, 51, 256), (2, 32, 500, 512),
          (2, 16000, 51, 512), (2, 32, 500, 768), (2, 16000, 51, 768),
          (2, 32, 500, 1024), (2, 16000, 51, 1024)]
# (F, C) entering the max-pools of the shallow and the deep tower
POOLS = [(128, 16), (64, 32), (32, 64), (16, 128), (128, 32), (64, 64),
         (32, 128), (16, 256)]
HBM_BYTES_PER_S = 3.35e12


def cuda_ms(fn, reps=5, warmup=2):
    """Median ms of ``fn()`` (CUDA events)."""
    import numpy as np
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def graph_ms(fn, calls=10):
    """Median ms a call of ``fn()`` replayed from a CUDA graph of
    ``calls`` calls (no host time between the kernels)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay) / calls


def time_tree():
    """Run inside a tree: print one JSON line of {shape: {pass: ms}} and
    one of {shape: {pass: design}} (empty where the tree has no query)."""
    sys.path.insert(0, os.getcwd())
    import torch
    from pb_sed_tpu_torch.ops.kernels import build
    from pb_sed_tpu_torch.ops.kernels import gru as K
    from pb_sed_tpu_torch.ops.kernels.conv import maxpool_freq2
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    times, designs = {}, {}
    for d, b, t, h in SHAPES:
        xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
            torch.bfloat16)
        w_hh = (torch.randn(d, h, 3 * h, generator=gen, device=dev)
                * h ** -.5).to(torch.bfloat16)
        b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device=dev)
        h0 = torch.zeros(d, b, h, device=dev)
        y = torch.empty(d, b, t, h, device=dev)
        # the kernels' layout of w_hh: packed above H = 512 where the tree
        # packs it (the cluster design there)
        w_k = (K.pack_wide(w_hh) if h > 512 and hasattr(K, 'pack_wide')
               else w_hh)

        def fwd():
            build.launch('gru_scan', 'pbsed_gru_scan', dev, xw.data_ptr(),
                         w_k.data_ptr(), b_hh.data_ptr(), h0.data_ptr(),
                         y.data_ptr(), d, b, t, h)

        key = str((d, b, t, h))
        times[key] = {'fwd': cuda_ms(fwd)}
        h_prev = torch.cat([h0[:, :, None], y[:, :, :-1]], dim=2).to(
            torch.bfloat16).contiguous()
        g = 1e-2 * torch.randn(d, b, t, h, generator=gen, device=dev)
        if b == 32 and h <= 512:
            times[key]['bwd_fused'] = cuda_ms(lambda: K.gru_scan_bwd(
                xw, w_hh, b_hh, h0, y, g, split=False))
        del y
        dxw = torch.empty_like(xw)
        r = torch.empty_like(h_prev)
        dh0 = torch.empty(d, b, h, device=dev)
        # a tree whose backward takes a workspace (one block's dgates a
        # step above H = 512, the design before the cluster one there)
        sizes = getattr(build, '_SIZES', {})
        workspace = ()
        if 'pbsed_gru_bwd_workspace' in sizes:
            nbytes = build.lib().pbsed_gru_bwd_workspace(d, b, h)
            buf = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
            workspace = (buf.data_ptr() if nbytes else None,)

        def bwd():
            build.launch('gru_scan_bwd', 'pbsed_gru_scan_bwd', dev,
                         xw.data_ptr(), h_prev.data_ptr(), w_k.data_ptr(),
                         b_hh.data_ptr(), g.data_ptr(), dxw.data_ptr(),
                         r.data_ptr(), dh0.data_ptr(), *workspace, d, b, t,
                         h)

        times[key]['bwd'] = cuda_ms(bwd)
        if hasattr(K, 'gru_designs'):
            designs[key] = {
                p: (f'{v["design"]} (cluster {v["cluster"]}, '
                    f'{v.get("units", "?")} units, {v["rows"]} rows, '
                    f'{v["smem"] / 1024:.0f} KiB, {v["coresident"]} '
                    f'co-resident, w_hh {v.get("resident", 0) / 1024:.0f} '
                    f'KiB resident, {v.get("streamed", 0) / 1024:.0f} KiB '
                    f'streamed)')
                for p, v in K.gru_designs(d, b, t, h).items()
                if v is not None}
        del xw, h_prev, g, dxw, r, workspace, w_k
        torch.cuda.empty_cache()
    for f, c in POOLS:
        x = torch.randn(32, 500, f, c, generator=gen, device=dev).to(
            torch.bfloat16)
        times[str((32, 500, f, c))] = {
            'maxpool': graph_ms(lambda: maxpool_freq2(x))}
    print('TIMES ' + json.dumps(times), flush=True)
    print('DESIGNS ' + json.dumps(designs), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('trees', nargs='*')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--time', action='store_true')
    args = parser.parse_args()
    if args.time:
        return time_tree()
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('gru_ab.py needs a CUDA card')
    tree_a, tree_b = args.trees
    card = ab.card()
    print(f'card: {card}; A = {tree_a}, B = {tree_b}', flush=True)
    script = Path(__file__).resolve()
    found = ab.alternate(tree_a, tree_b, args.rounds, lambda tree: (
        ab.run_child(script, tree, ['TIMES', 'DESIGNS'])))
    runs = {side: [r['TIMES'] for r in rs] for side, rs in found.items()}
    designs = {side: rs[-1]['DESIGNS'] for side, rs in found.items()}
    best = {label: {key: {p: min(r[key][p] for r in rs) for p in passes}
                    for key, passes in rs[0].items()}
            for label, rs in runs.items()}
    slower = []
    for key, passes in best['A'].items():
        shape = json.loads(key.replace('(', '[').replace(')', ']'))
        for p in passes:
            ms_a, ms_b = best['A'][key][p], best['B'][key][p]
            flag = ' SLOWER' if ms_b > 1.05 * ms_a else ''
            if flag:
                slower.append(f'{key} {p}')
            if p == 'maxpool':
                # bf16 in, half of it out: 3 bytes an input element
                ms_bound = 1e3 * 3 * shape[0] * shape[1] * shape[2] \
                    * shape[3] / HBM_BYTES_PER_S
                extra = (f'share of the bound ({ms_bound:.4f} ms) '
                         f'{ms_bound / ms_a:.3f} -> {ms_bound / ms_b:.3f}')
            else:
                t = shape[2]
                design = designs['B'].get(key, {}).get(p, 'not reported')
                extra = (f'per step {1e3 * ms_a / t:.2f} -> '
                         f'{1e3 * ms_b / t:.2f} us; B runs {design}')
            print(f'{key} {p}: {ms_a:.4f} -> {ms_b:.4f} ms '
                  f'({ms_b / ms_a:.3f}); {extra}{flag}')
    print(f'passes where B is more than 5% slower than A: '
          f'{slower if slower else "none"}')
    print(json.dumps({'card': card, 'best': best, 'designs': designs}))


if __name__ == '__main__':
    main()
