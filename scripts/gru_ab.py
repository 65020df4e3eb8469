"""A/B of the port's GRU kernels and its max-pool forward between two
checkouts, on one CUDA card.

    python3 scripts/gru_ab.py TREE_A TREE_B [--rounds 2] [--bwd]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``). The trees are timed in turns, A B B A (``--rounds`` pairs), each
in a process of its own that imports that tree's ``pb_sed_tpu_torch`` and
builds its kernels there. A process times the forward kernel
(``pbsed_gru_scan``) and the split backward kernel (``pbsed_gru_scan_bwd``,
the sweep alone, without the wrapper's weight-gradient contraction) on
prepared buffers at the training and tagging shape (2, 32, 500, H) and the
sliding-window shape (2, 16 000, 51, H), H = 256, 512, 768 and 1024 (a
tree whose backward above 512 takes a workspace gets one), and the
forward alone at the other many-row shapes of the main path
(``FWD_SHAPES``: a stacked ensemble's SED chunk, the tuning chain's
shortest window, 224 row tiles of 16); at the training shapes up to
H = 512 also the fused backward's wrapper
(``gru_scan_bwd(..., split=False)``: its workspace, the sweep and the
reduction of the partials); and the max-pool forward's wrapper
(``maxpool_freq2``) at the 8
pools of the shallow and deep towers (B = 32, T = 500), replayed from a
CUDA graph of 10 calls (its kernel takes less than the wrapper's host
time). At the backward shapes the cluster design does not take
(``BWD_SHAPES``: a BiCRNN layer at the DCASE baseline's 128 units and
other widths at 32 rows, training past 32 row tiles of 16 at H = 256, a
ragged many-row shape at H = 200) it times the split backward's sweep
alone at the width the tree's wrapper runs (``kernel_hidden``; operands
padded with zero units), the split and fused wrappers at the real H, at
H < 256 the split wrapper made to pad to 256 (the cluster design's
width), and cuDNN's bf16 backward (forward and backward of one
``torch.nn.GRU`` a direction with identity input weights, less its
training-mode forward; the same in either tree). ``--bwd`` times only
these shapes and the training shapes at H = 256 and 512. Each time is the median of 5 CUDA-event times after 2 warm-up
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
FWD_SHAPES = [(20, 2000, 51, 256), (2, 8000, 11, 256), (2, 1792, 51, 256)]
BWD_SHAPES = [(2, 32, 500, 128), (2, 32, 500, 64), (2, 32, 500, 224),
              (2, 288, 500, 256), (2, 512, 500, 256), (2, 3000, 3, 200)]
# the passes timed in either tree with the same code: no A/B verdict
YARDSTICKS = ('cudnn_bwd',)
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


def cudnn_bwd_ms(xw, w_hh, b_hh, h0, g):
    """cuDNN's bf16 GRU backward at the shape (timing only): per direction
    one ``torch.nn.GRU`` with weight_ih = I(3H), bias_ih = 0, weight_hh =
    w_hh[d]^T and bias_hh = b_hh[d] (gru_scan's recurrence plus one
    identity product); forward and backward (dxw, dh0, dw_hh, db_hh)
    less the training-mode forward."""
    import torch
    d, _, _, g3 = xw.shape
    bf16 = torch.bfloat16
    grus = []
    for i in range(d):
        gru = torch.nn.GRU(g3, g3 // 3, batch_first=True).to(xw.device, bf16)
        with torch.no_grad():
            gru.weight_ih_l0.copy_(torch.eye(g3))
            gru.bias_ih_l0.zero_()
            gru.weight_hh_l0.copy_(w_hh[i].t())
            gru.bias_hh_l0.copy_(b_hh[i])
        gru.weight_ih_l0.requires_grad_(False)
        gru.bias_ih_l0.requires_grad_(False)
        grus.append(gru.train())
    xs = [xw[i].to(bf16).detach().requires_grad_() for i in range(d)]
    hs = [h0[i][None].to(bf16).detach().requires_grad_() for i in range(d)]
    gys = [g[i].to(bf16) for i in range(d)]
    wrt = xs + hs + [p for gru in grus
                     for p in (gru.weight_hh_l0, gru.bias_hh_l0)]

    def forward():
        return [gru(x, h_)[0] for gru, x, h_ in zip(grus, xs, hs)]

    return (cuda_ms(lambda: torch.autograd.grad(forward(), wrt, gys))
            - cuda_ms(forward))


def time_bwd_shapes(K, build, dev, gen, times, designs):
    """The passes of ``BWD_SHAPES`` into ``times`` and the designs the
    tree runs there into ``designs``."""
    import torch
    for d, b, t, h in BWD_SHAPES:
        key = str((d, b, t, h))
        xw = torch.randn(d, b, t, 3 * h, generator=gen, device=dev).to(
            torch.bfloat16)
        w_hh = (torch.randn(d, h, 3 * h, generator=gen, device=dev)
                * h ** -.5)
        b_hh = .1 * torch.randn(d, 3 * h, generator=gen, device=dev)
        h0 = torch.zeros(d, b, h, device=dev)
        g = 1e-2 * torch.randn(d, b, t, h, generator=gen, device=dev)
        y = K.gru_scan(xw, w_hh, b_hh, h0)
        hp = K.kernel_hidden(d, b, t, h, 'bwd')
        xw_p, w_p, b_p, h0_p, y_p, g_p = (
            a.contiguous() for a in K.pad_hidden(
                xw, w_hh.to(torch.bfloat16), b_hh, h0, y, g, hp=hp))
        h_prev = torch.cat([h0_p[:, :, None], y_p[:, :, :-1]], dim=2).to(
            torch.bfloat16).contiguous()
        dxw = torch.empty_like(xw_p)
        r = torch.empty_like(h_prev)
        dh0 = torch.empty(d, b, hp, device=dev)

        def bwd():
            build.launch('gru_scan_bwd', 'pbsed_gru_scan_bwd', dev,
                         xw_p.data_ptr(), h_prev.data_ptr(), w_p.data_ptr(),
                         b_p.data_ptr(), g_p.data_ptr(), dxw.data_ptr(),
                         r.data_ptr(), dh0.data_ptr(), d, b, t, hp)

        args = (xw, w_hh, b_hh, h0, y, g)
        times[key] = {
            'bwd': cuda_ms(bwd),
            'bwd_wrapper': cuda_ms(lambda: K.gru_scan_bwd(*args)),
            'bwd_fused': cuda_ms(lambda: K.gru_scan_bwd(*args, split=False)),
            'cudnn_bwd': cudnn_bwd_ms(xw, w_hh, b_hh, h0, g)}
        if h < 256 and b == 32:
            rule = K.kernel_hidden
            K.kernel_hidden = lambda *a, **k: 256
            try:
                times[key]['bwd_wrapper_as256'] = cuda_ms(
                    lambda: K.gru_scan_bwd(*args))
            finally:
                K.kernel_hidden = rule
        v = K.gru_designs(d, b, t, h)
        designs[key] = {p: f'{v[p]["design"]} at H = {v[p]["hidden"]} '
                           f'(cluster {v[p]["cluster"]}, {v[p]["rows"]} rows, '
                           f'{v[p]["smem"] / 1024:.0f} KiB, '
                           f'{v[p]["coresident"]} co-resident)'
                        for p in ('bwd', 'bwd_fused')}
        del xw, y, g, xw_p, y_p, g_p, h_prev, dxw, r, args
        torch.cuda.empty_cache()


def time_tree(bwd_only=False):
    """Run inside a tree: print one JSON line of {shape: {pass: ms}} and
    one of {shape: {pass: design}} (empty where the tree has no query).
    ``bwd_only``: ``BWD_SHAPES`` and the training shapes up to H = 512."""
    sys.path.insert(0, os.getcwd())
    import torch
    from pb_sed_tpu_torch.ops.kernels import build
    from pb_sed_tpu_torch.ops.kernels import gru as K
    from pb_sed_tpu_torch.ops.kernels.conv import maxpool_freq2
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    times, designs = {}, {}
    shapes = SHAPES + FWD_SHAPES
    if bwd_only:
        shapes = [s for s in SHAPES if s[1] == 32 and s[3] <= 512]
    for d, b, t, h in shapes:
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
        if (d, b, t, h) in FWD_SHAPES:
            if hasattr(K, 'gru_designs'):
                v = K.gru_designs(d, b, t, h)['fwd']
                designs[key] = {'fwd': f'{v["design"]} (cluster '
                                       f'{v["cluster"]}, {v["rows"]} rows)'}
            del xw, y, w_k
            torch.cuda.empty_cache()
            continue
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
    time_bwd_shapes(K, build, dev, gen, times, designs)
    for f, c in ([] if bwd_only else POOLS):
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
    parser.add_argument('--bwd', action='store_true')
    args = parser.parse_args()
    if args.time:
        return time_tree(args.bwd)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('gru_ab.py needs a CUDA card')
    tree_a, tree_b = args.trees
    card = ab.card()
    print(f'card: {card}; A = {tree_a}, B = {tree_b}', flush=True)
    script = Path(__file__).resolve()
    found = ab.alternate(tree_a, tree_b, args.rounds, lambda tree: (
        ab.run_child(script, tree, ['TIMES', 'DESIGNS'],
                     args=['--bwd'] if args.bwd else [])))
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
            flag = (' SLOWER' if ms_b > 1.05 * ms_a and p not in YARDSTICKS
                    else '')
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
                design_a = designs['A'].get(key, {}).get(p, 'not reported')
                design_b = designs['B'].get(key, {}).get(p, 'not reported')
                extra = (f'per step {1e3 * ms_a / t:.2f} -> '
                         f'{1e3 * ms_b / t:.2f} us; A runs {design_a}; '
                         f'B runs {design_b}')
            print(f'{key} {p}: {ms_a:.4f} -> {ms_b:.4f} ms '
                  f'({ms_b / ms_a:.3f}); {extra}{flag}')
    print(f'passes where B is more than 5% slower than A: '
          f'{slower if slower else "none"}')
    print(json.dumps({'card': card, 'best': best, 'designs': designs}))


if __name__ == '__main__':
    main()
