"""A/B of the port's conv kernels between two checkouts, on one CUDA card.

    python3 scripts/conv_ab.py TREE_A TREE_B [--rounds 2]

Each TREE is the root of a checkout of this repository (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory,
and ``.``). The trees are timed in turns, A B B A (``--rounds`` pairs), each
in a process of its own that imports that tree's ``pb_sed_tpu_torch`` and
builds its kernels there. A process times, at every 3x3 layer of both
towers (``chip_smoke.CONV_LAYERS``, ``chip_smoke.DEEP_CONV_LAYERS``, B = 32,
T = 500), the forward ``conv2d_same``, its backward ``conv2d_same_bwd``
and, but at the entry layers, the BN+ReLU-fused pair; on the member axis
of a stacked ensemble (M = 10 shallow members, 3 deep ones: the lane
serves, so forward only) ``conv2d_same_members`` (``members_fwd``) and,
but at the entry layers, ``bnrelu_conv2d_same_members``
(``members_fused_fwd``); at the shallow
tower's layers also the f32 conv of a ``compute_dtype='float32'`` tower,
``conv2d_same_f32`` (``f32_fwd``) and its backward ``conv2d_same_f32_bwd``
with dx (``f32_bwd``): the median of 5 CUDA-event times after 2 warm-up
calls. The report gives per layer and
pass the best time of each tree over its rounds, B / A, and the sums; a
pass where B is more than 5% slower than A is marked ``SLOWER``. The card's
name and power limit come first.
"""
import argparse
import json
import os
import sys
from pathlib import Path

import ab

PASSES = ('fwd', 'bwd', 'fused_fwd', 'fused_bwd', 'members_fwd',
          'members_fused_fwd', 'f32_fwd', 'f32_bwd')
MEMBERS = {'shallow': 10, 'deep': 3}


def time_tree():
    """Run inside a tree: print one JSON line of {layer key: {pass: ms}}."""
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from pb_sed_tpu_torch.ops.kernels import conv as K
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for tower, layers in (('shallow', cs.CONV_LAYERS),
                          ('deep', cs.DEEP_CONV_LAYERS)):
        for layer, f, cin, cout in layers:
            x = torch.randn(cs.BATCH, cs.FRAMES, f, cin, generator=gen,
                            device=dev).to(torch.bfloat16)
            w = torch.randn(3, 3, cin, cout, generator=gen,
                            device=dev) * (9 * cin) ** -.5
            b = .1 * torch.randn(cout, generator=gen, device=dev)
            gy = (1e-3 * torch.randn(cs.BATCH, cs.FRAMES, f, cout,
                                     generator=gen, device=dev)).to(
                                         torch.bfloat16)
            scale = .5 + torch.rand(cin, generator=gen, device=dev)
            shift = .5 * torch.randn(cin, generator=gen, device=dev)
            times = {
                'fwd': cs.cuda_ms(lambda: K.conv2d_same(x, w, b), reps=5),
                'bwd': cs.cuda_ms(lambda: K.conv2d_same_bwd(x, w, gy),
                                  reps=5)}
            if cin > 1:
                times['fused_fwd'] = cs.cuda_ms(
                    lambda: K.bnrelu_conv2d_same(x, scale, shift, w, b),
                    reps=5)
                times['fused_bwd'] = cs.cuda_ms(
                    lambda: K.bnrelu_conv2d_same_bwd(x, scale, shift, w, gy),
                    reps=5)
            m = MEMBERS[tower]
            xm = x.expand(m, *x.shape).contiguous()
            wm = w.expand(m, *w.shape).contiguous()
            bm = b.expand(m, *b.shape).contiguous()
            times['members_fwd'] = cs.cuda_ms(
                lambda: K.conv2d_same_members(xm, wm, bm), reps=5)
            if cin > 1:
                sm = scale.expand(m, *scale.shape).contiguous()
                hm = shift.expand(m, *shift.shape).contiguous()
                times['members_fused_fwd'] = cs.cuda_ms(
                    lambda: K.bnrelu_conv2d_same_members(xm, sm, hm, wm, bm),
                    reps=5)
            del xm
            if tower == 'shallow':
                xf, gyf = x.float(), gy.float()
                times['f32_fwd'] = cs.cuda_ms(
                    lambda: K.conv2d_same_f32(xf, w, b), reps=5)
                times['f32_bwd'] = cs.cuda_ms(
                    lambda: K.conv2d_same_f32_bwd(xf, w, gyf), reps=5)
                del xf, gyf
            out[f'{tower} {layer} ({f}, {cin} -> {cout})'] = times
            del x, gy
            torch.cuda.empty_cache()
    print('TIMES ' + json.dumps(out), flush=True)


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
        raise RuntimeError('conv_ab.py needs a CUDA card')
    tree_a, tree_b = args.trees
    card = ab.card()
    print(f'card: {card}; A = {tree_a}, B = {tree_b}', flush=True)
    script = Path(__file__).resolve()
    runs = ab.alternate(tree_a, tree_b, args.rounds, lambda tree: (
        ab.run_child(script, tree, ['TIMES'])['TIMES']))
    best = {label: {key: {p: min(r[key][p] for r in rs) for p in rs[0][key]}
                    for key in rs[0]} for label, rs in runs.items()}
    sums = {label: {p: 0. for p in PASSES} for label in best}
    slower = []
    for key in best['A']:
        cells = []
        for p in PASSES:
            if p not in best['A'][key]:
                continue
            a, b = best['A'][key][p], best['B'][key][p]
            sums['A'][p] += a
            sums['B'][p] += b
            flag = ' SLOWER' if b > 1.05 * a else ''
            if flag:
                slower.append(f'{key} {p}')
            cells.append(f'{p} {a:.3f} -> {b:.3f} ms ({b / a:.3f}){flag}')
        print(f'{key}: ' + ' | '.join(cells))
    for p in PASSES:
        print(f'sum {p}: A {sums["A"][p]:.3f} ms, B {sums["B"][p]:.3f} ms '
              f'({sums["B"][p] / sums["A"][p]:.3f})')
    print(f'passes where B is more than 5% slower than A: '
          f'{slower if slower else "none"}')
    print(json.dumps({'card': card, 'best': best}))


if __name__ == '__main__':
    main()
