"""Device time of the conv pair at the recipes' entry layers (Cin < 16)
in one or two checkouts of this repository, on one CUDA card.

    python3 scripts/perf/entry_conv_probe.py [TREE_A [TREE_B]] [--rounds 1]

At the shallow (F 128, 1 -> 16), deep (128, 1 -> 32) and tag-conditioned
BiCRNN (128, 11 -> 16) L0 shapes (B = 32, T = 500, 3x3) a process in each
tree (its own ``pb_sed_tpu_torch``, its own kernel build) times with
``torch.profiler``, over 5 calls after a warm-up, the device ms of every
kernel of: the forward ``conv2d_same``; the backward ``conv2d_same_bwd``
with dx, split into its dx launch, its dw launches (partials and reduce)
and the wrapper's glue; the backward without dx where the tree's wrapper
takes ``need_dx``; and cuDNN's bf16 forward and weight gradient
(``convolution_backward`` for the weight alone) on the channels-last
tensors. With two trees the processes run A B B A (``--rounds`` pairs)
and the report keeps each tree's best round. Each pass is printed beside
its bound (bytes at 3.35 TB/s: each input read once, each output written
once) and its share of it. The card's name and power limit come first.
With no tree the working directory is timed once.
"""
import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import ab  # noqa: E402

SHAPES = (('shallow L0', 128, 1, 16), ('deep L0', 128, 1, 32),
          ('BiCRNN L0', 128, 11, 16))
B, T = 32, 500
HBM_BYTES_PER_S = 3.35e12


def bounds(f, cin, cout):
    """The byte bounds (ms) of the forward, dx and dw passes."""
    p = B * T * f
    taps = 9
    ms = 1e3 / HBM_BYTES_PER_S
    return {'fwd': ms * (2 * p * cin + 2 * p * cout + 2 * taps * cin * cout
                         + 4 * cout),
            'dx': ms * (2 * p * cout + 2 * p * cin + 2 * taps * cin * cout),
            'dw': ms * (2 * p * cin + 2 * p * cout + 4 * taps * cin * cout)}


def _part(key):
    if 'dw_reduce' in key or 'dw_entry_reduce' in key:
        return 'dw'
    if 'conv2d_dw_' in key:
        return 'dw'
    if 'conv2d_igemm' in key or 'conv2d_wgmma' in key:
        return 'dx'
    if 'conv2d_entry' in key:
        return 'fwd'
    return 'glue'


def time_tree():
    """Run inside a tree: print one line ``ENTRY {json}``."""
    sys.path.insert(0, os.getcwd())
    import inspect

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from pb_sed_tpu_torch.ops.kernels import conv as K
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    takes_need_dx = 'need_dx' in inspect.signature(
        K.conv2d_same_bwd).parameters

    def device(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            rows = cs.profile_kernels(lambda: [fn() for _ in range(reps)])
            if rows:
                parts = {}
                for ms, key, _ in rows:
                    part = _part(key)
                    parts[part] = parts.get(part, 0.) + ms / reps
                parts['all'] = sum(ms for ms, _, _ in rows) / reps
                return parts
        raise RuntimeError('the profiler recorded no device kernel')

    out = {}
    for name, f, cin, cout in SHAPES:
        x = torch.randn(B, T, f, cin, generator=gen, device=dev).to(
            torch.bfloat16)
        w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (
            9 * cin) ** -.5
        b = .1 * torch.randn(cout, generator=gen, device=dev)
        gy = (1e-3 * torch.randn(B, T, f, cout, generator=gen,
                                 device=dev)).to(torch.bfloat16)
        xn, gyn = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        wn = w.to(torch.bfloat16).permute(3, 0, 1, 2).contiguous().permute(
            0, 3, 1, 2)
        row = {'designs': K.conv_designs(f, cin, cout),
               'fwd': device(lambda: K.conv2d_same(x, w, b)),
               'bwd': device(lambda: K.conv2d_same_bwd(x, w, gy)),
               'cudnn_fwd': device(lambda: F.conv2d(
                   xn, wn, b.to(torch.bfloat16), padding=1))['all'],
               'cudnn_dw': device(lambda: torch.ops.aten.convolution_backward(
                   gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
                   1, [False, True, False]))['all']}
        if takes_need_dx:
            row['bwd_no_dx'] = device(lambda: K.conv2d_same_bwd(
                x, w, gy, need_dx=False))
        out[name] = row
        del x, gy, xn, gyn
        torch.cuda.empty_cache()
    print('ENTRY ' + json.dumps(out), flush=True)


def report(label, res):
    for name, f, cin, cout in SHAPES:
        row = res[name]
        bnd = bounds(f, cin, cout)
        fwd = row['fwd'].get('fwd', 0.) + row['fwd'].get('dx', 0.)
        line = (f'{label} {name} ({cin} -> {cout}): designs '
                f'{ {k: d["design"] for k, d in row["designs"].items()} }; '
                f'forward {fwd:.4f} ms (bound {bnd["fwd"]:.4f}, share '
                f'{bnd["fwd"] / fwd:.2f}; cuDNN {row["cudnn_fwd"]:.4f})')
        bwd = row['bwd']
        line += (f'; backward dx {bwd.get("dx", 0.):.4f} ms (bound '
                 f'{bnd["dx"]:.4f}), dw {bwd.get("dw", 0.):.4f} (bound '
                 f'{bnd["dw"]:.4f}, share {bnd["dw"] / bwd["dw"]:.2f}; '
                 f'cuDNN dw {row["cudnn_dw"]:.4f}), glue '
                 f'{bwd.get("glue", 0.):.4f}')
        if 'bwd_no_dx' in row:
            alone = row['bwd_no_dx']
            line += (f'; without dx: dw {alone.get("dw", 0.):.4f}, glue '
                     f'{alone.get("glue", 0.):.4f}')
        print(line, flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('trees', nargs='*')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--time', action='store_true')
    args = parser.parse_args()
    if args.time:
        time_tree()
        return
    print(ab.card(), flush=True)
    script = Path(__file__).resolve()
    if len(args.trees) < 2:
        tree = args.trees[0] if args.trees else '.'
        report(tree, ab.run_child(script, tree, ('ENTRY',))['ENTRY'])
        return
    runs = ab.alternate(args.trees[0], args.trees[1], args.rounds,
                        lambda tree: ab.run_child(script, tree,
                                                  ('ENTRY',))['ENTRY'])
    for side, tree in zip('AB', args.trees[:2]):
        best = {}
        for res in runs[side]:
            for name, row in res.items():
                total = row['fwd']['all'] + row['bwd']['all']
                if name not in best or total < (best[name]['fwd']['all']
                                                + best[name]['bwd']['all']):
                    best[name] = row
        report(f'{side} ({tree})', best)
        print(f'{side} JSON ' + json.dumps(best), flush=True)


if __name__ == '__main__':
    main()
