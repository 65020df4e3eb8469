"""Device time of the conv pair at the recipes' entry layers (Cin < 16)
and at the layers that run off the wgmma pair's old tile, in one or two
checkouts of this repository, on one CUDA card.

    python3 scripts/perf/entry_conv_probe.py [TREE_A [TREE_B]] [--rounds 1]
        [--f32]

Shapes (B = 32, T = 500, 3x3): the shallow (F 128, 1 -> 16), deep (128,
1 -> 32) and tag-conditioned BiCRNN (128, 11 -> 16) L0; 14b's 3x3 layers
(the deep tower at 40 mel bins with 24 channels in its first four 2-D
layers: F = 40, 20, 10, 5); a layer at Cin = 20 (F 40, 20 -> 24), which
the wrappers pad to 24 channels; and, as a check on the recipes' own
tiles, the shallow L1, L3, L5 and L8 and the deep L2, L6, L14 and L16.
A process in each tree (its own ``pb_sed_tpu_torch``, its own kernel
build) times with
``torch.profiler``, over 5 calls after a warm-up, the device ms of every
kernel of: the forward ``conv2d_same``; the backward ``conv2d_same_bwd``
split into its dx launch, its dw launches (partials and reduce) and the
wrapper's glue (casts, the weight flip, the channel pad); the backward
without dx where the tree's wrapper takes ``need_dx``; from Cin = 2 up
the BN+ReLU-fused forward ``bnrelu_conv2d_same`` and its backward
``bnrelu_conv2d_same_bwd`` (da and dw) alike; at the shallow and deep
tower's layers both forwards on the member axis of a stacked ensemble
(``conv2d_same_members``, ``bnrelu_conv2d_same_members``: 10 shallow
members, 3 deep ones, as ``scripts/conv_ab.py`` times them by events);
and cuDNN's bf16
forward and ``convolution_backward`` for both gradients, for the input's
alone (dgrad) and for the weight's alone, on the channels-last tensors.
With two trees the processes run A B B A (``--rounds`` pairs) and the
report keeps each tree's best round. Each pass is printed beside its
bound (bytes at 3.35 TB/s, each input read once and each output written
once, or bf16 operations at 989 TFLOP/s, whichever is larger) and its
share of it. The card's name and power limit come first. With no tree
the working directory is timed once.

With ``--f32`` it times the f32 conv (``compute_dtype='float32'``:
``conv2d_same_f32`` and ``conv2d_same_f32_bwd``) instead, f32
activations, at the three recipes' entry layers, 14b's 3x3 layers
(L0 on the entry kernels, L2-L14 off a power-of-two F), a layer at
Cout = 10 (F 40, 24 -> 10, padded to 16 for the forward and dw) and the
shallow and deep recipes' own tiles (shallow L1, L3, L5, L8; deep L2,
L6, L14, L16): per
tree the device ms of the forward, the dx (the forward-type GEMM inside
the backward, with its weights' split) and the dw (a backward without
dx: the dw partials and their reduce), and the wrappers' glue (the
channel pad and narrowing, the weight flip), beside cuDNN's f32 forward,
dgrad and wgrad with TF32 off and each pass's bound (bytes at 3.35 TB/s,
each activation read or written once, or 3 TF32 products an f32 product
at 495 TFLOP/s); then the sums of each tree's best over 14b's seven
off-tile layers (L2-L14), forward and backward (dx + dw), beside
cuDNN's and the bound.
"""
import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import ab  # noqa: E402

SHAPES = (('shallow L0', 128, 1, 16), ('deep L0', 128, 1, 32),
          ('BiCRNN L0', 128, 11, 16),
          ('14b L0', 40, 1, 24), ('14b L2', 40, 24, 24),
          ('14b L4', 20, 24, 64), ('14b L6', 20, 64, 64),
          ('14b L8', 10, 64, 128), ('14b L10', 10, 128, 128),
          ('14b L12', 5, 128, 256), ('14b L14', 5, 256, 256),
          ('Cin 20', 40, 20, 24),
          ('shallow L1', 128, 16, 16), ('shallow L3', 64, 32, 32),
          ('shallow L5', 32, 64, 64), ('shallow L8', 8, 128, 256),
          ('deep L2', 128, 32, 32), ('deep L6', 64, 64, 64),
          ('deep L14', 16, 256, 256), ('deep L16', 8, 256, 512))
B, T, TAPS = 32, 500, 9
MEMBERS = {'shallow': 10, 'deep': 3}
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def bounds(f, cin, cout):
    """The least ms of the forward, the dx, the dw and the backward (dx
    and dw), each the larger of its bytes and its bf16 operations."""
    p = B * T * f
    w = 2 * TAPS * cin * cout

    def ms(nbytes, flops):
        return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)
    gemm = 2. * p * TAPS * cin * cout
    return {'fwd': ms(2 * p * cin + 2 * p * cout + w + 4 * cout, gemm),
            'dx': ms(2 * p * cout + 2 * p * cin + w, gemm),
            'dw': ms(2 * p * cin + 2 * p * cout + 2 * w, gemm),
            'bwd': ms(4 * p * cin + 2 * p * cout + w + 2 * w, 2 * gemm)}


def _part(key):
    if 'conv2d_dw_' in key:
        return 'dw'
    if 'conv2d_igemm' in key or 'conv2d_wgmma' in key:
        return 'dx'
    if 'conv2d_entry' in key:
        return 'fwd'
    return 'glue'


F32_SHAPES = SHAPES[:11] + (('Cout 10', 40, 24, 10),) + SHAPES[12:]
# 14b's seven layers off a power-of-two F, summed in the report
F32_OFF_TILE = tuple(name for name, *_ in SHAPES[4:11])
TF32_FLOPS = 495e12


def f32_bounds(f, cin, cout):
    """The least ms of each pass of the f32 conv: its activations' bytes
    (the weights' too) or its 3xTF32 products, whichever is larger."""
    p = B * T * f
    nbytes = 4 * (p * (cin + cout) + TAPS * cin * cout)
    ops = 3. * 2. * p * TAPS * cin * cout
    ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / TF32_FLOPS)
    return dict.fromkeys(('fwd', 'dx', 'dw'), ms)


def _f32_part(key):
    if 'dw_' in key:
        return 'dw'
    if 'conv2d_f32' in key:
        return 'gemm'
    return 'glue'


def time_tree_f32():
    """Run inside a tree: print one line ``F32 {json}`` of the f32 conv's
    passes at the entry layers (device ms by part)."""
    sys.path.insert(0, os.getcwd())

    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from pb_sed_tpu_torch.ops.kernels import conv as K
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)

    def device(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            rows = cs.profile_kernels(lambda: [fn() for _ in range(reps)])
            if rows:
                parts = {}
                for ms, key, _ in rows:
                    part = _f32_part(key)
                    parts[part] = parts.get(part, 0.) + ms / reps
                parts['all'] = sum(ms for ms, _, _ in rows) / reps
                return parts
        raise RuntimeError('the profiler recorded no device kernel')

    out = {}
    for name, f, cin, cout in F32_SHAPES:
        x = torch.randn(B, T, f, cin, generator=gen, device=dev)
        w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * (
            9 * cin) ** -.5
        b = .1 * torch.randn(cout, generator=gen, device=dev)
        gy = 1e-3 * torch.randn(B, T, f, cout, generator=gen, device=dev)
        xn, gyn = x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2)
        wn = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)

        def cudnn_bwd(mask):
            return device(lambda: torch.ops.aten.convolution_backward(
                gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                mask))['all']
        fwd = device(lambda: K.conv2d_same_f32(x, w, b))
        bwd = device(lambda: K.conv2d_same_f32_bwd(x, w, gy))
        no_dx = device(lambda: K.conv2d_same_f32_bwd(x, w, gy,
                                                     need_dx=False))
        out[name] = {
            'designs': {k: d['design'] for k, d in
                        K.conv_f32_designs(f, cin, cout).items()},
            'fwd': fwd.get('gemm', 0.), 'dx': bwd.get('gemm', 0.),
            'dw': no_dx.get('dw', 0.),
            'glue': {'fwd': fwd.get('glue', 0.), 'bwd': bwd.get('glue', 0.),
                     'no_dx': no_dx.get('glue', 0.)},
            'cudnn_fwd': device(lambda: F.conv2d(xn, wn, b,
                                                 padding=1))['all'],
            'cudnn_dx': cudnn_bwd([True, False, False]),
            'cudnn_dw': cudnn_bwd([False, True, False])}
        del x, gy, xn, gyn
        torch.cuda.empty_cache()
    print('F32 ' + json.dumps(out), flush=True)


def report_f32(runs):
    """One line per layer and pass: each tree's best device ms, the bound
    and the last tree's share of it, cuDNN's f32 call (the last tree's
    last run); then the sums over ``F32_OFF_TILE``."""
    sides = sorted(runs)
    sums = {side: {'fwd': 0., 'dx': 0., 'dw': 0.} for side in sides}
    lib = {'fwd': 0., 'dx': 0., 'dw': 0.}
    bounds_sum = {'fwd': 0., 'dx': 0., 'dw': 0.}
    for name, f, cin, cout in F32_SHAPES:
        bnd = f32_bounds(f, cin, cout)
        last = runs[sides[-1]][-1][name]
        for key in ('fwd', 'dx', 'dw'):
            best = {side: min(r[name][key] for r in runs[side])
                    for side in sides}
            designs = ' / '.join(str(runs[side][-1][name]['designs'][key])
                                 for side in sides)
            ms = best[sides[-1]]
            glue = last['glue']['no_dx' if key == 'dw' else
                                'bwd' if key == 'dx' else 'fwd']
            print(f'f32 {name} ({f}, {cin} -> {cout}) {key}: '
                  + ', '.join(f'{side} {v:.4f}' for side, v in best.items())
                  + f' ms ({designs}); bound {bnd[key]:.4f}, share '
                  f'{bnd[key] / ms:.2f}; cuDNN f32 {last["cudnn_" + key]:.4f}'
                  f'; glue {glue:.4f}', flush=True)
            if name in F32_OFF_TILE:
                for side in sides:
                    sums[side][key] += best[side]
                lib[key] += last['cudnn_' + key]
                bounds_sum[key] += bnd[key]
    for side in sides:
        s = sums[side]
        bwd = s['dx'] + s['dw']
        print(f'f32 14b L2-L14 summed, {side}: forward {s["fwd"]:.4f} ms '
              f'(cuDNN f32 {lib["fwd"]:.4f}, bound {bounds_sum["fwd"]:.4f}, '
              f'share {bounds_sum["fwd"] / s["fwd"]:.3f}); backward '
              f'{bwd:.4f} ms = dx {s["dx"]:.4f} + dw {s["dw"]:.4f} (cuDNN '
              f'f32 dgrad + wgrad {lib["dx"] + lib["dw"]:.4f}, bound '
              f'{bounds_sum["dx"] + bounds_sum["dw"]:.4f}, share '
              f'{(bounds_sum["dx"] + bounds_sum["dw"]) / bwd:.3f})',
              flush=True)


def time_tree():
    """Run inside a tree: print one line ``CONV {json}``."""
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

        def cudnn_bwd(mask):
            return device(lambda: torch.ops.aten.convolution_backward(
                gyn, xn, wn, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                mask))['all']
        row = {'designs': K.conv_designs(
                   f, cin + (-cin % 8 if cin >= 16 else 0), cout + -cout % 16),
               'fwd': device(lambda: K.conv2d_same(x, w, b)),
               'bwd': device(lambda: K.conv2d_same_bwd(x, w, gy)),
               'cudnn_fwd': device(lambda: F.conv2d(
                   xn, wn, b.to(torch.bfloat16), padding=1))['all'],
               'cudnn_bwd': cudnn_bwd([True, True, False]),
               'cudnn_dx': cudnn_bwd([True, False, False]),
               'cudnn_dw': cudnn_bwd([False, True, False])}
        if takes_need_dx:
            row['bwd_no_dx'] = device(lambda: K.conv2d_same_bwd(
                x, w, gy, need_dx=False))
        if cin > 1:
            scale = .5 + torch.rand(cin, generator=gen, device=dev)
            shift = .5 * torch.randn(cin, generator=gen, device=dev)
            row['fused_fwd'] = device(lambda: K.bnrelu_conv2d_same(
                x, scale, shift, w, b))
            row['fused_bwd'] = device(lambda: K.bnrelu_conv2d_same_bwd(
                x, scale, shift, w, gy))
        m = MEMBERS.get(name.split()[0])
        if m:
            xm = x.expand(m, *x.shape).contiguous()
            wm = w.expand(m, *w.shape).contiguous()
            bm = b.expand(m, *b.shape).contiguous()
            row['members_fwd'] = device(
                lambda: K.conv2d_same_members(xm, wm, bm))['all']
            if cin > 1:
                sm = scale.expand(m, *scale.shape).contiguous()
                hm = shift.expand(m, *shift.shape).contiguous()
                row['members_fused_fwd'] = device(
                    lambda: K.bnrelu_conv2d_same_members(
                        xm, sm, hm, wm, bm))['all']
            del xm
        out[name] = row
        del x, gy, xn, gyn
        torch.cuda.empty_cache()
    print('CONV ' + json.dumps(out), flush=True)


def report(label, res):
    for name, f, cin, cout in SHAPES:
        row = res[name]
        bnd = bounds(f, cin, cout)
        designs = {k: d['design'] for k, d in row['designs'].items()}
        fwd, bwd = row['fwd'], row['bwd']
        kernel = fwd.get('fwd', 0.) + fwd.get('dx', 0.)
        dx, dw = bwd.get('dx', 0.), bwd.get('dw', 0.)
        line = (f'{label} {name} ({f}, {cin} -> {cout}): designs {designs}; '
                f'forward {kernel:.4f} ms (bound {bnd["fwd"]:.4f}, share '
                f'{bnd["fwd"] / kernel:.2f}; cuDNN {row["cudnn_fwd"]:.4f}), '
                f'glue {fwd.get("glue", 0.):.4f}; backward '
                f'{bwd["all"]:.4f} ms (bound {bnd["bwd"]:.4f}, share '
                f'{bnd["bwd"] / bwd["all"]:.2f}; cuDNN '
                f'{row["cudnn_bwd"]:.4f}): dx {dx:.4f} (bound '
                f'{bnd["dx"]:.4f}, share {bnd["dx"] / dx:.2f}; cuDNN dgrad '
                f'{row["cudnn_dx"]:.4f}), dw {dw:.4f} (bound '
                f'{bnd["dw"]:.4f}, share {bnd["dw"] / dw:.2f}; cuDNN dw '
                f'{row["cudnn_dw"]:.4f}), glue {bwd.get("glue", 0.):.4f}')
        if 'bwd_no_dx' in row:
            alone = row['bwd_no_dx']
            line += (f'; without dx: dw {alone.get("dw", 0.):.4f}, glue '
                     f'{alone.get("glue", 0.):.4f}')
        if 'fused_fwd' in row:
            ffwd, fbwd = row['fused_fwd'], row['fused_bwd']
            kernel = ffwd.get('fwd', 0.) + ffwd.get('dx', 0.)
            line += (f'; fused forward {kernel:.4f} (glue '
                     f'{ffwd.get("glue", 0.):.4f}), fused backward '
                     f'{fbwd["all"]:.4f}: da {fbwd.get("dx", 0.):.4f}, dw '
                     f'{fbwd.get("dw", 0.):.4f}, glue {fbwd.get("glue", 0.):.4f}')
        if 'members_fwd' in row:
            line += f'; members forward {row["members_fwd"]:.4f}'
        if 'members_fused_fwd' in row:
            line += f', fused {row["members_fused_fwd"]:.4f}'
        print(line, flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('trees', nargs='*')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--time', action='store_true')
    parser.add_argument('--f32', action='store_true')
    args = parser.parse_args()
    if args.time:
        (time_tree_f32 if args.f32 else time_tree)()
        return
    print(ab.card(), flush=True)
    script = Path(__file__).resolve()
    if args.f32:
        trees = args.trees or ['.']

        def measure(tree):
            return ab.run_child(script, tree, ('F32',),
                                args=('--f32',))['F32']
        if len(trees) < 2:
            runs = {'A': [measure(trees[0])]}
        else:
            runs = ab.alternate(trees[0], trees[1], args.rounds, measure)
        for side, tree in zip('AB', trees):
            print(f'{side} = {tree}', flush=True)
        report_f32(runs)
        print('F32 JSON ' + json.dumps(runs), flush=True)
        return
    if len(args.trees) < 2:
        tree = args.trees[0] if args.trees else '.'
        report(tree, ab.run_child(script, tree, ('CONV',))['CONV'])
        return
    runs = ab.alternate(args.trees[0], args.trees[1], args.rounds,
                        lambda tree: ab.run_child(script, tree,
                                                  ('CONV',))['CONV'])
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
