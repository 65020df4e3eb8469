"""Variants of the entry conv kernels (``csrc/conv2d_entry.cuh``) side by
side on one CUDA card.

    python3 scripts/perf/entry_conv_sweep.py

Each variant is a copy of ``pb_sed_tpu_torch`` under the git-ignored
``chip_tmp/sweep/`` with the header's text changed (``VARIANTS``: its
ring depths and tile size, and two that take a part out, the copies or
the dw pass's x loads, whose results are wrong and only timed), built
with the conv sources alone and timed in a process of its own: the device
ms (``torch.profiler``, 10 calls) of the entry forward and of the dw pass
without dx (its kernel and its reduce) at the shallow (F 128, 1 -> 16),
deep (1 -> 32) and tag-conditioned (11 -> 16) entry shapes, B = 32,
T = 500, with each result's largest error as a fraction of its gate.
The card's name and power limit come first; a build takes ~20 s.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SWEEP = ROOT / 'chip_tmp' / 'sweep'

VARIANTS = {
    'as built': [],
    'forward ring of 3': [('kEntryFwdStages = 2;', 'kEntryFwdStages = 3;')],
    'forward tiles of 512 px': [('kEntryFwdPixels = 1024;',
                                 'kEntryFwdPixels = 512;')],
    'dw ring of 4': [('kEntryDwStages = 3;', 'kEntryDwStages = 4;')],
    # the products alone: no copies into the rings (results wrong)
    'no copies': [('if (first + s * stride < tiles) stage(',
                   'if (T < 0) stage('),
                  ('if (tile + (kEntryFwdStages - 1) * stride < tiles)',
                   'if (T < 0)'),
                  ('if (t_begin + s < t_end) stage_tile(',
                   'if (T < 0) stage_tile('),
                  ('if (tile + kEntryDwStages - 1 < t_end)', 'if (T < 0)')],
    # the dw pass without its x (B fragment) loads (results wrong)
    'dw without x loads': [
        ('const uint32_t bl = pack2(hs[p01.x + offk[j]], '
         'hs[p01.y + offk[j]]);', 'const uint32_t bl = p01.x + offk[j];'),
        ('const uint32_t bh = pack2(hs[p89.x + offk[j]], '
         'hs[p89.y + offk[j]]);', 'const uint32_t bh = p89.y + offk[j];')],
}

ERROR_CU = '''#include <cuda_runtime.h>
extern "C" const char* pbsed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
'''


def make(name, edits):
    """The variant's tree: the package with the header edited and only
    the conv sources (and an error-string one) left to build."""
    tree = SWEEP / name.replace(' ', '_')
    if tree.exists():
        shutil.rmtree(tree)
    shutil.copytree(ROOT / 'pb_sed_tpu_torch', tree / 'pb_sed_tpu_torch',
                    ignore=shutil.ignore_patterns('__pycache__'))
    csrc = tree / 'pb_sed_tpu_torch' / 'csrc'
    for f in csrc.iterdir():
        if f.suffix in ('.cu', '.cpp') and f.name not in ('conv2d.cu',
                                                          'conv2d_bwd.cu'):
            f.unlink()
    (csrc / 'error.cu').write_text(ERROR_CU)
    header = csrc / 'conv2d_entry.cuh'
    text = header.read_text()
    for a, b in edits:
        assert a in text, (name, a)
        text = text.replace(a, b)
    header.write_text(text)
    shutil.copy(ROOT / 'chip_smoke.py', tree / 'chip_smoke.py')
    return tree


def time_tree():
    """Run inside a variant's tree: build its conv sources, bind their
    entry points and print one line ``RESULT {json}``."""
    sys.path.insert(0, os.getcwd())
    import torch
    from pb_sed_tpu_torch.ops.kernels import build
    import ctypes
    path = build.build()
    lib = ctypes.CDLL(str(path))
    names = ('pbsed_conv2d_same', 'pbsed_conv2d_same_bwd',
             'pbsed_bnrelu_conv2d_same', 'pbsed_bnrelu_conv2d_same_bwd')
    for name in names:
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    for name in ('pbsed_conv2d_design', 'pbsed_conv2d_dw_design',
                 'pbsed_conv2d_dw_chunks', 'pbsed_conv2d_dw_workspace'):
        getattr(lib, name).argtypes = build._QUERIES[name]
        getattr(lib, name).restype = ctypes.c_int
    lib.pbsed_conv2d_dw_workspace.restype = ctypes.c_longlong
    lib.pbsed_error_string.argtypes = (ctypes.c_int,)
    lib.pbsed_error_string.restype = ctypes.c_char_p
    build._lib = lib
    from pb_sed_tpu_torch.ops.kernels import conv as K
    import chip_smoke as cs
    dev = 'cuda'
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for cin, cout in ((1, 16), (1, 32), (11, 16)):
        x = torch.randn(32, 500, 128, cin, generator=gen,
                        device=dev).to(torch.bfloat16)
        w = torch.randn(3, 3, cin, cout, generator=gen, device=dev) * .3
        b = torch.randn(cout, generator=gen, device=dev)
        gy = torch.randn(32, 500, 128, cout, generator=gen,
                         device=dev).to(torch.bfloat16)
        ref = K.conv2d_same_plain(x, w, b)
        y = K.conv2d_same(x, w, b)
        err = float((y.float() - ref.float()).abs().max()) / (
            2 ** -7 * float(ref.float().abs().max()))
        _, dw = K.conv2d_same_bwd(x, w, gy, need_dx=False)
        _, rdw = K.conv2d_same_bwd_plain(x, w, gy)
        err_dw = float((dw - rdw).abs().max()) / (
            1e-3 * float(rdw.abs().max()))
        row = {'err': err, 'err_dw': err_dw}
        for label, fn in (('fwd', lambda: K.conv2d_same(x, w, b)),
                          ('dw', lambda: K.conv2d_same_bwd(
                              x, w, gy, need_dx=False))):
            fn()
            torch.cuda.synchronize()
            rows = cs.profile_kernels(lambda: [fn() for _ in range(10)])
            row[label] = {k.split('(')[0][-40:]: v / 10 for v, k, _ in rows
                          if 'entry' in k}
        out[f'{cin}->{cout}'] = row
    print('RESULT ' + json.dumps(out), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == '--time':
        time_tree()
        return
    sys.path.insert(0, str(ROOT / 'scripts'))
    import ab
    print(ab.card(), flush=True)
    trees = {name: make(name, edits) for name, edits in VARIANTS.items()}
    for name, tree in trees.items():
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               '--time'], cwd=tree, capture_output=True,
                              text=True, timeout=600)
        lines = [l for l in proc.stdout.splitlines()
                 if l.startswith('RESULT ')]
        if proc.returncode or not lines:
            print(name, 'FAILED', proc.returncode, proc.stderr[-3000:],
                  flush=True)
            continue
        res = json.loads(lines[0][7:])
        print(f'{name}: ' + '; '.join(
            f'{shape} forward {1e3 * sum(r["fwd"].values()):.1f} us, dw '
            f'{1e3 * sum(r["dw"].values()):.1f} us (errors '
            f'{r["err"]:.2f}, {r["err_dw"]:.2f} of the gates)'
            for shape, r in res.items()), flush=True)


if __name__ == '__main__':
    main()
