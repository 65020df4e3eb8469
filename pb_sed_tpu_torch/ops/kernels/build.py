"""Build, load and count the port's hand-written CUDA kernels.

The CUDA C++ sources in ``pb_sed_tpu_torch/csrc/*.cu`` (and the headers
they include, ``*.cuh``) are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into ONE shared library with a plain C interface,
under ``build/kernels/`` next to the package, and loaded with
``ctypes``. The library name carries a hash of the sources and flags, so
an edited source is rebuilt and a stale library is never loaded. There is no fallback: if ``nvcc`` fails, the build raises.

Each wrapper in ``ops/kernels/`` launches its kernel only on a CUDA
tensor (``require_cuda``), raises if the C function returns a CUDA error,
and adds one to its entry in ``LAUNCHES`` for every launch.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / 'kernels'
NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

# launches per kernel wrapper since the last reset_launches(); the
# ``*_padded`` entries count the conv pair's launches at shapes its
# kernels take only padded (Cout off a multiple of 16, an even extent) and
# the GRU pair's at an H it takes padded, the ``gru_*_wide`` ones the
# GRU pair's launches above H = 512, the ``conv2d_same*_entry`` ones the
# conv pair's launches that run the entry kernels (Cin < 16, forward and
# dw), the ``conv2d_same_f32*_entry`` ones the f32 pair's (the forward
# at Cin < 16, and a backward whose dw or dx runs them: Cin < 16, or the
# dx of Cout < 16); all of these count
# under the pair's own names too
LAUNCHES = {'conv2d_same': 0, 'maxpool_freq2': 0, 'gru_scan': 0,
            'conv2d_same_bwd': 0, 'maxpool_freq2_bwd': 0, 'gru_scan_bwd': 0,
            'avgpool_freq2': 0, 'avgpool_freq2_bwd': 0,
            'bnrelu_conv2d_same': 0, 'bnrelu_conv2d_same_bwd': 0,
            'gru_scan_bwd_fused': 0, 'maxpool2d': 0, 'maxpool2d_bwd': 0,
            'avgpool2d': 0, 'avgpool2d_bwd': 0, 'conv2d_same_padded': 0,
            'conv2d_same_bwd_padded': 0, 'conv2d_same_f32': 0,
            'conv2d_same_f32_bwd': 0, 'gru_scan_wide': 0,
            'gru_scan_bwd_wide': 0, 'gru_scan_padded': 0,
            'gru_scan_bwd_padded': 0, 'conv2d_same_entry': 0,
            'conv2d_same_bwd_entry': 0, 'conv2d_same_f32_entry': 0,
            'conv2d_same_f32_bwd_entry': 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    'pbsed_conv2d_same': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P),
    'pbsed_maxpool_freq2': (_P, _P, ctypes.c_longlong, _I, _P),
    'pbsed_gru_scan': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    'pbsed_conv2d_same_bwd': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P),
    'pbsed_maxpool_freq2_bwd': (_P, _P, _P, ctypes.c_longlong, _I, _P),
    'pbsed_gru_scan_bwd': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _P),
    'pbsed_avgpool_freq2': (_P, _I, _P, ctypes.c_longlong, _I, _I, _P),
    'pbsed_avgpool_freq2_bwd': (_P, _P, _I, ctypes.c_longlong, _I, _I, _P),
    'pbsed_bnrelu_conv2d_same': (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _P),
    'pbsed_bnrelu_conv2d_same_bwd': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _I, _P),
    'pbsed_gru_scan_bwd_fused': (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _P, _I, _I, _I, _I, _P),
    'pbsed_maxpool2d': (_P, _I, _P) + (_I,) * 6 + (_P,),
    'pbsed_maxpool2d_bwd': (_P, _P, _P) + (_I,) * 7 + (_P,),
    'pbsed_avgpool2d': (_P, _I, _P) + (_I,) * 7 + (_P,),
    'pbsed_avgpool2d_bwd': (_P, _P, _I) + (_I,) * 7 + (_P,),
    'pbsed_conv2d_same_f32': (_P,) * 5 + (_I,) * 8 + (_P,),
    'pbsed_conv2d_same_f32_bwd': (_P,) * 8 + (_I,) * 9 + (_P,),
}

# shape queries (no stream, no launch): which conv kernel a shape runs,
# with its ring depth and shared memory written to the two int pointers,
# the dw pass's pixel chunks and its workspace's f32 elements (a long
# long; csrc/conv2d.cu, csrc/conv2d_bwd.cu; the
# f32 conv's csrc/conv2d_f32.cu, whose design and split-buffer queries
# take the pass first, the former with the tile's width and rows written
# to two more int pointers, the latter a long long);
# which GRU kernel a shape runs, forward, split and fused backward, with
# its cluster size, rows, shared memory, co-resident clusters, units a
# block and bytes of w_hh resident and streamed a block written to the
# seven int pointers (csrc/gru.cu, gru_bwd.cu, gru_bwd_fused.cu)
_IP = ctypes.POINTER(ctypes.c_int)
_QUERIES = {
    'pbsed_conv2d_design': (_I,) * 5 + (_IP, _IP),
    'pbsed_conv2d_dw_design': (_I,) * 5 + (_IP, _IP),
    'pbsed_conv2d_dw_chunks': (_I,) * 8,
    'pbsed_conv2d_dw_workspace': (_I,) * 6,
    'pbsed_conv2d_f32_dw_chunks': (_I,) * 8,
    'pbsed_conv2d_f32_design': (_I,) * 6 + (_IP,) * 4,
    'pbsed_conv2d_f32_split_floats': (_I,) * 7,
    'pbsed_gru_design': (_I,) * 4 + (_IP,) * 7,
    'pbsed_gru_bwd_design': (_I,) * 4 + (_IP,) * 7,
    'pbsed_gru_bwd_fused_design': (_I,) * 4 + (_IP,) * 7,
}

_lib = None


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def require_cuda(*tensors):
    """Raise unless CUDA is available and every tensor lies on a CUDA
    device (the kernels have no other path)."""
    if not torch.cuda.is_available():
        raise RuntimeError('the CUDA kernels need a CUDA device; none is '
                           'available')
    for t in tensors:
        if t.device.type != 'cuda':
            raise RuntimeError(
                f'expected a CUDA tensor, got one on {t.device}')


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: the CUDA kernels are built from '
                       'source at first use and need the CUDA toolkit')


def library_path():
    sources = sorted(CSRC_DIR.glob('*.cu')) + sorted(CSRC_DIR.glob('*.cuh'))
    digest = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f'libpbsed_kernels_{digest.hexdigest()[:16]}.so'


def _run_all(cmds):
    """Run the commands at once; returns [(cmd, returncode, output)]."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [(cmd, proc.communicate()[0], proc) for cmd, proc in procs]
    return [(cmd, proc.returncode, out) for cmd, out, proc in outs]


def build():
    """Compile ``csrc/*.cu`` into the shared library unless it exists:
    one ``nvcc -c`` per source, all started together, then one link.
    Returns its path; the compiler's output is kept beside it (``.log``,
    with ``-Xptxas -v`` register and shared-memory use per kernel)."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f'{path.stem}.{os.getpid()}'
    sources = sorted(CSRC_DIR.glob('*.cu'))
    objects = [BUILD_DIR / f'{tag}.{src.stem}.o' for src in sources]
    nvcc = _nvcc()
    results = _run_all([[nvcc, *NVCC_FLAGS, '-c', '-o', str(obj), str(src)]
                        for src, obj in zip(sources, objects)])
    tmp = path.with_suffix(f'.{os.getpid()}.tmp')
    if all(rc == 0 for _, rc, _ in results):
        results += _run_all([[nvcc, '-shared', '-o', str(tmp),
                              *map(str, objects)]])
    path.with_suffix('.log').write_text(
        ''.join(f'$ {" ".join(cmd)}\n{out}' for cmd, _, out in results))
    for obj in objects:
        obj.unlink(missing_ok=True)
    failed = [(cmd, rc, out) for cmd, rc, out in results if rc != 0]
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f'nvcc failed ({rc}):\n{" ".join(cmd)}\n{out}')
    os.replace(tmp, path)
    return path


def lib():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        loaded = ctypes.CDLL(str(build()))
        for name, argtypes in {**_SIGNATURES, **_QUERIES}.items():
            fn = getattr(loaded, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        loaded.pbsed_conv2d_dw_workspace.restype = ctypes.c_longlong
        loaded.pbsed_conv2d_f32_split_floats.restype = ctypes.c_longlong
        loaded.pbsed_error_string.argtypes = (ctypes.c_int,)
        loaded.pbsed_error_string.restype = ctypes.c_char_p
        _lib = loaded
    return _lib


def launch(counter, fn_name, device, *args):
    """Call ``fn_name`` with ``args`` plus the current stream of
    ``device``, raise on a CUDA error, count the launch."""
    library = lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(library, fn_name)(*args, stream)
    if rc != 0:
        msg = library.pbsed_error_string(rc).decode()
        raise RuntimeError(f'{fn_name} failed: CUDA error {rc} ({msg})')
    LAUNCHES[counter] += 1
