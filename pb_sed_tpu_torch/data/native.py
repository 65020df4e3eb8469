"""ctypes bindings for the C++ WAV reader (``csrc/wav_reader.cpp``).

The library is compiled at first use with ``g++ -O3 -shared -fPIC
-pthread`` into ``build/native/`` next to the package, named with a hash
of the source and the flags (an edited source is rebuilt, a stale library
never loaded), and built to a temporary file that is then renamed into
place, so that processes building at once do not collide. There is no
fallback at the library level: a build or load failure raises with the
compiler's output, and ``available()`` is true or raises.

Per file, ``load_wav`` returns None where the decoder rejects the file
(open or parse failure, an encoding it does not decode such as
``WAVE_FORMAT_EXTENSIBLE``, more samples than ``max_seconds`` allow);
``AudioReader`` then decodes that file with ``read_wav``, as the JAX
package's reader does.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parents[1] / 'csrc' / 'wav_reader.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
CXX_FLAGS = ('-O3', '-shared', '-fPIC', '-pthread')

_lib = None
_lock = threading.Lock()  # the loader's threads may start it at once


def library_path():
    digest = hashlib.sha256(' '.join(CXX_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f'libwav_reader_{digest.hexdigest()[:16]}.so'


def build():
    """Compile the reader unless it exists; returns the library's path.
    Raises with ``g++``'s output if the compiler fails."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', *CXX_FLAGS, '-o', str(tmp), str(SRC)]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed ({out.returncode}):\n'
                           f'{" ".join(cmd)}\n{out.stderr}')
    os.replace(tmp, path)
    return path


def lib():
    """The loaded reader (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _load(build())
    return _lib


def _load(path):
    loaded = ctypes.CDLL(str(path))
    loaded.pbsed_load_wav.restype = ctypes.c_int
    loaded.pbsed_load_wav.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    loaded.pbsed_wav_info.restype = ctypes.c_long
    loaded.pbsed_wav_info.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    loaded.pbsed_load_wav_batch.restype = None
    loaded.pbsed_load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    return loaded


def available():
    """True once the reader is built and loaded; raises otherwise."""
    return lib() is not None


def load_wav(path, target_rate=16000, peak_normalize=True,
             max_seconds=700.):
    """Returns (1, S) float32 mono audio at target_rate, or None where the
    decoder rejects the file."""
    max_out = int(max_seconds * target_rate)
    out = np.empty(max_out, dtype=np.float32)
    n = lib().pbsed_load_wav(
        str(path).encode(), int(target_rate), int(bool(peak_normalize)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_out)
    if n < 0:
        return None
    return out[:n].copy()[None, :]


def load_wav_batch(paths, target_rate=16000, peak_normalize=True,
                   max_seconds=700., num_threads=8):
    """Decode many wavs concurrently on the C++ worker pool.

    Returns a list of (1, S) float32 arrays, None for a file the decoder
    rejects.
    """
    library = lib()
    n = len(paths)
    if n == 0:
        return []
    max_out = int(max_seconds * target_rate)
    buffers = np.empty((n, max_out), dtype=np.float32)
    out_ptrs = (ctypes.POINTER(ctypes.c_float) * n)(*[
        buffers[i].ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        for i in range(n)
    ])
    path_arr = (ctypes.c_char_p * n)(*[
        str(p).encode() for p in paths])
    lens = (ctypes.c_long * n)()
    library.pbsed_load_wav_batch(
        path_arr, n, int(target_rate), int(bool(peak_normalize)),
        int(num_threads), out_ptrs, max_out, lens)
    return [
        buffers[i, :lens[i]].copy()[None, :] if lens[i] >= 0 else None
        for i in range(n)
    ]


def wav_info(path):
    """Returns (num_samples, sample_rate, channels), or None where the
    header does not parse."""
    sr = ctypes.c_int()
    ch = ctypes.c_int()
    n = lib().pbsed_wav_info(str(path).encode(), ctypes.byref(sr),
                             ctypes.byref(ch))
    if n < 0:
        return None
    return int(n), int(sr.value), int(ch.value)
