"""The port's C++ WAV reader (``pb_sed_tpu_torch/data/native.py`` over
``csrc/wav_reader.cpp``, built here with ``g++``) against the JAX
package's (``pb_sed_tpu.data.native`` over ``native/pbsed_native.cpp``)
on the same files: ``load_wav``, ``load_wav_batch`` and ``wav_info`` give
``np.array_equal`` results for int16, int24, int32, uint8 and float32
files, mono and stereo, at 8, 16, 22.05 and 44.1 kHz; and the two
packages' ``AudioReader()`` at their defaults give the same bits. Files
the decoder rejects (``WAVE_FORMAT_EXTENSIBLE``, longer than
``max_seconds``) and a set ``source_sample_rate`` go through ``read_wav``
in both. A build failure raises with the compiler's output; concurrent
first uses build once; the reader's source does not enter the CUDA
library's hash."""
import shutil
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from pb_sed_tpu.data import native as jax_native
from pb_sed_tpu.data.audio import AudioReader as JaxAudioReader
from pb_sed_tpu_torch.data import native
from pb_sed_tpu_torch.data.audio import AudioReader, read_wav

REPO = Path(__file__).resolve().parents[1]
ENCODINGS = ('int16', 'int24', 'int32', 'uint8', 'float32')
RATES = (8000, 16000, 22050, 44100)
PCM_GUID = bytes.fromhex('0100000000001000800000aa00389b71')


def _samples(audio, encoding):
    """(S, C) float audio in [-1, 1) -> the data chunk's bytes, the
    format tag and the bits per sample."""
    if encoding == 'int16':
        return (audio * 32767).astype('<i2').tobytes(), 1, 16
    if encoding == 'int32':
        return (audio * (2 ** 31 - 1)).astype('<i4').tobytes(), 1, 32
    if encoding == 'uint8':
        return (audio * 127 + 128).astype(np.uint8).tobytes(), 1, 8
    if encoding == 'float32':
        return audio.astype('<f4').tobytes(), 3, 32
    assert encoding == 'int24', encoding
    v = (audio * (2 ** 23 - 1)).astype('<i4').reshape(-1, 1).view(np.uint8)
    return v[:, :3].tobytes(), 1, 24


def write_wav(path, audio, rate, encoding='int16', extensible=False):
    """A RIFF/WAVE file of ``audio`` (S, C) written field by field; with
    ``extensible`` its format is ``WAVE_FORMAT_EXTENSIBLE`` (PCM)."""
    data, tag, bits = _samples(np.asarray(audio, np.float64), encoding)
    channels = audio.shape[1]
    block = channels * bits // 8
    fmt = struct.pack('<HHIIHH', 0xFFFE if extensible else tag, channels,
                      rate, rate * block, block, bits)
    if extensible:
        fmt += struct.pack('<HHI', 22, bits, (1 << channels) - 1) + PCM_GUID
    body = (b'WAVE' + b'fmt ' + struct.pack('<I', len(fmt)) + fmt
            + b'data' + struct.pack('<I', len(data)) + data)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_bytes(b'RIFF' + struct.pack('<I', len(body)) + body)
    return path


def _signal(rate, channels, seconds=.5, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * rate)) / rate
    tone = .4 * np.sin(2 * np.pi * 440. * t)[:, None]
    return np.clip(tone + .1 * rng.randn(len(t), channels), -.99, .99)


def _name(encoding, channels, rate):
    return f'{encoding}_{channels}ch_{rate}.wav'


def load_jax_reader():
    """The JAX package's reader, loaded: its loader swallows a failed
    build or a load that meets another process's half-written library and
    falls back to numpy, so a test that compares bits retries first."""
    for _ in range(5):
        if jax_native.available():
            return jax_native
        jax_native._tried = False
        time.sleep(1.)
    pytest.fail('the JAX package\'s C++ reader did not build or load')


@pytest.fixture(scope='module')
def jax_reader():
    return load_jax_reader()


@pytest.fixture(scope='module')
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp('wavs')
    for seed, (encoding, channels, rate) in enumerate(
            (e, c, r) for e in ENCODINGS for c in (1, 2) for r in RATES):
        write_wav(root / _name(encoding, channels, rate),
                  _signal(rate, channels, seed=seed), rate, encoding)
    return root


def _read(reader_cls, path, **kwargs):
    example = reader_cls(**kwargs)({'audio_path': str(path),
                                    'events_start_times': [.1],
                                    'events_stop_times': [.3]})
    return example


def _assert_same_example(got, ref):
    assert got['audio_data'].dtype == ref['audio_data'].dtype == np.float32
    assert np.array_equal(got['audio_data'], ref['audio_data'])
    for key in ('seq_len', 'events_start_samples', 'events_stop_samples'):
        assert got[key] == ref[key], key


@pytest.mark.parametrize('rate', RATES)
@pytest.mark.parametrize('channels', (1, 2))
@pytest.mark.parametrize('encoding', ENCODINGS)
def test_reader_equals_jax(files, jax_reader, encoding, channels, rate):
    path = files / _name(encoding, channels, rate)
    info = native.wav_info(path)
    assert info == jax_reader.wav_info(path)
    assert info == (int(.5 * rate), rate, channels)
    for kwargs in ({}, {'peak_normalize': False}, {'target_rate': 8000}):
        got = native.load_wav(path, **kwargs)
        ref = jax_reader.load_wav(path, **kwargs)
        assert got is not None and got.dtype == np.float32
        assert got.shape == ref.shape and np.array_equal(got, ref), kwargs
    got = _read(AudioReader, path)
    _assert_same_example(got, _read(JaxAudioReader, path))
    assert got['seq_len'] in (7999, 8000)
    if (channels, encoding) == (1, 'int16') and rate == 16000:
        # no resampling: read_wav's values up to the normalization's ulp
        plain = _read(AudioReader, path, use_native=False)
        assert np.abs(got['audio_data'] - plain['audio_data']).max() \
            <= 1.2e-7


def test_batch_equals_single_files(files, jax_reader):
    paths = sorted(files.iterdir()) + [files / 'missing.wav']
    batch = native.load_wav_batch(paths, num_threads=4)
    ref = jax_reader.load_wav_batch(paths, num_threads=4)
    assert len(batch) == len(ref) == len(paths)
    assert batch[-1] is None and ref[-1] is None
    for path, got, want in zip(paths[:-1], batch, ref):
        single = native.load_wav(path)
        assert np.array_equal(got, single), path.name
        assert np.array_equal(got, want), path.name
    assert native.load_wav_batch([]) == []


@pytest.mark.parametrize('case', ['extensible', 'over_max_seconds',
                                  'source_sample_rate', 'missing'])
def test_rejected_files_go_through_read_wav(tmp_path, jax_reader, case):
    """The decoder rejects a ``WAVE_FORMAT_EXTENSIBLE`` file (-2) and one
    longer than ``max_seconds`` (-3), and ``source_sample_rate`` keeps the
    native path off: each goes through ``read_wav`` in both packages, with
    equal results; a missing file raises in both."""
    rate = 44100 if case != 'over_max_seconds' else 16000
    audio = _signal(rate, 2 if case == 'extensible' else 1)
    path = tmp_path / 'x.wav'
    kwargs = {}
    if case == 'extensible':
        write_wav(path, audio, rate, extensible=True)
        assert native.load_wav(path) is None
        assert jax_reader.load_wav(path) is None
        assert native.wav_info(path) == jax_reader.wav_info(path) \
            == (len(audio), rate, 2)
    elif case == 'over_max_seconds':
        # 701 s: more samples than the reader's 700 s buffer
        write_wav(path, np.tile(audio, (1402, 1)), rate)
        assert native.load_wav(path, max_seconds=.25) is None
        assert jax_reader.load_wav(path, max_seconds=.25) is None
    elif case == 'source_sample_rate':
        write_wav(path, audio, rate)
        kwargs = {'source_sample_rate': rate}
    else:
        for reader in (AudioReader, JaxAudioReader):
            with pytest.raises(FileNotFoundError):
                _read(reader, path)
        assert native.load_wav(path) is None
        return
    got = _read(AudioReader, path, **kwargs)
    _assert_same_example(got, _read(JaxAudioReader, path, **kwargs))
    plain = _read(AudioReader, path, use_native=False, **kwargs)
    _assert_same_example(got, plain)
    if case == 'extensible':
        # resample_poly's values, not the sinc's
        assert not np.array_equal(got['audio_data'],
                                  jax_reader.load_wav(
                                      write_wav(tmp_path / 'y.wav', audio,
                                                rate)))


@pytest.mark.parametrize('updates,peak', [
    ({}, True), ({'normalization_type': None}, False),
    ({'use_native': False}, None), ({'average_channels': False}, None),
    ({'source_sample_rate': 44100}, None),
    ({'normalization_type': 'bogus'}, None),
])
def test_native_path_under_the_jax_conditions(tmp_path, monkeypatch,
                                              updates, peak):
    path = write_wav(tmp_path / 'x.wav', _signal(44100, 2), 44100)
    calls = []
    load_wav = native.load_wav

    def recording(path, target_rate, peak_normalize):
        calls.append((target_rate, peak_normalize))
        return load_wav(path, target_rate, peak_normalize)

    monkeypatch.setattr(native, 'load_wav', recording)
    if updates.get('normalization_type') == 'bogus':
        for reader in (AudioReader, JaxAudioReader):
            with pytest.raises(ValueError):
                _read(reader, path, **updates)
    else:
        _assert_same_example(_read(AudioReader, path, **updates),
                             _read(JaxAudioReader, path, **updates))
    assert calls == ([] if peak is None else [(16000, peak)])


def test_build_failure_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    broken = tmp_path / 'wav_reader.cpp'
    broken.write_text('extern "C" int pbsed_load_wav( { }\n')
    monkeypatch.setattr(native, 'SRC', broken)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(native, '_lib', None)
    for call in (native.available, lambda: native.load_wav(broken),
                 lambda: AudioReader()({'audio_path': str(broken)})):
        with pytest.raises(RuntimeError, match=r'g\+\+ failed') as info:
            call()
        assert 'error' in str(info.value)
    assert not list((tmp_path / 'build').iterdir())


BUILD_IN_PROCESS = '''
import sys
from pathlib import Path
from pb_sed_tpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
native.available()
print(native.library_path().name)
'''


def test_concurrent_first_uses_build_one_library(tmp_path, monkeypatch):
    """Threads of one process build once; processes that build into one
    directory at once each rename a whole library into place."""
    build_dir = tmp_path / 'build'
    monkeypatch.setattr(native, 'BUILD_DIR', build_dir)
    monkeypatch.setattr(native, '_lib', None)
    compiles = []
    run = subprocess.run

    def counting(cmd, **kwargs):
        compiles.append(cmd)
        return run(cmd, **kwargs)

    monkeypatch.setattr(native.subprocess, 'run', counting)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(native.lib()))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert len(compiles) == 1
    other = tmp_path / 'other'
    procs = [subprocess.Popen([sys.executable, '-c', BUILD_IN_PROCESS,
                               str(other)], cwd=REPO, text=True,
                              stdout=subprocess.PIPE) for _ in range(3)]
    names = {proc.communicate(timeout=120)[0].strip() for proc in procs}
    assert all(proc.returncode == 0 for proc in procs)
    assert names == {native.library_path().name}
    assert [p.name for p in other.iterdir()] == list(names)


def test_reader_source_stays_out_of_the_kernel_library(tmp_path,
                                                      monkeypatch):
    """``ops/kernels/build.py`` compiles and hashes ``*.cu`` / ``*.cuh``
    only: editing the reader's ``.cpp`` neither changes the CUDA
    library's name nor reaches ``nvcc``."""
    from pb_sed_tpu_torch.ops.kernels import build
    csrc = tmp_path / 'csrc'
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, 'CSRC_DIR', csrc)
    name = build.library_path()
    with (csrc / 'wav_reader.cpp').open('a') as fid:
        fid.write('// edited\n')
    assert build.library_path() == name
    with (csrc / 'maxpool.cu').open('a') as fid:
        fid.write('// edited\n')
    assert build.library_path() != name
    assert (csrc / 'wav_reader.cpp').exists()
    assert 'wav_reader.cpp' not in {p.name for p in csrc.glob('*.cu')}
