"""Audio loading: WAV read, channel averaging, resampling, normalization,
time -> sample alignment.

Capability parity with padertorch ``AudioReader`` as configured by the
reference (``pb_sed/data_preparation/provider.py:304-312``:
``source_sample_rate, target_sample_rate=16000, average_channels=True,
normalization_domain='instance', normalization_type='max',
alignment_keys=['events']`` — converts ``events_{start,stop}_times`` to
``events_{start,stop}_samples``).

Backend: by default (``use_native``, channels averaged, no
``source_sample_rate``, peak or no normalization) the C++ reader of
``data/native.py`` decodes, averages, resamples (a Hann-windowed sinc)
and normalizes, as the JAX package's reader does; a file it rejects, and
every other configuration, goes through stdlib ``wave`` + numpy for PCM
WAV (no soundfile/librosa), scipy.io.wavfile for float WAV and
scipy.signal.resample_poly.
"""
import dataclasses
import wave
from math import gcd

import numpy as np

from pb_sed_tpu_torch.utils.config import Configurable


def read_wav(path):
    """Returns (audio (C, S) float32 in [-1, 1], sample_rate)."""
    path = str(path)
    try:
        with wave.open(path, 'rb') as fid:
            sr = fid.getframerate()
            n = fid.getnframes()
            c = fid.getnchannels()
            width = fid.getsampwidth()
            raw = fid.readframes(n)
        if width == 2:
            audio = np.frombuffer(raw, dtype='<i2').astype(np.float32)
            audio /= 32768.
        elif width == 4:
            audio = np.frombuffer(raw, dtype='<i4').astype(np.float32)
            audio /= 2147483648.
        elif width == 1:
            audio = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                     - 128.) / 128.
        elif width == 3:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32)
                   | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            audio = val.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f'unsupported sample width {width}')
        audio = audio.reshape(-1, c).T  # (C, S)
        return audio, sr
    except wave.Error:
        # float-PCM wavs are not supported by stdlib wave
        from scipy.io import wavfile
        sr, data = wavfile.read(path)
        if data.dtype.kind == 'i':
            data = data.astype(np.float32) / np.float32(
                np.iinfo(data.dtype).max + 1)
        elif data.dtype.kind == 'u':
            data = (data.astype(np.float32) - 128.) / 128.
        else:
            data = data.astype(np.float32)
        if data.ndim == 1:
            data = data[None, :]
        else:
            data = data.T
        return data, sr


def resample(audio, source_rate, target_rate):
    """Polyphase resampling along the last axis."""
    if source_rate == target_rate:
        return audio
    from scipy.signal import resample_poly
    g = gcd(int(source_rate), int(target_rate))
    up = int(target_rate) // g
    down = int(source_rate) // g
    return resample_poly(audio, up, down, axis=-1).astype(np.float32)


@dataclasses.dataclass
class AudioReader(Configurable):
    source_sample_rate: int = None
    target_sample_rate: int = 16000
    average_channels: bool = True
    normalization_domain: str = 'instance'
    normalization_type: str = 'max'
    alignment_keys: tuple = ('events',)
    use_native: bool = True  # C++ decode+resample (data/native.py)
    storage_dir: str = None  # accepted for config parity, unused

    def __call__(self, example):
        """Loads ``example['audio_path']`` -> ``example['audio_data']``
        (1, S) float32 and converts alignment times to samples."""
        audio = None
        if (self.use_native and self.average_channels
                and self.source_sample_rate is None
                and self.normalization_type in ('max', None, 'none')):
            from pb_sed_tpu_torch.data import native
            audio = native.load_wav(
                example['audio_path'], self.target_sample_rate,
                peak_normalize=self.normalization_type == 'max')
        if audio is None:
            audio, sr = read_wav(example['audio_path'])
            if self.source_sample_rate is not None:
                assert sr == self.source_sample_rate, (
                    sr, self.source_sample_rate)
            if self.average_channels and audio.shape[0] > 1:
                audio = audio.mean(0, keepdims=True)
            audio = resample(audio, sr, self.target_sample_rate)
            if self.normalization_type == 'max':
                peak = np.abs(audio).max()
                if peak > 0:
                    audio = audio / peak
            elif self.normalization_type in (None, 'none'):
                pass
            else:
                raise ValueError(self.normalization_type)
        example['audio_data'] = audio.astype(np.float32)
        example['seq_len'] = audio.shape[-1]
        for key in self.alignment_keys or ():
            start_t = example.get(f'{key}_start_times')
            stop_t = example.get(f'{key}_stop_times')
            if start_t is not None:
                example[f'{key}_start_samples'] = [
                    int(t * self.target_sample_rate) for t in start_t]
            if stop_t is not None:
                example[f'{key}_stop_samples'] = [
                    int(t * self.target_sample_rate) for t in stop_t]
        return example
