"""STFT front-end on the device.

Counterpart of ``pb_sed_tpu/ops/stft.py``: the same geometry (defaults:
shift 320, window 960, size 1024, 'half' fading, end padding to a full
frame grid, periodic Blackman window) and the magnitude via
``torch.fft.rfft``. Waveforms ``(B, S)`` ship to the device and are framed
there.
"""
import dataclasses

import numpy as np
import torch


def _window(name, length):
    n = np.arange(length)
    if name == 'blackman':
        # periodic blackman (paderbox symmetric_window=False)
        w = (0.42 - 0.5 * np.cos(2 * np.pi * n / length)
             + 0.08 * np.cos(4 * np.pi * n / length))
    elif name == 'hann':
        w = 0.5 - 0.5 * np.cos(2 * np.pi * n / length)
    elif name == 'hamming':
        w = 0.54 - 0.46 * np.cos(2 * np.pi * n / length)
    elif name in (None, 'boxcar', 'rect'):
        w = np.ones(length)
    else:
        raise ValueError(f'Unknown window {name}')
    return w.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class STFT:
    """STFT geometry (host-side, numpy) and framing/magnitude (torch)."""
    shift: int = 320
    window_length: int = 960
    size: int = 1024
    fading: str = 'half'
    pad: bool = True
    window: str = 'blackman'

    def __post_init__(self):
        if self.size < self.window_length:
            raise ValueError((self.size, self.window_length))
        if self.fading not in (None, 'none', 'half', 'full'):
            raise ValueError(self.fading)

    # -- geometry ---------------------------------------------------------
    @property
    def fade_pad(self):
        if self.fading == 'full':
            return self.window_length - self.shift
        if self.fading == 'half':
            return (self.window_length - self.shift) // 2
        return 0

    @property
    def num_bins(self):
        return self.size // 2 + 1

    def num_frames(self, num_samples):
        """Frames produced for a signal of ``num_samples`` samples."""
        num_samples = np.asarray(num_samples)
        padded = num_samples + 2 * self.fade_pad
        if self.pad:
            frames = np.ceil(
                np.maximum(padded - self.window_length, 0) / self.shift
            ).astype(np.int64) + 1
        else:
            frames = (padded - self.window_length) // self.shift + 1
        return frames if frames.ndim else int(frames)

    def num_samples_for_frames(self, num_frames):
        """Smallest sample count whose clip yields >= num_frames frames."""
        return ((num_frames - 1) * self.shift + self.window_length
                - 2 * self.fade_pad)

    def sample_to_onset_frame(self, sample):
        return np.floor_divide(np.asarray(sample), self.shift)

    def sample_to_offset_frame(self, sample):
        return -(-np.asarray(sample) // self.shift)

    def frame_timestamps(self, num_frames, sample_rate):
        """Score-grid timestamps: num_frames + 1 boundaries in seconds."""
        return np.arange(num_frames + 1) * self.shift / sample_rate

    # -- device -----------------------------------------------------------
    def frame(self, audio):
        """(B, S) -> (B, T, window_length) frames."""
        s = audio.shape[-1]
        t = self.num_frames(s)
        total = self.window_length + (t - 1) * self.shift
        pad_back = total - s - self.fade_pad
        x = torch.nn.functional.pad(audio, (self.fade_pad, max(pad_back, 0)))
        return x[:, :total].unfold(-1, self.window_length, self.shift)

    def magnitude(self, audio):
        """(B, S) -> (B, T, F) float32 magnitude spectrogram."""
        frames = self.frame(audio)
        win = torch.as_tensor(_window(self.window, self.window_length),
                              device=frames.device)
        spec = torch.fft.rfft(frames * win, n=self.size, dim=-1)
        return spec.abs().float()
