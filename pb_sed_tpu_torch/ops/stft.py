"""STFT front-end on the device.

Counterpart of ``pb_sed_tpu/ops/stft.py``: the same geometry (defaults:
shift 320, window 960, size 1024, 'half' fading, end padding to a full
frame grid, periodic Blackman window) and the magnitude via
``torch.fft.rfft``. Waveforms ``(B, S)`` ship to the device and are framed
there.

Time warping: a random anchor of the clip is moved by a random shift and
the frames read their samples at piecewise-linearly warped positions. The
warp parameters are sampled on the host (:func:`sample_time_warp`, so the
host-side label alignment, :func:`warp_sample_position`, uses the same
warp) and shipped as two scalars per example; the warped framing
(:meth:`STFT.frame_warped`) runs on the device as plain tensor code: an
index computation and a gather.
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
    # accepted for config parity with the JAX package's STFT (its DFT
    # variant); the magnitude here is always torch.fft.rfft
    backend: str = 'auto'

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

    def warped_frame_starts(self, num_samples, warp_anchor_out,
                            warp_anchor_in, valid_len):
        """(B, T) int64 start index of every warped frame in the
        fade-padded buffer of a (B, ``num_samples``) batch, with the
        buffer's length: the piecewise-linear source position per frame
        in float32, clipped so the window fits, truncated."""
        t = self.num_frames(num_samples)
        total = self.window_length + (t - 1) * self.shift
        padded = self.fade_pad + num_samples + max(
            total - num_samples - self.fade_pad, 0)
        dev = warp_anchor_out.device
        u = torch.arange(t, dtype=torch.float32, device=dev)[None, :] \
            * self.shift
        a_out = warp_anchor_out[:, None].float()
        a_in = warp_anchor_in[:, None].float()
        length = valid_len[:, None].float()
        lo = u * a_in / a_out.clamp(min=1.)
        hi = a_in + (u - a_out) * (length - a_in) / (length - a_out).clamp(
            min=1.)
        src = torch.where(u < a_out, lo, hi)
        src = src.clamp(0., float(padded - self.window_length))
        return src.to(torch.int64), padded

    def frame_warped(self, audio, warp_anchor_out, warp_anchor_in,
                     valid_len):
        """Warped framing: per-example piecewise-linear time warp.

        Args:
            audio: (B, S) waveforms (zero padded).
            warp_anchor_out: (B,) anchor position on the output time axis
                (samples).
            warp_anchor_in: (B,) position on the input axis the anchor is
                read from (samples).
            valid_len: (B,) valid samples per example.

        Returns: (B, T, window_length) frames.
        """
        s = audio.shape[-1]
        starts, padded = self.warped_frame_starts(
            s, warp_anchor_out, warp_anchor_in, valid_len)
        x = torch.nn.functional.pad(
            audio, (self.fade_pad, padded - s - self.fade_pad))
        idx = starts[:, :, None] + torch.arange(
            self.window_length, device=audio.device)[None, None, :]
        idx = idx.clamp(0, padded - 1)
        b, t, w = idx.shape
        return torch.gather(x, 1, idx.reshape(b, t * w)).reshape(b, t, w)

    def _frames_to_magnitude(self, frames):
        win = torch.as_tensor(_window(self.window, self.window_length),
                              device=frames.device)
        spec = torch.fft.rfft(frames * win, n=self.size, dim=-1)
        return spec.abs().float()

    def magnitude(self, audio):
        """(B, S) -> (B, T, F) float32 magnitude spectrogram."""
        return self._frames_to_magnitude(self.frame(audio))

    def magnitude_warped(self, audio, warp_anchor_out, warp_anchor_in,
                         valid_len):
        """(B, S) -> (B, T, F) magnitudes of the warped frames."""
        return self._frames_to_magnitude(self.frame_warped(
            audio, warp_anchor_out, warp_anchor_in, valid_len))


def sample_time_warp(valid_len, anchor_sampling_fn, shift_sampling_fn):
    """Host-side sampling of per-example warp parameters (the single
    implementation: ``data/transform.py`` consumes it, so host target
    alignment and device framing cannot drift apart).

    The anchor is drawn as a fraction of the clip (the recipe's default
    U(0.4, 0.6)), the shift likewise (U(-0.1, 0.1)). Returns
    (anchor_out, anchor_in) in samples, both clipped into
    [1, valid_len - 1].
    """
    anchor = float(anchor_sampling_fn()) * valid_len
    delta = float(shift_sampling_fn()) * valid_len
    anchor_out = float(np.clip(anchor, 1., valid_len - 1.))
    anchor_in = float(np.clip(anchor + delta, 1., valid_len - 1.))
    return anchor_out, anchor_in


def warp_sample_position(s, anchor_out, anchor_in, valid_len):
    """Map input sample positions to output positions under the warp.

    Inverse of the framing map in :meth:`STFT.frame_warped`; used on the
    host to co-warp event sample times before frame conversion.
    """
    s = np.asarray(s, dtype=np.float64)
    lo = s * anchor_out / max(anchor_in, 1.)
    hi = anchor_out + (s - anchor_in) * (valid_len - anchor_out) / max(
        valid_len - anchor_in, 1.)
    return np.where(s < anchor_in, lo, hi)
