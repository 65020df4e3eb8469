"""Normalized log-mel feature extractor (eval mode).

Counterpart of ``pb_sed_tpu/ops/features.py:NormalizedLogMelExtractor``:

    waveform -> STFT -> |.| -> mel -> log(x + 1e-4) -> running-stat
    normalization -> learnable affine -> sequence mask [-> deltas]

The state (``scale``/``shift`` parameters, ``mean``/``var``/
``initialized`` buffers) carries the JAX package's names so checkpoints
move across through ``bridge.py``. The augmentation and warping settings
of a training config are accepted so its ``config.json`` loads; they act
only in training, which the port does not run yet.
"""
import torch
from torch import nn

from pb_sed_tpu.utils.config import Configurable
from pb_sed_tpu_torch.ops import mel as mel_ops
from pb_sed_tpu_torch.ops.masking import sequence_mask, take_last
from pb_sed_tpu_torch.ops.stft import STFT

# int16 waveform transport scale (the Collate(audio_dtype='int16')
# contract of the data pipeline)
AUDIO_INT16_SCALE = 4096.0


def _time_delta(x, n=2):
    """HTK-style delta along time with edge padding:
    ``sum_i i * (x[t+i] - x[t-i]) / (2 * sum_i i^2)``."""
    t = x.shape[1]
    xp = torch.cat([x[:, :1].expand(-1, n, *x.shape[2:]), x,
                    x[:, -1:].expand(-1, n, *x.shape[2:])], dim=1)
    denom = 2. * sum(i * i for i in range(1, n + 1))
    out = sum(i * (xp[:, n + i:t + n + i] - xp[:, n - i:t + n - i])
              for i in range(1, n + 1))
    return out / denom


class NormalizedLogMelExtractor(nn.Module, Configurable):
    """(B, S) audio, (B, T, F) magnitudes or (B, T, F, 2) real/imag STFT
    -> (B, T, M) normalized log-mel (or (B, T, M, C) with deltas)."""

    def __init__(self, sample_rate=16000, stft_size=1024, stft_shift=320,
                 stft_window_length=960, stft_fading='half',
                 stft_window='blackman', stft_backend='auto',
                 number_of_filters=128, lowest_frequency=50.,
                 highest_frequency=None, add_deltas=False,
                 add_delta_deltas=False, norm_momentum=0.95, norm_eps=1e-5,
                 learnable_affine=True, frequency_warping=False,
                 warp_factor_scale=.08, warp_factor_truncation=None,
                 boundary_ratio_scale=.5, boundary_ratio_truncation=5.,
                 n_time_masks=0, max_masked_time_steps=70,
                 max_masked_time_rate=.2, n_frequency_masks=0,
                 max_masked_frequency_bands=20,
                 max_masked_frequency_rate=.2, max_noise_scale=0.):
        """``stft_backend`` selects the JAX package's TPU DFT variant and
        has no effect here (the port always uses ``torch.fft.rfft``);
        ``norm_momentum`` and the augmentation settings act in training
        only."""
        super().__init__()
        self.sample_rate = sample_rate
        self.number_of_filters = number_of_filters
        self.add_deltas = add_deltas
        self.add_delta_deltas = add_delta_deltas
        self.norm_eps = norm_eps
        self.learnable_affine = learnable_affine
        self.stft = STFT(shift=stft_shift, window_length=stft_window_length,
                         size=stft_size, fading=stft_fading,
                         window=stft_window)
        m = number_of_filters
        fbank = mel_ops.mel_filterbank(m, sample_rate, stft_size,
                                       lowest_frequency, highest_frequency)
        self.register_buffer('fbank', torch.from_numpy(fbank),
                             persistent=False)
        self.register_buffer('mean', torch.zeros(m))
        self.register_buffer('var', torch.ones(m))
        self.register_buffer('initialized', torch.zeros(()))
        if learnable_affine:
            self.scale = nn.Parameter(torch.ones(m))
            self.shift = nn.Parameter(torch.zeros(m))

    @property
    def out_channels(self):
        """Channels of the feature map handed to the CNN."""
        return 1 + int(self.add_deltas) + int(self.add_delta_deltas)

    def forward(self, x, seq_len):
        """
        Args:
            x: (B, S) waveforms (float or int16 at AUDIO_INT16_SCALE),
                (B, T, F) magnitudes or (B, T, F, 2) real/imag STFT.
            seq_len: (B,) valid frames after the STFT.

        Returns: (B, T, M) features, or (B, T, M, C) with deltas.
        """
        if x.dtype == torch.int16:
            x = x.float() / AUDIO_INT16_SCALE
        if x.dim() == 2:
            mag = self.stft.magnitude(x.float())
        elif x.dim() == 4:
            mag = torch.sqrt(torch.sum(x.float() ** 2, dim=-1) + 1e-18)
        else:
            mag = x.float()
        logmel = torch.log(mag @ self.fbank + 1e-4)
        mask = sequence_mask(seq_len, logmel.shape[1])[:, :, None]
        y = (logmel - self.mean) * torch.rsqrt(self.var + self.norm_eps)
        if self.learnable_affine:
            y = y * self.scale + self.shift
        y = y * mask
        if not (self.add_deltas or self.add_delta_deltas):
            return y

        def edge_replicate(z):
            # deltas see the last valid frame past each sequence end,
            # not the zeroed padding
            return torch.where(mask > 0, z,
                               take_last(z, seq_len, axis=1, keepdims=True))

        channels = [y]
        delta = _time_delta(edge_replicate(y)) * mask
        if self.add_deltas:
            channels.append(delta)
        if self.add_delta_deltas:
            channels.append(_time_delta(edge_replicate(delta)) * mask)
        return torch.stack(channels, dim=-1)
