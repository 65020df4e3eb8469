"""Normalized log-mel feature extractor.

Counterpart of ``pb_sed_tpu/ops/features.py:NormalizedLogMelExtractor``:

    waveform -> STFT -> |.| -> (warped) mel -> log(x + 1e-4) -> masked
    normalization -> learnable affine -> [training: time masks, frequency
    masks, additive noise] -> sequence mask [-> deltas]

The state (``scale``/``shift`` parameters, ``mean``/``var``/
``initialized`` buffers) carries the JAX package's names so checkpoints
move across through ``bridge.py``. In training (``self.training``) the
normalization uses the batch's two-pass masked statistics and updates the
running ones, and the augmentations act. Their random numbers are drawn
(:meth:`NormalizedLogMelExtractor.draw_augmentation`, from an explicit
``torch.Generator``) apart from where they are applied
(:func:`apply_augmentation`), so a test can hand fixed draws in. With
``warp_params`` a waveform batch is framed through the device-side time
warp (``STFT.magnitude_warped``).
"""
import math

import torch
from torch import nn

from pb_sed_tpu_torch.ops import mel as mel_ops
from pb_sed_tpu_torch.ops.cnn import update_running_stats
from pb_sed_tpu_torch.ops.masking import sequence_mask, take_last
from pb_sed_tpu_torch.ops.stft import STFT
from pb_sed_tpu_torch.parallel.mesh import (global_rows, global_sum,
                                            local_rows)
from pb_sed_tpu_torch.utils.config import Configurable

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


def apply_augmentation(y, draws):
    """Time masks, frequency masks and additive noise on (B, T, M)
    features from drawn parameters (``pb_sed_tpu/ops/features.py:
    214-249``): each mask zeroes ``[start, start + w)`` per example, the
    noise adds ``scale * noise``."""
    b, t, m = y.shape
    for axis, key in ((1, 'time_masks'), (2, 'freq_masks')):
        size = y.shape[axis]
        pos = torch.arange(size, device=y.device)[None, :]
        for w, start in draws.get(key, ()):
            hole = (pos >= start[:, None]) & (pos < (start + w)[:, None])
            hole = hole[:, :, None] if axis == 1 else hole[:, None, :]
            y = torch.where(hole, 0., y)
    if 'noise' in draws:
        y = y + draws['noise_scale'] * draws['noise']
    return y


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
        self.train(False)  # the JAX default: training=False
        self.sample_rate = sample_rate
        self.stft_size = stft_size
        self.number_of_filters = number_of_filters
        self.lowest_frequency = lowest_frequency
        self.highest_frequency = highest_frequency
        self.add_deltas = add_deltas
        self.add_delta_deltas = add_delta_deltas
        self.norm_momentum = norm_momentum
        self.norm_eps = norm_eps
        self.learnable_affine = learnable_affine
        self.frequency_warping = frequency_warping
        self.warp_factor_scale = warp_factor_scale
        self.warp_factor_truncation = (
            math.log(1.3) if warp_factor_truncation is None
            else warp_factor_truncation)
        self.boundary_ratio_scale = boundary_ratio_scale
        self.boundary_ratio_truncation = boundary_ratio_truncation
        self.n_time_masks = n_time_masks
        self.max_masked_time_steps = max_masked_time_steps
        self.max_masked_time_rate = max_masked_time_rate
        self.n_frequency_masks = n_frequency_masks
        self.max_masked_frequency_bands = max_masked_frequency_bands
        self.max_masked_frequency_rate = max_masked_frequency_rate
        self.max_noise_scale = max_noise_scale
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

    def draw_augmentation(self, seq_len, num_frames, generator=None):
        """The random parameters of one training call's augmentation
        (``pb_sed_tpu/ops/features.py:136-148, 214-249``), drawn with
        ``generator`` on ``seq_len``'s device: warp factor and boundary
        ratio per example, ``(w, start)`` per time and frequency mask,
        noise scale and noise. Only the augmentations the config turns on
        are drawn. Under a ``parallel.mesh.data_parallel`` shard they are
        drawn for the global batch (its ``seq_len`` gathered) and each
        rank keeps its rows, so N ranks draw what one device draws."""
        seq_len = global_rows(seq_len)
        b = seq_len.shape[0]
        m = self.number_of_filters
        dev = seq_len.device

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        draws = {}
        if self.frequency_warping:
            trunc = self.warp_factor_truncation
            normal = torch.randn((b,), generator=generator, device=dev)
            draws['warp_factor'] = torch.exp(
                (self.warp_factor_scale * normal).clamp(-trunc, trunc))
            expo = torch.empty((b,), device=dev).exponential_(
                generator=generator)
            draws['boundary_ratio'] = (
                expo * self.boundary_ratio_scale).clamp(
                    max=self.boundary_ratio_truncation)
        if self.n_time_masks > 0:
            max_w = (seq_len * self.max_masked_time_rate).to(
                torch.int32).clamp(max=self.max_masked_time_steps)
            draws['time_masks'] = []
            for _ in range(self.n_time_masks):
                w = (uniform(b) * (max_w + 1).float()).to(torch.int32)
                start = (uniform(b) * (seq_len - w).clamp(min=1).float()).to(
                    torch.int32)
                draws['time_masks'].append((w, start))
        if self.n_frequency_masks > 0:
            max_w = min(self.max_masked_frequency_bands,
                        int(m * self.max_masked_frequency_rate))
            draws['freq_masks'] = []
            for _ in range(self.n_frequency_masks):
                w = (uniform(b) * (max_w + 1)).to(torch.int32)
                start = (uniform(b) * (m - w).float()).to(torch.int32)
                draws['freq_masks'].append((w, start))
        if self.max_noise_scale > 0:
            draws['noise_scale'] = uniform(b, 1, 1) * self.max_noise_scale
            draws['noise'] = torch.randn((b, num_frames, m),
                                         generator=generator, device=dev)
        return {key: ([tuple(local_rows(v) for v in pair) for pair in value]
                      if isinstance(value, list) else local_rows(value))
                for key, value in draws.items()}

    def forward(self, x, seq_len, generator=None, draws=None,
                warp_params=None):
        """
        Args:
            x: (B, S) waveforms (float or int16 at AUDIO_INT16_SCALE),
                (B, T, F) magnitudes or (B, T, F, 2) real/imag STFT.
            seq_len: (B,) valid frames after the STFT.
            generator: the ``torch.Generator`` the training augmentation
                draws from (torch's default generator when None).
            draws: fixed augmentation parameters
                (:meth:`draw_augmentation`) instead of drawing them.
            warp_params: optional (anchor_out, anchor_in, valid_samples)
                tensors for the time-warped framing of a waveform batch.

        Returns: (B, T, M) features, or (B, T, M, C) with deltas.
        """
        if x.dtype == torch.int16:
            x = x.float() / AUDIO_INT16_SCALE
        if x.dim() == 2:
            if warp_params is not None:
                mag = self.stft.magnitude_warped(x.float(), *warp_params)
            else:
                mag = self.stft.magnitude(x.float())
        elif x.dim() == 4:
            mag = torch.sqrt(torch.sum(x.float() ** 2, dim=-1) + 1e-18)
        else:
            mag = x.float()
        t = mag.shape[1]
        if self.training and draws is None:
            draws = self.draw_augmentation(seq_len, t, generator)
        if self.training and self.frequency_warping:
            fbank = mel_ops.warped_mel_filterbank(
                draws['warp_factor'], draws['boundary_ratio'],
                self.number_of_filters, self.sample_rate, self.stft_size,
                self.lowest_frequency, self.highest_frequency)
            melspec = torch.einsum('btf,bfm->btm', mag, fbank)
        else:
            melspec = mag @ self.fbank
        logmel = torch.log(melspec + 1e-4)
        mask = sequence_mask(seq_len, t)[:, :, None]
        if self.training:
            # two-pass masked statistics over batch and valid frames (the
            # global batch's under a data-parallel shard: two reductions,
            # the mean's, then the squared deviations')
            total, valid = global_sum((logmel * mask).sum((0, 1)),
                                      mask.sum())
            count = valid.clamp(min=1.)
            mean = total / count
            var = global_sum(((logmel - mean).square() * mask).sum(
                (0, 1))) / count
            update_running_stats(self, mean, var, self.norm_momentum)
        else:
            mean, var = self.mean, self.var
        y = (logmel - mean) * torch.rsqrt(var + self.norm_eps)
        if self.learnable_affine:
            y = y * self.scale + self.shift
        if self.training:
            y = apply_augmentation(y, draws)
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
