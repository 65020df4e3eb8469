"""Mel filterbank construction, counterpart of ``pb_sed_tpu/ops/mel.py``:
triangle filters with edges equally spaced on the mel scale, evaluated at
the rFFT bin centres (numpy, static), and the VTLP-warped filterbank built
per example on the device from a warp factor and a boundary ratio
(torch, training augmentation)."""
import numpy as np
import torch


def hz2mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def mel2hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


def mel_edge_frequencies(num_filters, sample_rate, size,
                         lowest_frequency=50., highest_frequency=None):
    """(num_filters + 2,) triangle edge frequencies in Hz."""
    if highest_frequency is None:
        highest_frequency = sample_rate / 2
    mels = np.linspace(hz2mel(lowest_frequency), hz2mel(highest_frequency),
                       num_filters + 2)
    return mel2hz(mels)


def mel_filterbank(num_filters, sample_rate, size,
                   lowest_frequency=50., highest_frequency=None):
    """Static (F, M) float32 mel filterbank (F = size // 2 + 1)."""
    edges = mel_edge_frequencies(num_filters, sample_rate, size,
                                 lowest_frequency, highest_frequency)
    f = (np.arange(size // 2 + 1) * sample_rate / size)[:, None]  # (F, 1)
    lower, center, upper = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    up = (f - lower) / np.maximum(center - lower, 1e-6)
    down = (upper - f) / np.maximum(upper - center, 1e-6)
    return np.clip(np.minimum(up, down), 0.0, 1.0).astype(np.float32)


def _triangles(edges_hz, bin_hz):
    """(..., M + 2) triangle edges, (F,) bin frequencies -> (..., F, M)."""
    lower = edges_hz[..., None, :-2]
    center = edges_hz[..., None, 1:-1]
    upper = edges_hz[..., None, 2:]
    f = bin_hz.reshape((1,) * (edges_hz.dim() - 1) + (-1, 1))
    up = (f - lower) / (center - lower).clamp(min=1e-6)
    down = (upper - f) / (upper - center).clamp(min=1e-6)
    return torch.minimum(up, down).clamp(0., 1.)


def warp_frequencies(f, warp_factor, boundary_frequency, highest_frequency):
    """VTLP piecewise-linear warp: ``alpha * f`` below the breakpoint
    ``max(min(boundary, f_max / alpha, f_max), 1)``, then linear up to
    ``(f_max, f_max)``.

    Args:
        f: (..., K) frequencies in Hz.
        warp_factor: (...,) alpha.
        boundary_frequency: (...,) requested breakpoint in Hz.
        highest_frequency: scalar f_max.
    """
    alpha = warp_factor[..., None]
    f_max = highest_frequency
    bp = torch.minimum(boundary_frequency[..., None], f_max / alpha).clamp(
        max=f_max).clamp(min=1.)
    lo = alpha * f
    hi = alpha * bp + (f - bp) * (f_max - alpha * bp) / (f_max - bp).clamp(
        min=1.)
    return torch.where(f < bp, lo, hi)


def warped_mel_filterbank(warp_factor, boundary_ratio, num_filters,
                          sample_rate, size, lowest_frequency=50.,
                          highest_frequency=None):
    """(B, F, M) float32 filterbanks, one per example, on the device of
    ``warp_factor`` ((B,) warp factors, (B,) boundary ratios of f_max)."""
    if highest_frequency is None:
        highest_frequency = sample_rate / 2
    device = warp_factor.device
    edges = torch.as_tensor(
        mel_edge_frequencies(num_filters, sample_rate, size,
                             lowest_frequency, highest_frequency),
        dtype=torch.float32, device=device)[None, :]
    warped = warp_frequencies(edges, warp_factor.float(),
                              boundary_ratio.float() * highest_frequency,
                              highest_frequency)
    bin_hz = (torch.arange(size // 2 + 1, dtype=torch.float32, device=device)
              * sample_rate / size)
    return _triangles(warped, bin_hz)
