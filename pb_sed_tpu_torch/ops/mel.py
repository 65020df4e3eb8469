"""Mel filterbank construction (numpy), counterpart of
``pb_sed_tpu/ops/mel.py``: triangle filters with edges equally spaced on
the mel scale, evaluated at the rFFT bin centres."""
import numpy as np


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
