"""Random samplers with the semantics of paderbox.utils.random_utils
(``Uniform``, ``LogTruncatedNormal``, ``TruncatedExponential``), used for
scale augmentation, mel warping and time warping
(``pb_sed/data_preparation/provider.py:10,302-378``,
``pb_sed/experiments/weak_label_crnn/training.py:12-15,195-209``).

Host-side numpy samplers (data pipeline); the device-side augmentations
consume their *outputs* as arrays, so numpy RNG here keeps the data
pipeline reproducible without threading device generators through workers.
"""
import numpy as np
from pb_sed_tpu_torch.utils.config import Configurable


class _Sampler(Configurable):
    def __init__(self, rng=None):
        self.rng = np.random if rng is None else rng

    def __call__(self, size=None):
        raise NotImplementedError


class Uniform(_Sampler):
    def __init__(self, low=0., high=1., rng=None):
        super().__init__(rng)
        self.low = low
        self.high = high

    def __call__(self, size=None):
        return self.rng.uniform(self.low, self.high, size)


class TruncatedNormal(_Sampler):
    """Normal(loc, scale) re-sampled until |x - loc| <= truncation."""

    def __init__(self, loc=0., scale=1., truncation=3., rng=None):
        super().__init__(rng)
        self.loc = loc
        self.scale = scale
        self.truncation = truncation

    def __call__(self, size=None):
        x = self.rng.normal(self.loc, self.scale, size)
        while True:
            invalid = np.abs(x - self.loc) > self.truncation
            if not np.any(invalid):
                break
            resampled = self.rng.normal(self.loc, self.scale, size)
            x = np.where(invalid, resampled, x) if size is not None else resampled
        return x


class LogTruncatedNormal(TruncatedNormal):
    """exp(TruncatedNormal): multiplicative factors around exp(loc)."""

    def __call__(self, size=None):
        return np.exp(super().__call__(size))


class TruncatedExponential(_Sampler):
    """Exponential(scale) + loc re-sampled until x - loc <= truncation."""

    def __init__(self, loc=0., scale=1., truncation=3., rng=None):
        super().__init__(rng)
        self.loc = loc
        self.scale = scale
        self.truncation = truncation

    def __call__(self, size=None):
        x = self.rng.exponential(self.scale, size) + self.loc
        while True:
            invalid = (x - self.loc) > self.truncation
            if not np.any(invalid):
                break
            resampled = self.rng.exponential(self.scale, size) + self.loc
            x = np.where(invalid, resampled, x) if size is not None else resampled
        return x
