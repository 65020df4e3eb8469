"""The port's score filters (``ops/filters.py``) against the JAX
package's: the numpy ``correlate``, ``meanfilt``, ``medfilt``,
``maxfilt``, ``stepfilt`` and ``boundariesfilt`` equal JAX's (the same
numpy code: ``np.array_equal``), for odd and even lengths, every axis
and every ``mode``; the tensor filters on CPU tensors against JAX's
``*_jax`` at f32 tolerance (``1e-6 * max|ref|``: both take the same
windows, sums may round in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops import filters as jfilters
from pb_sed_tpu_torch.ops import filters as tfilters

torch.set_num_threads(2)

SHAPE = (9, 8, 37)   # (clips, classes, frames): every axis longer than n


def _scores(seed=0, shape=SHAPE):
    rng = np.random.RandomState(seed)
    x = rng.rand(*shape)
    x[..., 10:15] = 1.   # a plateau: ties in the max and the median
    return x


@pytest.mark.parametrize('axis', [0, 1, 2, -1])
@pytest.mark.parametrize('n', [1, 2, 3, 4, 7])
@pytest.mark.parametrize('mode', ['valid', 'same', 'full'])
def test_correlate_equals_jax(mode, n, axis):
    x = _scores(1)
    filt = np.random.RandomState(n).randn(n)
    got = tfilters.correlate(x, filt, axis=axis, mode=mode)
    ref = jfilters.correlate(x, filt, axis=axis, mode=mode)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('axis', [0, 1, -1])
@pytest.mark.parametrize('name,n', [
    ('meanfilt', 1), ('meanfilt', 4), ('meanfilt', 5),
    ('medfilt', 1), ('medfilt', 3), ('medfilt', 7),
    ('maxfilt', 1), ('maxfilt', 5),
    ('stepfilt', 2), ('stepfilt', 6),
    ('boundariesfilt', 0), ('boundariesfilt', 4),
])
def test_numpy_filters_equal_jax(name, n, axis):
    x = _scores(2)
    got = getattr(tfilters, name)(x, n, axis=axis)
    ref = getattr(jfilters, name)(x, n, axis=axis)
    assert np.shape(got) == np.shape(ref)
    assert np.array_equal(got, ref)


@pytest.mark.parametrize('axis', [0, 1, -1])
@pytest.mark.parametrize('name,n', [
    ('meanfilt', 1), ('meanfilt', 4), ('meanfilt', 5),
    ('medfilt', 1), ('medfilt', 4), ('medfilt', 7),
    ('maxfilt', 1), ('maxfilt', 4), ('maxfilt', 5),
    ('stepfilt', 2), ('stepfilt', 6),
    ('boundariesfilt', 0), ('boundariesfilt', 4),
])
def test_tensor_filters_match_jax(name, n, axis):
    x = _scores(3).astype(np.float32)
    got = getattr(tfilters, f'{name}_torch')(torch.from_numpy(x), n,
                                             axis=axis)
    ref = np.asarray(getattr(jfilters, f'{name}_jax')(jnp.asarray(x), n,
                                                      axis=axis))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-6 * float(np.abs(ref).max()))


@pytest.mark.parametrize('axis', [0, 2, -1])
def test_torch_cummax_matches_jax(axis):
    x = _scores(4).astype(np.float32)
    got = tfilters.torch_cummax(torch.from_numpy(x), axis=axis)
    ref = np.asarray(jfilters.jax_cummax(jnp.asarray(x), axis=axis))
    assert np.array_equal(got.numpy(), ref)
