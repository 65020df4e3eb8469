"""The port's time warp against the JAX package's on the same audio,
anchors and lengths: the host functions ``sample_time_warp`` and
``warp_sample_position`` (equal to 1e-12), and the device framing
``STFT.frame_warped`` / ``magnitude_warped`` at the recipe's geometry
(shift 320, window 960, size 1024) and the tiny one of the CPU tests
(160 / 480 / 512).

Both packages compute the piecewise-linear source position of each frame
in float32 and truncate it to the frame's start index. Where that
position lies within 1e-3 of an integer, an f32 rounding that differs
between XLA and PyTorch may move the index by one sample, so those frames
are left out of the index comparison (the test prints how many the seed
has, and asserts they are few); every other frame's start index is equal
and its magnitudes agree within ``1e-4 + 1e-4 * max|ref|``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.ops import stft as jstft
from pb_sed_tpu_torch.ops import stft as tstft

torch.set_num_threads(2)

GEOMETRIES = {
    'recipe': dict(shift=320, window_length=960, size=1024),
    'tiny': dict(shift=160, window_length=480, size=512),
}


def _case(seed, num_samples, b=6):
    """Audio (B, S), valid lengths (several, the first the full buffer)
    and anchors: random ones, one at each clip bound [1, valid_len - 1],
    and one pair with anchor_in == anchor_out (the identity warp)."""
    rng = np.random.RandomState(seed)
    audio = (.3 * rng.randn(b, num_samples)).astype(np.float32)
    valid = np.array([num_samples] + list(
        rng.randint(num_samples // 3, num_samples, b - 1)), np.int32)
    for i, n in enumerate(valid):
        audio[i, n:] = 0.
    a_out = (rng.uniform(.4, .6, b) * valid).astype(np.float32)
    a_in = np.clip(a_out + rng.uniform(-.1, .1, b) * valid, 1.,
                   valid - 1.).astype(np.float32)
    a_out[1], a_in[1] = 1., valid[1] - 1.      # both clips reached
    a_out[2], a_in[2] = valid[2] - 1., 1.
    a_in[3] = a_out[3]                          # identity
    return audio, a_out, a_in, valid


def _source_positions(stft, num_samples, a_out, a_in, valid):
    """The f32 source position per frame, as both packages compute it."""
    t = stft.num_frames(num_samples)
    u = (np.arange(t, dtype=np.float32) * np.float32(stft.shift))[None, :]
    a_out, a_in = a_out[:, None], a_in[:, None]
    length = valid[:, None].astype(np.float32)
    lo = u * a_in / np.maximum(a_out, np.float32(1.))
    hi = a_in + (u - a_out) * (length - a_in) / np.maximum(
        length - a_out, np.float32(1.))
    return np.where(u < a_out, lo, hi)


@pytest.mark.parametrize('num_samples', [16000, 23456])
@pytest.mark.parametrize('geometry', sorted(GEOMETRIES))
def test_warped_framing_and_magnitude_match_jax(geometry, num_samples):
    audio, a_out, a_in, valid = _case(3, num_samples)
    js = jstft.STFT(backend='fft', **GEOMETRIES[geometry])
    ts = tstft.STFT(**GEOMETRIES[geometry])
    ref_frames = np.asarray(js.frame_warped(
        jnp.asarray(audio), jnp.asarray(a_out), jnp.asarray(a_in),
        jnp.asarray(valid)))
    args = [torch.from_numpy(a) for a in (audio, a_out, a_in, valid)]
    frames = ts.frame_warped(*args).numpy()
    assert frames.shape == ref_frames.shape == (
        len(audio), ts.num_frames(num_samples), ts.window_length)
    starts, padded = ts.warped_frame_starts(num_samples, *args[1:])
    starts = starts.numpy()
    assert starts.min() >= 0 and starts.max() <= padded - ts.window_length
    src = _source_positions(ts, num_samples, a_out, a_in, valid)
    near_integer = np.abs(src - np.round(src)) < 1e-3
    # the identity rows and the first frame sit on integers by
    # construction; they are compared all the same
    exact = (src == np.round(src))
    skipped = near_integer & ~exact
    print(f'{geometry} S={num_samples}: {int(skipped.sum())} of '
          f'{skipped.size} frames within 1e-3 of an integer left out')
    assert skipped.sum() <= .02 * skipped.size
    keep = ~skipped
    np.testing.assert_array_equal(frames[keep], ref_frames[keep])
    # the gathered frame really starts where the index says
    x = np.pad(audio, ((0, 0), (ts.fade_pad, padded - num_samples
                                - ts.fade_pad)))
    for b, t in ((0, 0), (1, 5), (4, frames.shape[1] - 1)):
        np.testing.assert_array_equal(
            frames[b, t], x[b, starts[b, t]:starts[b, t] + ts.window_length])
    ref_mag = np.asarray(js.magnitude_warped(
        jnp.asarray(audio), jnp.asarray(a_out), jnp.asarray(a_in),
        jnp.asarray(valid)))
    mag = ts.magnitude_warped(*args).numpy()
    assert mag.dtype == np.float32 and mag.shape == ref_mag.shape
    tol = 1e-4 + 1e-4 * float(np.abs(ref_mag).max())
    assert float(np.abs(mag - ref_mag)[keep].max()) <= tol


def test_identity_warp_is_the_plain_framing():
    """anchor_in == anchor_out and a full-length clip: the warp is the
    identity, and the warped frames are ``STFT.frame``'s."""
    ts = tstft.STFT(**GEOMETRIES['tiny'])
    rng = np.random.RandomState(0)
    audio = torch.from_numpy(rng.randn(2, 8000).astype(np.float32))
    anchor = torch.tensor([4000., 3000.])
    valid = torch.tensor([8000, 8000], dtype=torch.int32)
    torch.testing.assert_close(ts.frame_warped(audio, anchor, anchor, valid),
                               ts.frame(audio), rtol=0, atol=0)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_host_warp_functions_match_jax(seed):
    rng = np.random.RandomState(seed)
    for valid_len in (8000, 160000, 3):
        draws = rng.uniform(size=4)

        def fns(values):
            it = iter(values)
            return (lambda: .4 + .2 * next(it)), (
                lambda: -.1 + .2 * next(it))

        ref = jstft.sample_time_warp(valid_len, *fns(draws[:2]))
        got = tstft.sample_time_warp(valid_len, *fns(draws[:2]))
        assert ref == pytest.approx(got, abs=1e-12)
        assert 1. <= got[0] <= max(valid_len - 1., 1.)
        samples = rng.uniform(0, valid_len, 20)
        np.testing.assert_allclose(
            tstft.warp_sample_position(samples, *got, valid_len),
            jstft.warp_sample_position(samples, *ref, valid_len),
            rtol=0, atol=1e-12)
    # a clipped anchor: the shift pushes anchor_in past the clip's end
    ref = jstft.sample_time_warp(100, lambda: .99, lambda: .5)
    got = tstft.sample_time_warp(100, lambda: .99, lambda: .5)
    assert got == ref == (99., 99.)
