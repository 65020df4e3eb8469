"""The port's front end (STFT, mel, eval-mode log-mel extractor) and
sequence masking against the JAX package on the same numpy inputs, and
against the golden fixtures ``tests/fixtures/parity_{magnitude,logmel}.npy``
(written by an independent implementation of the reference contract)."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pb_sed_tpu.models.base.model import (flatten_variables,
                                          unflatten_variables)
from pb_sed_tpu.ops import features as jfeatures
from pb_sed_tpu.ops import masking as jmasking
from pb_sed_tpu.ops import mel as jmel
from pb_sed_tpu.ops import stft as jstft
from pb_sed_tpu_torch.bridge import load_flat, random_flat
from pb_sed_tpu_torch.ops import features, masking, mel, stft

torch.set_num_threads(2)
FIXTURES = Path(__file__).parent / 'fixtures'


@pytest.fixture(scope='module')
def wav():
    from pb_sed_tpu.data.audio import read_wav
    audio, sr = read_wav(FIXTURES / 'parity.wav')
    assert sr == 16000
    return audio[0].astype(np.float32)


def test_stft_geometry_and_frames_match_jax():
    rng = np.random.RandomState(0)
    for geom in ({}, dict(shift=160, window_length=480, size=512),
                 dict(fading='full'), dict(pad=False)):
        ours, ref = stft.STFT(**geom), jstft.STFT(**geom)
        for n in (8000, 8001, 16000 + 123):
            assert ours.num_frames(n) == ref.num_frames(n)
            assert ours.num_samples_for_frames(n // 320) == \
                ref.num_samples_for_frames(n // 320)
        audio = rng.randn(2, 8000 + 77).astype(np.float32)
        frames = ours.frame(torch.from_numpy(audio)).numpy()
        np.testing.assert_array_equal(
            frames, np.asarray(ref.frame(jnp.asarray(audio))))  # a copy
    np.testing.assert_array_equal(
        stft.STFT().frame_timestamps(50, 16000),
        jstft.STFT().frame_timestamps(50, 16000))


def test_magnitude_matches_jax_and_fixture(wav):
    ours = stft.STFT().magnitude(torch.from_numpy(wav[None]))[0].numpy()
    ref = np.asarray(jstft.STFT(backend='fft').magnitude(wav[None]))[0]
    # both are f32 rFFTs of the same frames: f32 rounding of the sums
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    expected = np.load(FIXTURES / 'parity_magnitude.npy')
    # the fixture's own tolerance (tests/test_parity.py)
    np.testing.assert_allclose(ours, expected, rtol=1e-4, atol=1e-3)
    fbank = torch.from_numpy(mel.mel_filterbank(128, 16000, 1024))
    logmel = torch.log(torch.from_numpy(ours) @ fbank + 1e-4).numpy()
    np.testing.assert_allclose(logmel, np.load(FIXTURES / 'parity_logmel.npy'),
                               rtol=1e-3, atol=2e-3)


def test_mel_matches_jax():
    np.testing.assert_allclose(mel.hz2mel(np.array([0., 700., 8000.])),
                               np.asarray(jmel.hz2mel(
                                   jnp.array([0., 700., 8000.]))), rtol=1e-6)
    np.testing.assert_allclose(mel.mel2hz(np.array([10., 2000.])),
                               jmel.mel2hz(np.array([10., 2000.])),
                               rtol=1e-12)
    for args in ((128, 16000, 1024), (40, 22050, 2048, 20., 8000.)):
        # f32 (JAX) vs f64-then-f32 triangle arithmetic
        np.testing.assert_allclose(mel.mel_filterbank(*args),
                                   np.asarray(jmel.mel_filterbank(*args)),
                                   atol=1e-5)


@pytest.mark.parametrize('kwargs,kind', [
    ({}, 'audio'),
    (dict(add_deltas=True, add_delta_deltas=True), 'int16'),
    ({}, 'stft'),
])
def test_extractor_matches_jax(kwargs, kind):
    cfg = dict(sample_rate=16000, stft_size=512, stft_shift=160,
               stft_window_length=480, number_of_filters=24, **kwargs)
    rng = np.random.RandomState(4)
    seq_len = np.array([50, 31], np.int32)
    if kind == 'stft':
        x = rng.randn(2, 50, 257, 2).astype(np.float32)
    else:
        x = (.3 * rng.randn(2, 8000)).astype(np.float32)
        if kind == 'int16':
            x = np.round(x * jfeatures.AUDIO_INT16_SCALE).astype(np.int16)
    jmod = jfeatures.NormalizedLogMelExtractor(**cfg)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(seq_len))
    flat = random_flat(flatten_variables(variables), 5)
    ref = np.asarray(jmod.apply(unflatten_variables(flat), jnp.asarray(x),
                                jnp.asarray(seq_len)))
    ours = features.NormalizedLogMelExtractor(**cfg)
    load_flat(ours, flat)
    with torch.inference_mode():
        got = ours(torch.from_numpy(x), torch.from_numpy(seq_len)).numpy()
    assert got.shape == ref.shape
    # f32 front end on both sides; log(mel + 1e-4) amplifies the FFT's
    # f32 rounding where mel energy is small
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)


def test_masking_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 7, 4).astype(np.float32)
    seq_len = np.array([7, 4, 1], np.int32)
    tx, tl = torch.from_numpy(x), torch.from_numpy(seq_len)
    jx, jl = jnp.asarray(x), jnp.asarray(seq_len)
    # pure data movement and exact masks: bit-exact
    np.testing.assert_array_equal(
        masking.reverse_sequence(tx, tl, axis=1).numpy(),
        np.asarray(jmasking.reverse_sequence(jx, jl, axis=1)))
    np.testing.assert_array_equal(
        masking.take_last(tx, tl, axis=1).numpy(),
        np.asarray(jmasking.take_last(jx, jl, axis=1)))
    np.testing.assert_array_equal(
        masking.reverse_sequence(tx, None, axis=1).numpy(), x[:, ::-1])
    xt = np.swapaxes(x, 1, 2).copy()  # time-last, as the scores are
    np.testing.assert_array_equal(
        masking.compute_mask(torch.from_numpy(xt), tl).numpy(),
        np.asarray(jmasking.compute_mask(jnp.asarray(xt), jl)))
    np.testing.assert_allclose(
        masking.masked_mean(torch.from_numpy(xt), tl).numpy(),
        np.asarray(jmasking.masked_mean(jnp.asarray(xt), jl)), rtol=1e-6)


def test_warped_mel_filterbank_matches_jax():
    """Per-example VTLP-warped filterbanks on the same numpy warp factors
    and boundary ratios (identity, compress, stretch, breakpoints below
    and above f_max)."""
    warp = np.array([1., .8, 1.25, 1.1], np.float32)
    ratio = np.array([.5, .05, .9, 3.], np.float32)
    for args in ((128, 16000, 1024), (40, 22050, 512, 20., 8000.)):
        got = mel.warped_mel_filterbank(torch.from_numpy(warp),
                                        torch.from_numpy(ratio), *args)
        ref = np.asarray(jmel.warped_mel_filterbank(
            jnp.asarray(warp), jnp.asarray(ratio), *args))
        assert got.dtype == torch.float32 and got.shape == ref.shape
        # both f32 triangle arithmetic on the same f32 warped edges
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize('initialized', [0., 1.])
def test_extractor_training_statistics_match_jax(initialized):
    """Training mode without augmentation: the two-pass masked batch
    statistics normalize, and the running statistics are seeded (first
    call) or mixed in with momentum 0.95."""
    cfg = dict(sample_rate=16000, stft_size=512, stft_shift=160,
               stft_window_length=480, number_of_filters=24)
    rng = np.random.RandomState(8)
    x = (.3 * rng.randn(2, 8000)).astype(np.float32)
    x[1, 31 * 160:] = 0.
    seq_len = np.array([50, 31], np.int32)
    jmod = jfeatures.NormalizedLogMelExtractor(**cfg)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                          jnp.asarray(seq_len))
    flat = random_flat(flatten_variables(variables), 5)
    flat['batch_stats.initialized'] = np.float32(initialized)
    ref, mutated = jmod.apply(unflatten_variables(flat), jnp.asarray(x),
                              jnp.asarray(seq_len), training=True,
                              mutable=['batch_stats'])
    ours = features.NormalizedLogMelExtractor(**cfg)
    load_flat(ours, flat)
    ours.train()
    got = ours(torch.from_numpy(x), torch.from_numpy(seq_len))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-3, atol=1e-3)
    stats = mutated['batch_stats']
    for name in ('mean', 'var'):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(stats[name]), rtol=1e-4,
                                   atol=1e-4)
    assert float(ours.initialized) == 1.


def _augment_numpy(y, draws):
    """features.py:214-249 on numpy: zero [start, start + w) per mask,
    then add scale * noise."""
    y = y.copy()
    for w, start in draws.get('time_masks', ()):
        for b in range(y.shape[0]):
            y[b, start[b]:start[b] + w[b]] = 0.
    for w, start in draws.get('freq_masks', ()):
        for b in range(y.shape[0]):
            y[b, :, start[b]:start[b] + w[b]] = 0.
    if 'noise' in draws:
        y = y + draws['noise_scale'] * draws['noise']
    return y


def test_augmentation_apply_matches_numpy_formulas():
    rng = np.random.RandomState(9)
    b, t, m = 3, 40, 16
    y = rng.randn(b, t, m).astype(np.float32)
    draws = {
        'time_masks': [(np.array([0, 5, 12]), np.array([3, 0, 28])),
                       (np.array([2, 2, 0]), np.array([38, 10, 0]))],
        'freq_masks': [(np.array([3, 0, 16]), np.array([13, 5, 0]))],
        'noise_scale': rng.uniform(0, .2, (b, 1, 1)).astype(np.float32),
        'noise': rng.randn(b, t, m).astype(np.float32),
    }
    ref = _augment_numpy(y, draws)
    tdraws = {
        key: ([tuple(torch.from_numpy(a) for a in pair) for pair in value]
              if isinstance(value, list) else torch.from_numpy(value))
        for key, value in draws.items()}
    got = features.apply_augmentation(torch.from_numpy(y), tdraws).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_augmentation_draws_respect_their_bounds():
    cfg = dict(sample_rate=16000, stft_size=512, stft_shift=160,
               stft_window_length=480, number_of_filters=24,
               frequency_warping=True, warp_factor_truncation=float(
                   np.log(1.3)), n_time_masks=2, max_masked_time_steps=10,
               max_masked_time_rate=.2, n_frequency_masks=1,
               max_masked_frequency_bands=4, max_masked_frequency_rate=.2,
               max_noise_scale=.2)
    ours = features.NormalizedLogMelExtractor(**cfg)
    seq_len = torch.tensor([50, 31, 7, 2] * 50, dtype=torch.int32)
    gen = torch.Generator().manual_seed(3)
    draws = ours.draw_augmentation(seq_len, 50, gen)
    again = ours.draw_augmentation(seq_len, 50,
                                   torch.Generator().manual_seed(3))
    torch.testing.assert_close(draws['noise'], again['noise'])
    warp = draws['warp_factor']
    assert float(warp.min()) >= 1 / 1.3 - 1e-6
    assert float(warp.max()) <= 1.3 + 1e-6
    assert 0. <= float(draws['boundary_ratio'].min())
    assert float(draws['boundary_ratio'].max()) <= 5.
    max_w = torch.clamp((seq_len * .2).to(torch.int32), max=10)
    for w, start in draws['time_masks']:
        assert bool((w >= 0).all() and (w <= max_w).all())
        assert bool((start >= 0).all())
        assert bool((start < torch.clamp(seq_len - w, min=1)).all())
    for w, start in draws['freq_masks']:
        assert bool((w >= 0).all() and (w <= min(4, int(24 * .2))).all())
        assert bool((start >= 0).all() and (start + w <= 24).all())
    scale = draws['noise_scale']
    assert scale.shape == (200, 1, 1)
    assert 0. <= float(scale.min()) and float(scale.max()) <= .2
    assert draws['noise'].shape == (200, 50, 24)
    # the extractor in training mode with these draws: finite, padded
    # frames zero, and the same draws give the same features
    x = torch.randn(200, 8000, generator=gen) * .3
    ours.train()
    y = ours(x, seq_len, draws=draws)
    assert bool(torch.isfinite(y).all())
    assert float(y[2, 7:].detach().abs().max()) == 0.
    torch.testing.assert_close(ours(x, seq_len, draws=draws), y)
