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
