"""DSP parity: the PyTorch port's STFT front-end against the JAX package.

Same numpy inputs (0.5 s at 16 kHz, n_fft 1200 / hop 160 / win 400, plus a
length off the hop grid) go through both; everything is float32 on the
CPU.  Tolerances are float32 round-off of 1200-term basis sums.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.config import AudioConfig as JaxAudioConfig
from voicesplit_tpu.dsp.processor import AudioProcessor as JaxAudioProcessor
from voicesplit_tpu_torch.config import AudioConfig
from voicesplit_tpu_torch.dsp import normalize as pt_norm
from voicesplit_tpu_torch.dsp import stft as pt_stft
from voicesplit_tpu_torch.dsp.processor import AudioProcessor

# the JAX package's dsp/__init__ re-exports functions under the module names
jax_norm = importlib.import_module("voicesplit_tpu.dsp.normalize")
jax_stft = importlib.import_module("voicesplit_tpu.dsp.stft")

N_FFT, HOP, WIN = 1200, 160, 400
LENGTHS = [8000, 8000 + 37]  # on and off the hop grid


def _wav(L, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1330.0 * t)
    return (tone + 0.05 * rng.standard_normal((batch, L))).astype(np.float32)


def _np(x):
    return np.array(x, dtype=np.float32)


def test_num_frames_matches():
    for L in LENGTHS + [48000]:
        assert pt_stft.num_frames(L, N_FFT, HOP) == jax_stft.num_frames(L, N_FFT, HOP)


@pytest.mark.parametrize("L", LENGTHS)
def test_stft_real_imag_match(L):
    y = _wav(L)
    re_j, im_j = jax_stft.stft(jnp.asarray(y), N_FFT, HOP, WIN)
    re_t, im_t = pt_stft.stft(torch.from_numpy(y), N_FFT, HOP, WIN)
    assert re_t.shape == re_j.shape
    # |X| reaches ~60 here; 2e-4 is float32 round-off of a 1200-term sum
    np.testing.assert_allclose(re_t.numpy(), _np(re_j), atol=2e-4)
    np.testing.assert_allclose(im_t.numpy(), _np(im_j), atol=2e-4)


@pytest.mark.parametrize("L", LENGTHS)
def test_stft_magphase_match(L):
    y = _wav(L, seed=1)
    mag_j, ph_j = jax_stft.stft_magphase(jnp.asarray(y), N_FFT, HOP, WIN)
    mag_t, ph_t = pt_stft.stft_magphase(torch.from_numpy(y), N_FFT, HOP, WIN)
    np.testing.assert_allclose(mag_t.numpy(), _np(mag_j), atol=2e-4)
    # phase is only defined where the magnitude is not round-off
    strong = _np(mag_j) > 1e-2
    dphi = np.angle(np.exp(1j * (ph_t.numpy() - _np(ph_j))))
    assert np.abs(dphi[strong]).max() < 1e-3


@pytest.mark.parametrize("L", LENGTHS)
def test_wav2spec_batch_matches(L):
    y = _wav(L, seed=2)
    spec_j, ph_j = JaxAudioProcessor(JaxAudioConfig()).wav2spec_batch(jnp.asarray(y))
    spec_t, ph_t = AudioProcessor(AudioConfig(), device="cpu").wav2spec_batch(torch.from_numpy(y))
    assert spec_t.shape == spec_j.shape
    # normalized dB (1.0 = 100 dB): the 2e-4 |X| round-off of the basis sums
    # is a large relative error in the weakest bins, which the log turns
    # into up to ~0.006 dB there; 2e-4 (0.02 dB) holds it with margin
    np.testing.assert_allclose(spec_t.numpy(), _np(spec_j), atol=2e-4)
    assert spec_t.min() >= 0 and spec_t.max() <= 1


@pytest.mark.parametrize("L", LENGTHS)
def test_spec2wav_batch_matches(L):
    y = _wav(L, seed=3)
    jap = JaxAudioProcessor(JaxAudioConfig())
    spec, phase = (_np(a) for a in jap.wav2spec_batch(jnp.asarray(y)))
    wav_j = jap.spec2wav_batch(jnp.asarray(spec), jnp.asarray(phase), length=L)
    tap = AudioProcessor(AudioConfig(), device="cpu")
    wav_t = tap.spec2wav_batch(torch.from_numpy(spec), torch.from_numpy(phase), length=L)
    assert wav_t.shape == (2, L)
    # waveform peak ~0.5; float32 round-off through a 601-bin inverse basis
    np.testing.assert_allclose(wav_t.numpy(), _np(wav_j), atol=1e-5)


@pytest.mark.parametrize("L", LENGTHS)
def test_istft_roundtrip_and_parity(L):
    y = _wav(L, seed=4)
    mag, ph = pt_stft.stft_magphase(torch.from_numpy(y), N_FFT, HOP, WIN)
    rec = pt_stft.istft_magphase(mag, ph, N_FFT, HOP, WIN, length=L)
    n = (mag.shape[-2] - 1) * HOP  # samples the frame grid covers (the rest is zero)
    err = rec.numpy()[:, :n] - y[:, :n]
    snr = 10 * np.log10((y[:, :n] ** 2).sum() / (err**2).sum())
    assert snr > 80.0  # unnormalized STFT -> iSTFT is exact to float32 round-off
    rec_j = jax_stft.istft_magphase(
        jnp.asarray(mag.numpy()), jnp.asarray(ph.numpy()), N_FFT, HOP, WIN, length=L
    )
    np.testing.assert_allclose(rec.numpy(), _np(rec_j), atol=1e-5)


def test_overlap_add_matches():
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((3, 7, N_FFT)).astype(np.float32)
    out_j = jax_stft.overlap_add(jnp.asarray(frames), HOP)
    out_t = pt_stft.overlap_add(torch.from_numpy(frames), HOP)
    # each output sample sums at most n_fft/hop = 7.5 frames: exact to 1e-5
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), atol=1e-5)


def test_window_sumsquare_matches():
    for window in ("hann", "hamming"):
        np.testing.assert_allclose(
            pt_stft.window_sumsquare(11, N_FFT, HOP, WIN, window),
            jax_stft.window_sumsquare(11, N_FFT, HOP, WIN, window),
            atol=0,
        )


@pytest.mark.parametrize("name", ["amp_to_db", "db_to_amp", "normalize_db", "denormalize_db"])
def test_normalize_functions_match(name):
    rng = np.random.default_rng(6)
    x = {
        "amp_to_db": rng.uniform(0, 3, 500),
        "db_to_amp": rng.uniform(-120, 20, 500),
        "normalize_db": rng.uniform(-150, 10, 500),
        "denormalize_db": rng.uniform(-0.5, 1.5, 500),
    }[name].astype(np.float32)
    x[:5] = 0.0
    want = _np(getattr(jax_norm, name)(jnp.asarray(x)))
    got = getattr(pt_norm, name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
