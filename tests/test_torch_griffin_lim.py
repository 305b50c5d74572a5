"""Griffin-Lim and the wavernn / waveglow audio processors: the port against
the JAX package on the CPU.

Same numpy inputs through both (0.5 s of tones in noise at each backend's
sample rate); everything float32.  Griffin-Lim starts from JAX's own
angles (``2π·U[0,1)`` of ``PRNGKey(0)``, which torch cannot draw), passed to
the port.  Tolerances: spectrograms and mels 1e-4 absolute (the dB /
log10 of 1025- and 513-bin basis sums; waveglow's ln spectrogram 1e-3,
LOG_SPEC_ATOL), waveforms 1e-4 of their peak
(overlap-add of those sums; inverse preemphasis sums up to ~50 past
samples), Griffin-Lim after 4 rounds 1e-3 of the peak (each round
re-normalizes the phase, so round-off of quiet bins carries over).
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.config import AudioConfig as JaxAudioConfig
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.dsp.processor import AudioProcessor as JaxAudioProcessor
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import separate as separate_cli
from voicesplit_tpu_torch.config import AudioConfig, load_config_from_str
from voicesplit_tpu_torch.dsp import griffin_lim as gl_module
from voicesplit_tpu_torch.dsp import normalize as pt_norm
from voicesplit_tpu_torch.dsp.griffin_lim import griffin_lim, griffin_lim_angles
from voicesplit_tpu_torch.dsp.processor import AudioProcessor
from voicesplit_tpu_torch.models.masknet import make_masknet

# the JAX package's dsp/__init__ re-exports functions under the module names
jax_norm = importlib.import_module("voicesplit_tpu.dsp.normalize")
jax_gl_module = importlib.import_module("voicesplit_tpu.dsp.griffin_lim")

SPEC_ATOL = 1e-4
# waveglow's spec is ln|S|, unbounded below to ln(1e-5): a quiet bin's
# relative round-off (its 1024-term sum cancels to ~1e-4 of the frame's
# energy) is its absolute error there, up to 6e-4 seen
LOG_SPEC_ATOL = 1e-3
WAVE_REL = 1e-4
GL_REL = 1e-3
GL_ITERS = 4

# (backend, mel_spec)
BACKENDS = [("voicefilter", False), ("wavernn", False), ("wavernn", True),
            ("waveglow", False), ("waveglow", True)]
IDS = [f"{b}{'-mel' if m else ''}" for b, m in BACKENDS]


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _processors(backend, mel_spec=False, iters=GL_ITERS):
    out = []
    for cfg_cls, ap_cls, kw in ((JaxAudioConfig, JaxAudioProcessor, {}),
                                (AudioConfig, AudioProcessor, {"device": "cpu"})):
        cfg = cfg_cls(backend=backend, mel_spec=mel_spec)
        cfg.active.griffin_lim_iters = iters
        out.append(ap_cls(cfg, **kw))
    return out


def _wav(sr, seconds=0.5, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t) + 0.1 * np.sin(2 * np.pi * 1330.0 * t)
    return (tone + 0.05 * rng.standard_normal((batch, len(t)))).astype(np.float32)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _close_to_peak(got, want, rel):
    want = np.asarray(want)
    err = np.abs(np.asarray(got) - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _jax_angles(shape, key=0):
    """JAX's Griffin-Lim initial phase for `shape` (`dsp/griffin_lim.py:33`)."""
    return np.array(2.0 * jnp.pi * jax.random.uniform(jax.random.PRNGKey(key), shape, jnp.float32))


def jax_stft_mag(jap, wav):
    from voicesplit_tpu.dsp.stft import stft_magphase

    mag, phase = stft_magphase(jnp.asarray(wav), jap.n_fft, jap.hop_length, jap.win_length)
    return _np(mag), _np(phase)


def pt_stft_mag(ap, y):
    from voicesplit_tpu_torch.dsp.stft import stft_magphase

    return stft_magphase(y, ap.n_fft, ap.hop_length, ap.win_length)[0]


# ---------------------------------------------------------------------------
# Griffin-Lim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_iters", [0, 1, GL_ITERS])
def test_griffin_lim_matches_jax_from_its_angles(n_iters):
    jap, ap = _processors("voicefilter")
    mag, _ = jax_stft_mag(jap, _wav(16000))
    want = jax_gl_module.griffin_lim(jnp.asarray(mag), ap.n_fft, ap.hop_length, ap.win_length,
                                     n_iters=n_iters, key=jax.random.PRNGKey(0))
    got = griffin_lim(torch.from_numpy(mag), ap.n_fft, ap.hop_length, ap.win_length,
                      n_iters=n_iters, angles=torch.from_numpy(_jax_angles(mag.shape)))
    assert got.shape == want.shape == (2, (mag.shape[-2] - 1) * ap.hop_length)
    _close_to_peak(got.numpy(), _np(want), GL_REL)


def test_griffin_lim_angles_default_draw_and_device():
    a = griffin_lim_angles((3, 5))
    b = griffin_lim_angles((3, 5), torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and a.dtype == torch.float32 and a.device.type == "cpu"
    assert float(a.min()) >= 0.0 and float(a.max()) < 2 * math.pi
    c = griffin_lim_angles((3, 5), torch.Generator().manual_seed(1))
    assert not torch.equal(a, c)


def test_griffin_lim_converges():
    """Spectral convergence after the last round is no worse than after the
    first (60 rounds, the config's count)."""
    _, ap = _processors("voicefilter")
    y = torch.from_numpy(_wav(16000, batch=1))
    mag = pt_stft_mag(ap, y)

    def convergence(n):
        rec = griffin_lim(mag, ap.n_fft, ap.hop_length, ap.win_length, n_iters=n)
        return float(torch.linalg.vector_norm(pt_stft_mag(ap, rec) - mag) / torch.linalg.vector_norm(mag))

    first, last = convergence(1), convergence(60)
    assert last <= first, (first, last)


@pytest.mark.parametrize("backend,mel_spec", BACKENDS, ids=IDS)
def test_spec2wav_without_phase_matches_jax(backend, mel_spec, monkeypatch):
    """`spec2wav(spec, None)`: denormalize, mel → linear, ``S**power``,
    Griffin-Lim, inverse preemphasis; from JAX's angles."""
    jap, ap = _processors(backend, mel_spec)
    spec, _ = jap.wav2spec(_wav(ap.sample_rate, batch=1)[0])
    monkeypatch.setattr(gl_module, "griffin_lim_angles", lambda shape, generator=None:
                        torch.from_numpy(_jax_angles(tuple(shape))))
    want = jap.spec2wav(spec, None)
    got = ap.spec2wav(spec, None)
    assert got.shape == want.shape and np.isfinite(got).all()
    _close_to_peak(got, want, GL_REL)


# ---------------------------------------------------------------------------
# The processors' batch transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend,mel_spec", BACKENDS, ids=IDS)
def test_wav2spec_batch_matches_jax(backend, mel_spec):
    jap, ap = _processors(backend, mel_spec)
    y = _wav(ap.sample_rate)
    spec_j, phase_j = jap.wav2spec_batch(jnp.asarray(y))
    spec, phase = ap.wav2spec_batch(torch.from_numpy(y))
    assert spec.shape == spec_j.shape and phase.shape == phase_j.shape
    atol = LOG_SPEC_ATOL if backend == "waveglow" else SPEC_ATOL
    np.testing.assert_allclose(spec.numpy(), _np(spec_j), atol=atol)
    # the phase of bins with magnitude: compare it as a unit vector
    np.testing.assert_allclose(torch.cos(phase).numpy(), np.cos(_np(phase_j)), atol=2e-2)


@pytest.mark.parametrize("backend,mel_spec", BACKENDS, ids=IDS)
def test_spec2wav_batch_matches_jax(backend, mel_spec):
    """The differentiable mixed-phase inversion from the same spec and phase."""
    jap, ap = _processors(backend, mel_spec)
    spec_j, phase_j = jap.wav2spec_batch(jnp.asarray(_wav(ap.sample_rate, seed=1)))
    spec, phase = _np(spec_j), _np(phase_j)
    want = jap.spec2wav_batch(jnp.asarray(spec), jnp.asarray(phase))
    got = ap.spec2wav_batch(torch.from_numpy(spec), torch.from_numpy(phase))
    assert got.shape == want.shape
    _close_to_peak(got.numpy(), _np(want), WAVE_REL)


@pytest.mark.parametrize("backend", ["voicefilter", "wavernn", "waveglow"])
def test_mel_batch_and_get_mel_match_jax(backend):
    jap, ap = _processors(backend)
    y = _wav(ap.sample_rate, seed=2)
    want = jap.mel_batch(jnp.asarray(y))
    got = ap.mel_batch(torch.from_numpy(y))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _np(want), atol=SPEC_ATOL)
    np.testing.assert_allclose(ap.get_mel(y[0]), jap.get_mel(y[0]), atol=SPEC_ATOL)
    np.testing.assert_allclose(ap.get_mel_bucketed(y[0, :-37], 0.2),
                               jap.get_mel_bucketed(y[0, :-37], 0.2), atol=SPEC_ATOL)


@pytest.mark.parametrize("backend", ["wavernn", "waveglow"])
def test_mel_projections_match_jax(backend):
    jap, ap = _processors(backend, True)
    np.testing.assert_array_equal(ap.mel_basis, jap.mel_basis)
    mag = np.abs(np.random.default_rng(3).standard_normal((2, 9, ap.num_freq))).astype(np.float32)
    mel_j = jap.mag_to_mel(jnp.asarray(mag))
    mel = ap.mag_to_mel(torch.from_numpy(mag))
    np.testing.assert_allclose(mel.numpy(), _np(mel_j), rtol=1e-5, atol=1e-6)
    lin_j = jap.mel_to_linear(mel_j)
    lin = ap.mel_to_linear(torch.from_numpy(_np(mel_j)))
    np.testing.assert_allclose(lin.numpy(), _np(lin_j), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("coef", [0.0, 0.97, 0.98])
def test_preemphasis_matches_jax(coef):
    y = _wav(16000, seed=4)
    pre_j = jax_norm.preemphasis(jnp.asarray(y), coef)
    pre = pt_norm.preemphasis(torch.from_numpy(y), coef)
    np.testing.assert_allclose(pre.numpy(), _np(pre_j), atol=1e-7)
    inv_j = jax_norm.inv_preemphasis(pre_j, coef)
    inv = pt_norm.inv_preemphasis(torch.from_numpy(_np(pre_j)), coef)
    _close_to_peak(inv.numpy(), _np(inv_j), 1e-6)
    _close_to_peak(inv.numpy(), y, 1e-5)  # the IIR filter undoes the FIR one


def test_inv_preemphasis_against_its_loop():
    """The doubling passes equal the defining recursion x[n] = y[n] + c·x[n-1]."""
    y = np.random.default_rng(5).standard_normal((2, 1000))
    want = np.zeros_like(y)
    for n in range(y.shape[-1]):
        want[:, n] = y[:, n] + (0.97 * want[:, n - 1] if n else 0.0)
    got = pt_norm.inv_preemphasis(torch.from_numpy(y), 0.97)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# The host API
# ---------------------------------------------------------------------------


def test_wavernn_load_wav_trims_as_jax(tmp_path):
    from voicesplit_tpu.dsp.audio_io import save_wav_float

    jap, ap = _processors("wavernn")
    y = np.concatenate([np.zeros(4000, np.float32), _wav(16000, batch=1)[0],
                        np.zeros(6000, np.float32)])
    save_wav_float(y, str(tmp_path / "a.wav"), 16000)
    got, want = ap.load_wav(str(tmp_path / "a.wav")), jap.load_wav(str(tmp_path / "a.wav"))
    assert 0 < len(got) < len(y)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,args", [
    ("mulaw_encode", (9,)), ("mulaw_decode", (9,)), ("quantize", (9,)),
    ("dequantize", (9,)), ("encode_16bits", ()),
])
def test_static_utilities_match_jax(name, args):
    x = np.random.default_rng(6).uniform(-1, 1, 257).astype(np.float32)
    np.testing.assert_array_equal(getattr(AudioProcessor, name)(x, *args),
                                  getattr(JaxAudioProcessor, name)(x, *args))


def test_find_endpoint_matches_jax():
    jap, ap = _processors("voicefilter")
    y = np.concatenate([_wav(16000, seconds=1.0, batch=1)[0], np.zeros(20000, np.float32)])
    assert ap.find_endpoint(y) == jap.find_endpoint(y) < len(y)
    assert ap.find_endpoint(y[:16000]) == jap.find_endpoint(y[:16000]) == 16000


def test_separate_cli_griffin_lim(tmp_path):
    """`cli.separate --griffin_lim --device cpu`: the mask of the mixture's
    spectrogram, then `spec2wav(est, None)`, written peak-normalized."""
    import json
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    d = json.loads((repo / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"]["griffin_lim_iters"] = GL_ITERS
    d["model"].update(conv_channels=4, conv_out_channels=2, lstm_dim=8, fc1_dim=12)
    d["train_config"]["compute_dtype"] = "float32"
    (tmp_path / "c.json").write_text(json.dumps(d))
    config = load_config_from_str(json.dumps(d))
    model = weights.init_random_(make_masknet(config, device="cpu"), 0)
    weights.save(model, str(tmp_path / "w.pt"))
    ap = AudioProcessor(config.audio, device="cpu")
    mixed = _wav(16000, batch=1)[0]
    emb = np.random.default_rng(7).standard_normal(256).astype(np.float32)
    ap.save_wav(mixed, str(tmp_path / "mix.wav"))
    np.save(tmp_path / "emb.npy", emb)
    separate_cli.main(["-c", str(tmp_path / "c.json"), "--weights", str(tmp_path / "w.pt"),
                       "--mixed_wav", str(tmp_path / "mix.wav"), "--emb", str(tmp_path / "emb.npy"),
                       "--output", str(tmp_path / "out.wav"), "--griffin_lim", "--device", "cpu"])
    got = ap.load_wav(str(tmp_path / "out.wav"))
    spec, _ = ap.wav2spec(ap.load_wav(str(tmp_path / "mix.wav")))
    with torch.inference_mode():
        mask = model(torch.from_numpy(spec[None]), torch.from_numpy(emb[None]))[0].numpy()
    want = ap.spec2wav(mask * spec, None)
    assert got.shape == want.shape == ((spec.shape[0] - 1) * ap.hop_length,)
    np.testing.assert_allclose(got, want / max(0.01, np.abs(want).max()), atol=2.0 ** -14)
    jap = JaxAudioProcessor(jax_config(json.dumps(d)).audio)
    assert jap.frames_for(len(mixed)) == ap.frames_for(len(mixed)) == spec.shape[0]
