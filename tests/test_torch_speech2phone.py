"""Speech2Phone: the port's MFCC frontend, encoder, importer and extraction
protocol against the JAX package's.

One numpy input from a seed goes to both; the JAX variables come from the
JAX importer and the port's weights from its own, on the same arrays.
Tolerances (fp32): the MFCC and the silence trim are numpy in both
(identical code, identical bits); the dense layer 1e-5 of the output's
peak (a 2808-long sum in another order); an embedding 2e-4 absolute
(values O(40), as the JAX package's own protocol test), its resampling
and MFCC shared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.models import speech2phone as jax_s2p
from voicesplit_tpu_torch.models.speech2phone import (
    EMB_DIM,
    N_FRAMES,
    N_MFCC,
    SAMPLE_RATE,
    Speech2PhoneEncoder,
    crelu,
    librosa_mfcc,
    load_speech2phone_weights,
    speech2phone_embedding,
    trim_silence_dbfs,
)

DENSE_REL, EMB_ATOL = 1e-5, 2e-4


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _speech_like(n, seed=0, sr=SAMPLE_RATE):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = sum(a * np.sin(2 * np.pi * f * t + p) for a, f, p in zip(
        rng.uniform(0.1, 0.5, 6), rng.uniform(120, 3000, 6), rng.uniform(0, 6.28, 6)))
    return (x + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _weights(seed=13):
    rng = np.random.default_rng(seed)
    return {"FullyConnected/W": (rng.standard_normal((N_MFCC * N_FRAMES, 40)) * 0.01).astype(np.float32),
            "FullyConnected/b": (rng.standard_normal(40) * 0.1).astype(np.float32)}


def _encoders(arrays):
    enc = Speech2PhoneEncoder()
    enc.load_state_dict(load_speech2phone_weights(arrays))
    return enc, jax_s2p.Speech2PhoneEncoder(), jax_s2p.load_speech2phone_weights(arrays)


@pytest.mark.parametrize("seconds", [0.01, 1.0, 5.0])
def test_mfcc_matches_jax(seconds):
    """librosa's default MFCC, 5 s giving tflearn's [13, 216]; a clip too
    short to reflect-pad is zero-extended in both."""
    wav = _speech_like(int(seconds * SAMPLE_RATE), seed=int(10 * seconds))
    got, want = librosa_mfcc(wav), jax_s2p.librosa_mfcc(wav)
    np.testing.assert_array_equal(got, want)
    if seconds == 5.0:
        assert got.shape == (N_MFCC, N_FRAMES)


def test_crelu_and_the_encoder_match_jax():
    x = torch.tensor([[-1.0, 2.0]])
    assert crelu(x).tolist() == [[0.0, 2.0, 1.0, 0.0]]
    arrays = _weights()
    enc, enc_j, variables = _encoders(arrays)
    mfcc = np.random.default_rng(1).standard_normal((3, N_MFCC, N_FRAMES)).astype(np.float32)
    want = np.asarray(enc_j.apply(variables, jnp.asarray(mfcc)))
    with torch.no_grad():
        got = enc(torch.from_numpy(mfcc)).numpy()
    assert got.shape == (3, EMB_DIM)
    np.testing.assert_allclose(got, want, atol=DENSE_REL * np.abs(want).max())
    # tflearn's row-major flatten: coefficient-major input index
    np.testing.assert_array_equal(enc.fc.weight.detach().numpy(), arrays["FullyConnected/W"].T)


@pytest.mark.parametrize("form", ["npz", "pickled_dict", "pt", "mapping"])
def test_importer_forms(form, tmp_path):
    arrays = _weights(seed=2)
    if form == "npz":
        source = str(tmp_path / "s2p.npz")
        np.savez(source, **arrays)
    elif form == "pickled_dict":
        source = str(tmp_path / "s2p.npz")  # np.savez of a dict: one 0-d object array
        np.savez(source, {"W:0": arrays["FullyConnected/W"], "b:0": arrays["FullyConnected/b"]})
    elif form == "pt":
        source = str(tmp_path / "s2p.pt")
        torch.save({"model_state": {"fc.weight": torch.from_numpy(arrays["FullyConnected/W"]),
                                    "fc.bias": torch.from_numpy(arrays["FullyConnected/b"])}}, source)
    else:
        source = arrays
    sd = load_speech2phone_weights(source)
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), arrays["FullyConnected/W"].T)
    np.testing.assert_array_equal(sd["fc.bias"].numpy(), arrays["FullyConnected/b"])


def test_importer_rejects_wrong_shapes_and_keys():
    with pytest.raises(ValueError, match="expects W"):
        load_speech2phone_weights({"W": np.zeros((100, 40)), "b": np.zeros(40)})
    with pytest.raises(ValueError, match="not a Speech2Phone export"):
        load_speech2phone_weights({"kernel_x": np.zeros((2808, 40))})


def test_trim_silence_matches_jax():
    sr = SAMPLE_RATE
    sig = 0.5 * np.sin(2 * np.pi * 440 * np.arange(sr) / sr).astype(np.float32)
    wav = np.concatenate([np.zeros(sr // 2, np.float32), sig, np.zeros(sr // 4, np.float32)])
    for x in (wav, np.zeros(sr, np.float32), wav[:100]):
        np.testing.assert_array_equal(trim_silence_dbfs(x, sr), jax_s2p.trim_silence_dbfs(x, sr))
    assert abs(trim_silence_dbfs(wav, sr).size - sig.size) <= 2 * sr // 100


@pytest.mark.parametrize("case", ["short_16k", "long_22k", "silent"])
def test_embedding_protocol_matches_jax(case):
    """A 1.5 s clip at 16 kHz (resampled, looped past 5 s), a 7 s clip at
    22.05 kHz (three windows) and a silent one (the ``[0]`` sentinel)."""
    enc, enc_j, variables = _encoders(_weights(seed=5))
    if case == "short_16k":
        wav, sr = _speech_like(int(1.5 * 16000), seed=9, sr=16000), 16000
    elif case == "long_22k":
        wav, sr = _speech_like(7 * SAMPLE_RATE, seed=11), SAMPLE_RATE
    else:
        wav, sr = np.zeros(16000, np.float32), 16000
    got = speech2phone_embedding(enc, wav, sr)
    want = jax_s2p.speech2phone_embedding(enc_j, variables, wav, sr)
    assert got.shape == want.shape == ((1,) if case == "silent" else (EMB_DIM,))
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)
