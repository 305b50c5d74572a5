"""`cli.separate --reference_wav --encoder_checkpoint`: the d-vector of a
reference clip (`train/encoder.py::embed_reference`) against the JAX CLI's
``encoder.apply(vars, ap.get_mel(wav)[None])``, from a random GE2E
``embedder.pt`` (the reference's layout) at full width, and the CLI's output
against `separate_batch` with that d-vector, on the CPU.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.config import Config as JaxConfig
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from voicesplit_tpu.models.speaker_encoder import load_torch_state_dict as jax_load_embedder
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import separate as separate_cli
from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import Config, load_config
from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train.encoder import (
    embed_reference,
    load_ge2e_encoder,
    utterance_windows,
    window_count,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
DVEC_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def embedder(tmp_path_factory):
    """A random GE2E ``embedder.pt`` in the reference's layout: a 3-layer
    ``nn.LSTM(40 → 768)`` under ``lstm.`` and ``proj.linear_layer``."""
    torch.manual_seed(0)
    lstm, proj = torch.nn.LSTM(40, 768, num_layers=3), torch.nn.Linear(768, 256)
    sd = {f"lstm.{k}": v for k, v in lstm.state_dict().items()}
    sd.update({f"proj.linear_layer.{k}": v for k, v in proj.state_dict().items()})
    path = tmp_path_factory.mktemp("embedder") / "embedder.pt"
    torch.save(sd, path)
    return path, sd


def _clip(frames_wanted: int, ap, seed: int) -> np.ndarray:
    """A voiced-looking clip whose log-mel has `frames_wanted` frames."""
    n = frames_wanted * ap.hop_length
    while ap.frames_for(n) > frames_wanted:
        n -= 1
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = rng.uniform(100, 220)
    wav = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    wav *= 0.5 + 0.5 * np.sin(2 * np.pi * 3 * t)
    return (0.1 * wav + 0.01 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("windows", [1, 6, 35])
def test_dvector_equals_jax(windows, embedder):
    """1, 6 and 35 windows (the last across two batches of 32)."""
    path, sd = embedder
    ap = make_audio_processor(Config(), device="cpu")
    jap = jax_audio_processor(JaxConfig())
    wav = _clip(80 + 40 * (windows - 1) + 20, ap, seed=windows)
    mel = ap.get_mel(wav)
    assert window_count(mel.shape[1], 80, 40) == windows == len(utterance_windows(mel, 80, 40))
    enc = load_ge2e_encoder(str(path), 40, torch.device("cpu")).eval()
    got = embed_reference(enc, ap, wav)
    jvars = jax_load_embedder({k: v.numpy() for k, v in sd.items()})  # as the JAX CLI
    want = np.asarray(JaxSpeakerEncoder(num_mels=40).apply(
        jvars, jnp.asarray(jap.get_mel(wav))[None]))[0]
    assert got.shape == (256,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=DVEC_ATOL, rtol=0)


def test_short_reference_raises(embedder):
    ap = make_audio_processor(Config(), device="cpu")
    enc = load_ge2e_encoder(str(embedder[0]), 40, torch.device("cpu"))
    with pytest.raises(ValueError, match="at least 80"):
        embed_reference(enc, ap, _clip(60, ap, seed=0))


def _serving_config(tmp_path) -> pathlib.Path:
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24)
    d["train_config"]["compute_dtype"] = "float32"
    path = tmp_path / "c.json"
    path.write_text(json.dumps(d))
    return path


def test_cli_output_equals_separate_batch_with_the_dvector(embedder, tmp_path):
    """The CLI's wav against `separate_batch` on the mixture with
    `embed_reference`'s d-vector, written the same way."""
    config_path = _serving_config(tmp_path)
    config = load_config(str(config_path))
    ap = make_audio_processor(config, device="cpu")
    model = weights.init_random_(make_masknet(config, device="cpu"), 4)
    weights.save(model, str(tmp_path / "w.pt"))
    ref, mixed = _clip(220, ap, seed=7), _clip(301, ap, seed=8)
    save_wav_float(ref, str(tmp_path / "ref.wav"), SR)
    save_wav_float(mixed, str(tmp_path / "mix.wav"), SR)
    separate_cli.main(["-c", str(config_path), "--weights", str(tmp_path / "w.pt"),
                       "--mixed_wav", str(tmp_path / "mix.wav"),
                       "--reference_wav", str(tmp_path / "ref.wav"),
                       "--encoder_checkpoint", str(embedder[0]),
                       "--output", str(tmp_path / "out.wav"), "--device", "cpu"])
    enc = load_ge2e_encoder(str(embedder[0]), 40, torch.device("cpu")).eval()
    emb = embed_reference(enc, ap, ap.load_wav(str(tmp_path / "ref.wav")))
    want = separate_batch(model.eval(), ap, ap.load_wav(str(tmp_path / "mix.wav"))[None],
                          emb[None])[0].numpy()
    ap.save_wav(want, str(tmp_path / "want.wav"))
    assert (tmp_path / "out.wav").read_bytes() == (tmp_path / "want.wav").read_bytes()
    assert len(load_wav(str(tmp_path / "out.wav"))) == len(mixed)


@pytest.mark.parametrize("flags,message", [
    (["--reference_wav", "ref.wav"], "--reference_wav requires --encoder_checkpoint"),
    ([], "provide --emb or --reference_wav"),
])
def test_cli_exits_without_what_it_needs(flags, message, tmp_path):
    """As the JAX CLI: a reference clip without an encoder checkpoint, or no
    d-vector at all, exits before anything is loaded."""
    with pytest.raises(SystemExit, match=message):
        separate_cli.main(["-c", "unused.json", "--weights", "unused.pt", "--mixed_wav", "m.wav",
                           "--output", str(tmp_path / "o.wav"), "--device", "cpu", *flags])
