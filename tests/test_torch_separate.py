"""Serving path end to end: the port's `separate_batch` and CLI against the
JAX path (`wav2spec_batch` → `MaskNet.apply` → `mask * spec` →
`spec2wav_batch`), at a small config on the CPU."""

import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax.numpy as jnp

from voicesplit_tpu.config import load_config_from_str as jax_load_config_from_str
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_make_audio_processor
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli.separate import main, separate_batch
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 40
L = HOP * FRAMES  # on the hop grid, as a 3 s clip is at hop 160


def _config_text(compute_dtype="float32"):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
    d["train_config"]["compute_dtype"] = compute_dtype
    return json.dumps(d)


def _mixture(batch, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    wav = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (batch, 1)) * t)
    wav += 0.05 * rng.standard_normal((batch, L))
    emb = rng.standard_normal((batch, 16))
    return wav.astype(np.float32), emb.astype(np.float32)


def _port_model(text, seed=0):
    model = make_masknet(load_config_from_str(text), device="cpu")
    return weights.init_random_(model, seed)


@pytest.mark.parametrize("batch", [1, 8])
def test_separate_batch_matches_jax_path(batch):
    text = _config_text("float32")
    model = _port_model(text, seed=batch)
    ap = make_audio_processor(load_config_from_str(text), device="cpu")
    mixed, emb = _mixture(batch, seed=batch)
    got = separate_batch(model, ap, mixed, emb)

    jcfg = jax_load_config_from_str(text)
    jap = jax_make_audio_processor(jcfg)
    variables = dict(zip(("params", "batch_stats"), weights.random_jax_variables(model, batch)))
    spec, phase = jap.wav2spec_batch(jnp.asarray(mixed))
    mask = jax_make_masknet(jcfg).apply(variables, spec, jnp.asarray(emb), train=False)
    want = jap.spec2wav_batch(mask * spec, phase, length=L)

    assert got.shape == (batch, L) and got.dtype == torch.float32
    # fp32 throughout: mask agrees to ~1e-7, the waveform (peak ~0.3) to
    # the iSTFT's float32 round-off
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _cli_files(tmp_path, seed=0):
    text = _config_text("bfloat16")  # the shipped config's compute dtype
    cfg = tmp_path / "config.json"
    cfg.write_text(text)
    w = tmp_path / "weights.pt"
    weights.save(_port_model(text, seed), str(w))
    mixed, emb = _mixture(1, seed)
    wav = tmp_path / "mix.wav"
    scipy.io.wavfile.write(str(wav), 16000, mixed[0])
    e = tmp_path / "emb.npy"
    np.save(e, emb[0])
    args = ["-c", str(cfg), "--weights", str(w), "--mixed_wav", str(wav),
            "--emb", str(e), "--output", str(tmp_path / "out.wav"), "--device", "cpu"]
    return text, mixed, emb, args


def test_cli_writes_the_separated_wav(tmp_path):
    text, mixed, emb, args = _cli_files(tmp_path)
    main(args)
    sr, out = scipy.io.wavfile.read(str(tmp_path / "out.wav"))
    assert sr == 16000 and out.dtype == np.int16 and out.shape == (L,)
    want = separate_batch(_port_model(text), make_audio_processor(
        load_config_from_str(text), device="cpu"), mixed, emb)[0].numpy()
    want = want * (32768.0 / max(0.01, np.abs(want).max()))  # save_wav's peak scaling
    assert np.abs(out - want).max() <= 1.0  # int16 truncation


@pytest.mark.parametrize(
    "flag", [["--sequence_parallel"]]
)
def test_cli_refuses_what_is_not_ported(tmp_path, flag):
    _, _, _, args = _cli_files(tmp_path)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        main(args + flag)


def test_cli_runs_without_jax(tmp_path):
    """A fresh interpreter imports the port and runs the CLI; JAX never loads."""
    _, _, _, args = _cli_files(tmp_path)
    code = textwrap.dedent(
        f"""
        import sys
        import voicesplit_tpu_torch
        from voicesplit_tpu_torch.cli.separate import main
        main({args!r})
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout


@pytest.mark.parametrize("name", ["voicesplit", "voicefilter", "voicesplit_wide"])
def test_config_copy_loads_like_the_jax_one(name):
    """The port's own config module reads every shipped config to the same
    values as the JAX package's."""
    from voicesplit_tpu.config import load_config as jax_load_config
    from voicesplit_tpu_torch.config import load_config

    path = str(REPO / "configs" / f"{name}.json")
    assert load_config(path).to_dict() == jax_load_config(path).to_dict()
    assert load_config(path).to_json() == jax_load_config(path).to_json()
