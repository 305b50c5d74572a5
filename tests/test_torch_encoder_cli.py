"""The encoder CLIs (`cli/train_encoder.py`, `cli/extract_embeddings.py`) with
``--device cpu`` against the JAX package's.

Training: a tree of synthetic harmonic voices; the port's CLI checkpoints,
validates on held-out speakers and resumes its own ``encoder_<step>.pt``
to the same bits as an uninterrupted run; resumed from the JAX CLI's
``encoder_<step>.msgpack`` (read without flax) it takes the same step as
the JAX CLI resumed from it.  Extraction: every ``--encoder`` and
checkpoint kind in both packages on the same wavs (a reference shorter than
a window gets the ``[0]`` sentinel); the port's ``-emb.npy`` files load
through its `data/dataset.py`.  Neither CLI loads JAX in a fresh
interpreter.

Tolerances (fp32): d-vectors 1e-4 absolute (unit vectors; the log-mels
differ by float32 round-off, `tests/test_torch_dsp.py`); Speech2Phone 5e-6
of the embedding's peak (a 2808-long sum in another order); a resumed step's parameters 2·lr, w 1e-5 relative, its Adam moments
exact and each leaf's update 1e-2 of its largest (as
`tests/test_torch_ge2e.py`); the port's own resume exact.
"""

import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import serialization

from voicesplit_tpu.cli import extract_embeddings as jax_extract
from voicesplit_tpu.cli import train_encoder as jax_train_cli
from voicesplit_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from voicesplit_tpu_torch.cli import extract_embeddings, train_encoder
from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.data.dataset import BatchIterator, SeparationDataset, discover_samples
from voicesplit_tpu_torch.dsp.audio_io import save_wav_float
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.train.encoder import (
    GE2E,
    SpeakerEncoder,
    load_encoder_checkpoint,
    save_encoder_checkpoint,
)
from voicesplit_tpu_torch.train.checkpoint import read_msgpack
from voicesplit_tpu_torch.weights import encoder_params_from_jax

from test_torch_ge2e import assert_moments_loaded, assert_updates_close

REPO = pathlib.Path(__file__).resolve().parents[1]
EMB_ATOL, S2P_REL, WB_RTOL = 1e-4, 5e-6, 1e-5
LR = 5e-3
HIDDEN, LAYERS, SR = 24, 2, 16000


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _voice(seconds, s, u, rng):
    t = np.arange(int(SR * seconds)) / SR
    phase = rng.uniform(0, 2 * np.pi)
    wav = sum((0.4 + 0.1 * s) ** h * np.sin(2 * np.pi * (90 + 35 * s) * h * t + phase * h)
              for h in range(1, 9))
    return (0.1 * wav * (1.0 + 0.2 * np.sin(2 * np.pi * (2 + u) * t))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """root/<speaker>/*.wav: 6 speakers x 3 utterances of 1 s."""
    root = tmp_path_factory.mktemp("speakers")
    rng = np.random.default_rng(0)
    for s in range(6):
        (root / f"spk{s}").mkdir()
        for u in range(3):
            save_wav_float(_voice(1.0, s, u, rng), str(root / f"spk{s}" / f"u{u}.wav"), SR)
    return str(root)


def _train_args(root, out, steps, every, holdout=2):
    return ["--data_root", root, "--speakers_per_batch", "4", "--utts_per_speaker", "3",
            "--steps", str(steps), "--lr", str(LR), "--lstm_hidden", str(HIDDEN),
            "--lstm_layers", str(LAYERS), "--checkpoint_interval", str(every),
            "--eval_interval", str(every), "--log_interval", "1",
            "--holdout_speakers", str(holdout), "--output_path", str(out)]


def _losses(text):
    return [float(line.split("loss")[1].split()[0]) for line in text.splitlines()
            if line.startswith("ge2e step")]


def test_train_encoder_cli_learns_checkpoints_and_resumes_exactly(corpus, tmp_path, capsys):
    train_encoder.main(_train_args(corpus, tmp_path / "a", 12, 6) + ["--device", "cpu"])
    out = capsys.readouterr().out
    losses = _losses(out)
    assert len(losses) == 12 and np.mean(losses[-3:]) < np.mean(losses[:3])
    assert out.count("holdout pairwise EER") == 2
    assert sorted(os.listdir(tmp_path / "a")) == ["encoder_12.pt", "encoder_6.pt"]
    ckpt = torch.load(tmp_path / "a" / "encoder_12.pt", weights_only=True)
    assert ckpt["step"] == 12 and ckpt["encoder"] == {
        "num_mels": 40, "lstm_hidden": HIDDEN, "lstm_layers": LAYERS, "emb_dim": 256}

    train_encoder.main(_train_args(corpus, tmp_path / "b", 12, 6)
                       + ["--resume", str(tmp_path / "a" / "encoder_6.pt"), "--device", "cpu"])
    assert _losses(capsys.readouterr().out) == losses[6:]
    resumed = torch.load(tmp_path / "b" / "encoder_12.pt", weights_only=True)
    for k, v in ckpt["params"].items():
        assert torch.equal(resumed["params"][k], v), k


def test_train_encoder_cli_resumes_a_jax_msgpack(corpus, tmp_path, capsys):
    """The JAX CLI's two steps, then one more in each package from its
    ``encoder_2.msgpack``: the same step."""
    jax_train_cli.main(_train_args(corpus, tmp_path / "j", 2, 2))
    two = str(tmp_path / "j" / "encoder_2.msgpack")
    jax_train_cli.main(_train_args(corpus, tmp_path / "j3", 3, 3) + ["--resume", two])
    train_encoder.main(_train_args(corpus, tmp_path / "t3", 3, 3) + ["--resume", two, "--device", "cpu"])
    out = capsys.readouterr().out
    assert " > resumed" in out
    # the resume's Adam moments are optax's, bit for bit
    blob, loaded = read_msgpack(two), load_encoder_checkpoint(two)
    names = [n for n, _ in GE2E(SpeakerEncoder(num_mels=40, lstm_hidden=HIDDEN,
                                               lstm_layers=LAYERS)).named_parameters()]
    assert_moments_loaded(blob["opt_state"], {names[i]: s for i, s in loaded["opt_state"]["state"].items()})
    after = read_msgpack(str(tmp_path / "j3" / "encoder_3.msgpack"))["params"]
    want = encoder_params_from_jax(after)
    got = torch.load(tmp_path / "t3" / "encoder_3.pt", weights_only=True)
    assert got["step"] == 3 and got["opt_state"]["state"][0]["step"].item() == 3
    for k, v in want.items():
        if k == "w":
            np.testing.assert_allclose(got["params"][k].item(), v.item(), rtol=WB_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=2 * LR, err_msg=k)
    assert_updates_close(blob["params"], got["params"], after, lr=LR)


# ---------------------------------------------------------------------------
# extraction
# ---------------------------------------------------------------------------


def _jax_ge2e_msgpack(path):
    """A JAX CLI checkpoint of the tiny topology (flax init), as its
    `save` writes it."""
    enc = JaxSpeakerEncoder(num_mels=40, lstm_hidden=HIDDEN, lstm_layers=LAYERS, emb_dim=256)
    params = {"enc": enc.init(jax.random.PRNGKey(1), jnp.zeros((1, 40, 80)))["params"],
              "w": jnp.asarray(10.0), "b": jnp.asarray(-5.0)}
    opt_state = optax.chain(optax.clip_by_global_norm(3.0), optax.adam(LR)).init(params)
    blob = {"params": serialization.to_state_dict(params),
            "opt_state": serialization.to_state_dict(opt_state), "step": 0,
            "encoder": {"num_mels": 40, "lstm_hidden": HIDDEN, "lstm_layers": LAYERS, "emb_dim": 256}}
    with open(path, "wb") as f:
        f.write(serialization.msgpack_serialize(blob))
    return params


def _checkpoint(kind, tmp):
    """(port checkpoint, JAX checkpoint) for an extraction case."""
    if kind in ("ge2e_pt", "ge2e_msgpack"):
        msgpack = str(tmp / "encoder_0.msgpack")
        params = _jax_ge2e_msgpack(msgpack)
        if kind == "ge2e_msgpack":
            return msgpack, msgpack
        model = GE2E(SpeakerEncoder(num_mels=40, lstm_hidden=HIDDEN, lstm_layers=LAYERS))
        model.load_state_dict(encoder_params_from_jax(jax.device_get(params)))
        save_encoder_checkpoint(str(tmp / "encoder_0.pt"), model, {}, 0)
        return str(tmp / "encoder_0.pt"), msgpack
    torch.manual_seed(2)
    if kind == "ge2e_embedder":  # the reference's full-width embedder.pt
        lstm, proj = torch.nn.LSTM(40, 768, num_layers=3), torch.nn.Linear(768, 256)
        sd = {**{f"lstm.{k}": v for k, v in lstm.state_dict().items()},
              **{f"proj.linear_layer.{k}": v for k, v in proj.state_dict().items()}}
        torch.save(sd, tmp / "embedder.pt")
        return (str(tmp / "embedder.pt"),) * 2
    if kind == "corentinj":  # CorentinJ's pretrained.pt
        lstm, linear = torch.nn.LSTM(40, 256, num_layers=3), torch.nn.Linear(256, 256)
        sd = {**{f"lstm.{k}": v for k, v in lstm.state_dict().items()},
              **{f"linear.{k}": v for k, v in linear.state_dict().items()},
              "similarity_weight": torch.tensor([10.0]), "similarity_bias": torch.tensor([-5.0])}
        torch.save({"step": 1, "model_state": sd}, tmp / "pretrained.pt")
        return (str(tmp / "pretrained.pt"),) * 2
    if kind == "speech2phone":
        rng = np.random.default_rng(13)
        np.savez(tmp / "s2p.npz", **{
            "FullyConnected/W": (rng.standard_normal((13 * 216, 40)) * 0.01).astype(np.float32),
            "FullyConnected/b": np.zeros(40, np.float32)})
        return (str(tmp / "s2p.npz"),) * 2
    return None, None  # spectral, or random weights


def _refs(d, mixed=False):
    """Two references: 2 s and 0.3 s (shorter than a GE2E or CorentinJ
    window); with `mixed`, each with a mixture and a target (triplets)."""
    d.mkdir()
    rng = np.random.default_rng(5)
    for key, seconds in (("a", 2.0), ("b", 0.3)):
        save_wav_float(_voice(seconds, 1, 0, rng), str(d / f"{key}-ref_emb.wav"), SR)
        if mixed:
            for role in ("mixed", "target"):
                save_wav_float(_voice(1.0, 2, 1, rng), str(d / f"{key}-{role}.wav"), SR)
    return d


CASES = {  # case: (--encoder, the checkpoint kind, the emb dim, sentinel for the short ref)
    "ge2e_pt": ("ge2e", "ge2e_pt", 256, True),
    "ge2e_msgpack": ("ge2e", "ge2e_msgpack", 256, True),
    "ge2e_embedder": ("ge2e", "ge2e_embedder", 256, True),
    "corentinj": ("corentinj", "corentinj", 256, True),
    "speech2phone": ("speech2phone", "speech2phone", 80, False),
    "spectral": ("spectral", None, 256, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_embeddings_cli_matches_jax(case, tmp_path, capsys):
    encoder, kind, dim, short_sentinel = CASES[case]
    port_ckpt, jax_ckpt = _checkpoint(kind, tmp_path)
    port_dir, jax_dir = _refs(tmp_path / "port", mixed=True), tmp_path / "jax"
    shutil.copytree(port_dir, jax_dir)
    args = ["--encoder", encoder]
    extract_embeddings.main(["--data_dir", str(port_dir), "--device", "cpu", *args]
                            + (["--encoder_checkpoint", port_ckpt] if port_ckpt else []))
    jax_extract.main(["--data_dir", str(jax_dir), *args]
                     + (["--encoder_checkpoint", jax_ckpt] if jax_ckpt else []))
    capsys.readouterr()
    for key in ("a", "b"):
        got, want = np.load(port_dir / f"{key}-emb.npy"), np.load(jax_dir / f"{key}-emb.npy")
        if key == "b" and short_sentinel:
            assert got.tolist() == want.tolist() == [0.0]
            continue
        assert got.shape == want.shape == (dim,) and got.dtype == np.float32
        tol = S2P_REL * np.abs(want).max() if encoder == "speech2phone" else EMB_ATOL
        np.testing.assert_allclose(got, want, atol=tol)
    if case == "ge2e_pt":
        # the port's -emb.npy files feed its dataset: the sentinel is dropped
        config = Config()
        ap = make_audio_processor(config, device="cpu")
        samples = discover_samples(str(port_dir), config.dataset.format)
        assert [s.key for s in samples] == ["a-mixed.wav"]
        ds = SeparationDataset(samples, ap, 1.0, emb_dim=256)
        batch = next(iter(BatchIterator(ds, 1, shuffle=False)))
        np.testing.assert_array_equal(batch["emb"][0], np.load(port_dir / "a-emb.npy"))


@pytest.mark.parametrize("encoder", ["ge2e", "corentinj"])
def test_extract_embeddings_without_a_checkpoint_gives_unit_vectors(encoder, tmp_path, capsys):
    d = _refs(tmp_path / "refs")
    extract_embeddings.main(["--data_dir", str(d), "--device", "cpu", "--encoder", encoder])
    assert "random init" in capsys.readouterr().out
    emb = np.load(d / "a-emb.npy")
    assert emb.shape == (256,) and np.isfinite(emb).all()
    if encoder == "corentinj":  # renormalized after the mean
        assert abs(float(np.linalg.norm(emb)) - 1.0) < 1e-5


@pytest.mark.parametrize("cli", ["train_encoder", "extract_embeddings"])
def test_encoder_clis_load_no_jax(cli, corpus, tmp_path):
    """Each CLI in a fresh interpreter: JAX, flax and the JAX package never
    load."""
    if cli == "train_encoder":
        args = _train_args(corpus, tmp_path / "out", 1, 1) + ["--device", "cpu"]
        made = tmp_path / "out" / "encoder_1.pt"
    else:
        args = ["--data_dir", str(_refs(tmp_path / "refs")), "--device", "cpu"]
        made = tmp_path / "refs" / "a-emb.npy"
    code = textwrap.dedent(f"""
        import sys
        from voicesplit_tpu_torch.cli.{cli} import main
        main({args!r})
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "optax", "voicesplit_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout and made.exists()
