"""Training the streaming model and converting checkpoints to it: the port
against the JAX package.

A causal config (`model.causal`) at a narrow width and a 128-point FFT in
the style of `tests/test_torch_train.py`.  The JAX-layout variables come
from `weights.random_jax_variables`; the JAX tree goes to the JAX step as
it is and to the port through `state_dict_from_jax`.  On the CPU the JAX
LSTM runs its `lax.scan` path and the port the kernels' plain versions.

Tolerances (fp32): a step's loss to 1e-5 (SI-SNR; 2e-4 power-law, see
LOSS_RTOL) and grad_norm to 1e-4 relative,
the gradients (Adam's first moment, 0.1·g) within 5e-3 of the model's
largest, running statistics to 1e-5 and the weights to 2·lr (Adam's first
step moves each by about lr·sign(g)), as `test_train_step_matches_jax`;
`Trainer` losses to 1e-3 relative over three steps; conversions exact.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data.dataset import train_dataloader as jax_train_dataloader
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.train import checkpoint as jax_checkpoint
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu.train.trainer import Trainer as JaxTrainer
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import convert_streaming
from voicesplit_tpu_torch.cli import separate as separate_cli
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.streaming import StreamingSeparator
from voicesplit_tpu_torch.train import checkpoint as ckpt
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from voicesplit_tpu_torch.train.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 40
L = HOP * FRAMES
LR = 1e-3
EMB = 16
GRAD_REL = 5e-3
# the power-law compression's slope 0.3·x^-0.7 near x = 0 magnifies the
# spectrograms' round-off in the loss: 4e-5 to 8e-5 relative on these
# batches, causal or not, so 2e-4; SI-SNR's loss meets 1e-5
LOSS_RTOL = {"si_snr": 1e-5, "power_law_compression": 2e-4}


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text(loss="si_snr", causal=True, root=None, model_name="voicesplit"):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / 16000
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=EMB,
                      causal=causal)
    d["model_name"] = model_name
    d["loss"]["loss_name"] = loss
    d["train_config"].update(compute_dtype="float32", learning_rate=LR, batch_size=2, seed=3,
                             epochs=2, summary_interval=1, check_interval=1,
                             checkpoint_interval=2)
    if root is not None:
        d["dataset"].update(train_dir=str(root / "train"), test_dir=str(root / "test"))
    return json.dumps(d)


def _batch(B, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    target = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (B, 1)) * t)
    mixed = target + 0.2 * np.sin(2 * np.pi * rng.uniform(400, 900, (B, 1)) * t)
    mixed += 0.02 * rng.standard_normal((B, L))
    wav_len = np.full((B,), L, np.int32)
    wav_len[-1] = L - 200
    return {"mixed_wav": mixed.astype(np.float32), "target_wav": target.astype(np.float32),
            "emb": rng.standard_normal((B, EMB)).astype(np.float32), "wav_len": wav_len}


# ---------------------------------------------------------------------------
# One train step
# ---------------------------------------------------------------------------

STEP_CASES = {  # name: (loss, streaming, batch)
    "si_snr-streaming-B2": ("si_snr", True, 2),
    "power_law-streaming-B3": ("power_law_compression", True, 3),
    "si_snr-bilstm_head-B2": ("si_snr", False, 2),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_causal_train_step_matches_jax(case):
    """One step of the causal model from the same weights, fresh Adam state
    and batch: the streaming model (forward-only LSTM; the step drops its
    carry) and causal convs under a BiLSTM head."""
    loss, streaming, B = STEP_CASES[case]
    text = _config_text(loss)
    jc, tc = jax_config(text), load_config_from_str(text)
    model = make_masknet(tc, streaming=streaming, device="cpu")
    params, stats = weights.random_jax_variables(model, 0)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params))
    jstep = jax_steps.make_train_step(jc, jax_make_masknet(jc, streaming=streaming),
                                      jax_audio_processor(jc), tx, donate=False)
    batch = _batch(B, seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    jstate, jm = jstep(jstate, batch)
    m = make_train_step(tc, model, make_audio_processor(tc, device="cpu"), optimizer)(state, batch)

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL[loss])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want = weights.state_dict_from_jax(jax.device_get(jstate.params),
                                       jax.device_get(jstate.batch_stats))
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert not torch.equal(got[k], before[k]), k
        atol = 1e-5 if k.endswith((".mean", ".var")) else 2 * LR + 1e-7
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=atol, rtol=0, err_msg=k)
    mu = weights.params_from_jax(weights._adam_state(jax.device_get(jstate.opt_state)).mu)
    scale = max(np.abs(v.numpy()).max() for v in mu.values())
    for k, p in model.named_parameters():
        np.testing.assert_allclose(optimizer.state[p]["exp_avg"].numpy(), mu[k].numpy(),
                                   atol=GRAD_REL * scale, rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("streaming_trainer")
    fmt = load_config_from_str(_config_text(root=root)).dataset.format
    for split, n, seed in (("train", 6, 0), ("test", 2, 1)):
        build_synthetic_dataset(str(root / split), n, audio_len=L / 16000, emb_dim=EMB,
                                fmt=fmt, seed=seed)
    return root


def test_trainer_fits_the_causal_config_as_jax(workspace, tmp_path):
    """`Trainer` on a causal config builds the streaming model, as the JAX
    one does, and three steps from the same weights over the same files
    give the same losses."""
    text = _config_text(root=workspace)
    jc = jax_config(text)
    jtr = JaxTrainer(jc, log_dir=str(tmp_path / "jax"), enable_tb=False,
                     train_loader=jax_train_dataloader(jc, jax_audio_processor(jc)))
    tr = Trainer(load_config_from_str(text), log_dir=str(tmp_path / "port"), enable_tb=False,
                 device="cpu")
    assert tr.streaming and jtr.streaming and tr.model.streaming and tr.model.causal
    tr.model.load_state_dict(weights.state_dict_from_jax(
        jax.device_get(jtr.state.params), jax.device_get(jtr.state.batch_stats)))
    want, got = jtr.fit(max_steps=3), tr.fit(max_steps=3)
    tr.close()
    assert got["step"] == want["step"] == 3
    records = [[json.loads(r) for r in (tmp_path / d / "metrics.jsonl").read_text().splitlines()]
               for d in ("jax", "port")]
    jl, tl = ([r["train_loss"] for r in rs if "train_loss" in r] for rs in records)
    assert len(tl) == len(jl) == 3 and np.isfinite(tl).all()
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert [p.name for p in sorted((tmp_path / "port").glob("checkpoint_*.pt"))] == [
        "checkpoint_2.pt", "checkpoint_3.pt"]
    sd = ckpt.load_model_variables(tr.config, str(tmp_path / "port" / "checkpoint_3.pt"),
                                   streaming=True)
    assert "lstm.bwd_w_ih" not in sd


@pytest.mark.parametrize("streaming", [None, False])
def test_trainer_model_follows_causal_unless_told(streaming, workspace, tmp_path):
    """``streaming=None`` follows ``model.causal``; ``streaming=False``
    trains the causal convs under a BiLSTM head."""
    tr = Trainer(load_config_from_str(_config_text(root=workspace)), log_dir=str(tmp_path),
                 enable_tb=False, device="cpu", streaming=streaming)
    tr.close()
    assert tr.model.causal and tr.model.streaming == (streaming is None)


# ---------------------------------------------------------------------------
# BiLSTM → streaming conversion
# ---------------------------------------------------------------------------


def _bilstm_pair(causal=False, seed=4):
    """A BiLSTM model's variables as a JAX tree and the port's state_dict."""
    tc = load_config_from_str(_config_text(causal=causal))
    model = make_masknet(tc, device="cpu")
    params, stats = weights.random_jax_variables(model, seed)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    return tc, model, params, stats


def test_bilstm_to_streaming_sd_matches_jax():
    tc, model, params, stats = _bilstm_pair()
    want = weights.state_dict_from_jax(
        jax_checkpoint.bilstm_to_streaming_sd(params, tc.model.lstm_dim), stats)
    got = ckpt.bilstm_to_streaming_sd(model.state_dict(), tc.model.lstm_dim)
    assert set(got) == set(want) == set(make_masknet(tc, streaming=True, device="cpu").state_dict())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_bilstm_to_streaming_sd_refuses_a_streaming_checkpoint():
    tc = load_config_from_str(_config_text())
    sd = make_masknet(tc, streaming=True, device="cpu").state_dict()
    with pytest.raises(ValueError, match="not a BiLSTM checkpoint"):
        ckpt.bilstm_to_streaming_sd(sd, tc.model.lstm_dim)


def _port_bilstm_checkpoint(tmp_path):
    tc, model, params, stats = _bilstm_pair()
    path = ckpt.save_checkpoint(str(tmp_path / "offline"), create_train_state(
        model, make_optimizer(tc, model)), tc)
    return path, tc, params, stats


@pytest.mark.parametrize("causal", [True, False])
def test_convert_port_checkpoint(causal, tmp_path):
    """The converted checkpoint: step 0, fresh Adam state, the config's
    causal flag, and the weights of `bilstm_to_streaming_sd`."""
    path, tc, _, _ = _port_bilstm_checkpoint(tmp_path)
    out = ckpt.convert_bilstm_checkpoint_to_streaming(path, str(tmp_path / "stream"),
                                                      causal=causal, device="cpu")
    assert pathlib.Path(out).name == "checkpoint_0.pt"
    payload = ckpt.load_checkpoint(out)
    assert payload["step"] == 0 and payload["optimizer"]["state"] == {}
    config = ckpt.config_from_checkpoint(out)
    assert config.model.causal is causal
    want = ckpt.bilstm_to_streaming_sd(
        {**ckpt.load_checkpoint(path)["model"], **ckpt.load_checkpoint(path)["batch_stats"]},
        tc.model.lstm_dim)
    got = ckpt.load_model_variables(config, out, streaming=True)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="does not fit the streaming model"):
        ckpt.load_model_variables(config, path, streaming=True)


def test_convert_jax_checkpoint_matches_jax_conversion(tmp_path):
    """A JAX ``.msgpack`` BiLSTM checkpoint converted by both packages: the
    same weights and config."""
    tc, model, params, stats = _bilstm_pair(seed=6)
    jc = jax_config(tc.to_json())
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(step=jnp.asarray(5, jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params))
    src = jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), jstate, jc)
    jout = jax_checkpoint.convert_bilstm_checkpoint_to_streaming(src, str(tmp_path / "jax_stream"))
    out = ckpt.convert_bilstm_checkpoint_to_streaming(src, str(tmp_path / "port_stream"),
                                                      device="cpu")
    jpayload = jax_checkpoint.load_checkpoint(jout)
    want = weights.state_dict_from_jax(jpayload["model"], jpayload["batch_stats"])
    got = ckpt.load_model_variables(ckpt.config_from_checkpoint(out), out, streaming=True)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert json.loads(ckpt.load_checkpoint(out)["config_str"])["model"] == json.loads(
        jpayload["config_str"])["model"]


def test_convert_and_serve_through_the_clis(tmp_path, capsys):
    """`cli.convert_streaming` then `cli.separate --streaming` on the CPU:
    the served file is `StreamingSeparator.separate` on the same weights,
    peak-normalized, to the wav file's 16-bit rounding."""
    path, tc, _, _ = _port_bilstm_checkpoint(tmp_path)
    out = convert_streaming.main(["--checkpoint_path", path, "--output_dir",
                                  str(tmp_path / "stream"), "--device", "cpu"])
    assert "wrote streaming warm-start" in capsys.readouterr().out
    config = ckpt.config_from_checkpoint(out)
    config_path = tmp_path / "stream.json"
    config_path.write_text(config.to_json())
    ap = make_audio_processor(config, device="cpu")
    rng = np.random.default_rng(2)
    mixed = (0.1 * rng.standard_normal(L)).astype(np.float32)
    emb = rng.standard_normal(EMB).astype(np.float32)
    ap.save_wav(mixed, str(tmp_path / "mix.wav"))
    np.save(tmp_path / "emb.npy", emb)
    separate_cli.main(["-c", str(config_path), "--weights", out, "--mixed_wav",
                       str(tmp_path / "mix.wav"), "--emb", str(tmp_path / "emb.npy"),
                       "--output", str(tmp_path / "out.wav"), "--streaming",
                       "--chunk_frames", "8", "--device", "cpu"])
    got = ap.load_wav(str(tmp_path / "out.wav"))
    model = make_masknet(config, streaming=True, device="cpu")
    model.load_state_dict(ckpt.load_model_variables(config, out, streaming=True))
    want = StreamingSeparator(config, model, 8, device="cpu").separate(
        ap.load_wav(str(tmp_path / "mix.wav"))[None], emb[None])[0]
    assert got.shape == want.shape == (L,)
    # `save_wav` peak-normalizes to int16 (the reference's writer)
    np.testing.assert_allclose(got, want / max(0.01, np.abs(want).max()), atol=2.0 ** -14)


@pytest.mark.parametrize("flag", ["--streaming", "--griffin_lim"])
def test_separate_cli_flags_load_no_jax(flag, tmp_path):
    """`cli.separate --streaming` and `--griffin_lim` in a fresh interpreter:
    JAX, flax and the JAX package never load."""
    config = load_config_from_str(_config_text(causal=flag == "--streaming"))
    config.audio.voicefilter.griffin_lim_iters = 2
    (tmp_path / "c.json").write_text(config.to_json())
    model = make_masknet(config, streaming=flag == "--streaming", device="cpu")
    weights.save(weights.init_random_(model, 0), str(tmp_path / "w.pt"))
    ap = make_audio_processor(config, device="cpu")
    ap.save_wav((0.1 * np.random.default_rng(3).standard_normal(L)).astype(np.float32),
                str(tmp_path / "mix.wav"))
    np.save(tmp_path / "emb.npy", np.ones(EMB, np.float32))
    args = ["-c", str(tmp_path / "c.json"), "--weights", str(tmp_path / "w.pt"),
            "--mixed_wav", str(tmp_path / "mix.wav"), "--emb", str(tmp_path / "emb.npy"),
            "--output", str(tmp_path / "out.wav"), "--device", "cpu", flag]
    code = textwrap.dedent(f"""
        import sys
        from voicesplit_tpu_torch.cli.separate import main
        main({args!r})
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout and (tmp_path / "out.wav").exists()
