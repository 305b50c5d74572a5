"""The port's evaluation entry points against the JAX package's: `validate`
with its SDR backends and sample logging, `eval/sweep.py::sweep_checkpoints`
over port checkpoints (best by SDR and by loss, the curve, a diverged run),
and the CLIs `cli/test.py` (a port checkpoint and a JAX ``.msgpack``) and
`cli/sweep.py`, run on the CPU.

The model is the wide variant's shape cut to test size (one extra dilated
block at time dilation 32, 126 frames), fp32, over five synthetic triplets
at batch 2 (a padded last batch).  Tolerances: loss and SI-SNR to 1e-3,
SDR and SI-SNRi to 0.02 dB between the packages on the same backend (fp32
models from the same weights; the batched projection is float32 Cholesky
with one refinement step on both sides), as `tests/test_torch_eval.py`
holds `validate`.
"""

import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data import dataset as jds
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.eval.validation import validate as jax_validate
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.train import checkpoint as jckpt
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import sweep as sweep_cli
from voicesplit_tpu_torch.cli import test as test_cli
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data import dataset as tds
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.eval.sweep import sweep_checkpoints
from voicesplit_tpu_torch.eval.validation import validate
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train import checkpoint as ckpt
from voicesplit_tpu_torch.train import create_train_state, make_eval_step, make_optimizer
from voicesplit_tpu_torch.utils.logging import MetricsLogger

REPO = pathlib.Path(__file__).resolve().parents[1]
AUDIO_LEN, EMB = 0.25, 16
SEEDS = (3, 4, 5)  # the weights of the three checkpoints, at steps 10, 20, 30


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text(data_dir):
    d = json.loads((REPO / "configs" / "voicesplit_wide.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=32, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = AUDIO_LEN
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=EMB)
    d["train_config"].update(compute_dtype="float32")
    d["test_config"] = {"batch_size": 2}
    d["dataset"].update(train_dir=str(data_dir), test_dir=str(data_dir))
    return json.dumps(d)


def _port_checkpoint(tc, log_dir, seed, step, poison=False):
    """A port checkpoint of the config's model with weights from `seed`
    (`poison`: a NaN in fc2's bias, so that every metric is NaN)."""
    model = make_masknet(tc, device="cpu")
    params, stats = weights.random_jax_variables(model, seed)
    if poison:
        params["fc2"]["bias"] = np.full_like(params["fc2"]["bias"], np.nan)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    state = create_train_state(model, make_optimizer(tc, model))
    state.step = step
    return ckpt.save_checkpoint(str(log_dir), state, tc), params, stats


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    data = root / "data"
    text = _config_text(data)
    jc, tc = jax_config(text), load_config_from_str(text)
    assert tc.model.num_extra_dilated_blocks == 1
    build_synthetic_dataset(str(data), 5, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=tc.dataset.format, seed=6)
    (root / "config.json").write_text(text)
    ckpts = [_port_checkpoint(tc, root / "run", seed, 10 * (i + 1)) for i, seed in enumerate(SEEDS)]
    jap = jax_audio_processor(jc)
    jstep = jax_steps.make_eval_step(jc, jax_make_masknet(jc), jap)
    return {"root": root, "jc": jc, "tc": tc, "ckpts": ckpts,
            "jax": lambda params, stats, **kw: jax_validate(
                jstep, params, stats, jds.test_dataloader(jc, jap), log_sample=False, **kw)}


def _port_eval(tc):
    model = make_masknet(tc, device="cpu")
    ap = make_audio_processor(tc, device="cpu")
    return model, make_eval_step(tc, model, ap), lambda: tds.test_dataloader(tc, ap)


def _assert_metrics_close(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    np.testing.assert_allclose(got["si_snr"], want["si_snr"], atol=1e-3)
    for k in ("sdr", "si_snri"):
        if k in want:
            np.testing.assert_allclose(got[k], want[k], atol=0.02, err_msg=k)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_validate_backends_match_jax(backend, setup):
    """Each SDR backend against the JAX package's same backend ("device" is
    the batched projection, run here on the CPU on both sides)."""
    path, params, stats = setup["ckpts"][0]
    model, step, loader = _port_eval(setup["tc"])
    model.load_state_dict(ckpt.load_model_variables(setup["tc"], path))
    got = validate(step, loader(), sdr_backend=backend)
    _assert_metrics_close(got, setup["jax"](params, stats, sdr_backend=backend))
    with pytest.raises(ValueError, match="sdr_backend"):
        validate(step, loader(), sdr_backend="tpu")


def test_validate_logs_a_sample_only_when_asked(setup, tmp_path):
    model, step, loader = _port_eval(setup["tc"])
    model.load_state_dict(ckpt.load_model_variables(setup["tc"], setup["ckpts"][0][0]))
    for log_sample in (False, True):
        logger = MetricsLogger(str(tmp_path / str(log_sample)), 16000, enable_tb=False)
        validate(step, loader(), logger, step=3, log_sample=log_sample)
        logger.close()
        records = (tmp_path / str(log_sample) / "metrics.jsonl").read_text().splitlines()
        keys = [sorted(set(json.loads(r)) - {"step", "time"}) for r in records]
        sample = [["SDR", "test_loss"]] if log_sample else []
        assert keys == sample + [["eval_loss", "eval_sdr", "eval_si_snr", "eval_si_snri"]]


@pytest.mark.parametrize("fast", [False, True])
def test_sweep_checkpoints_picks_the_best_and_writes_the_curve(fast, setup, tmp_path):
    """Three port checkpoints: each one's metrics against the JAX package's
    `validate` on the same weights, the best by SDR (SI-SNR when `fast`)
    and by loss copied byte for byte, the curve [step, metric]; a second
    sweep of the same directory sees three checkpoints again, not the
    copies."""
    tc = setup["tc"]
    run = setup["root"] / "run"
    model, step, loader = _port_eval(tc)
    out = sweep_checkpoints(str(run), tc, model, step, loader(), fast=fast, out_dir=str(tmp_path))
    results = out["results"]
    assert [r["step"] for r in results] == [10, 20, 30]
    metric = "si_snr" if fast else "sdr"
    for r, (path, params, stats) in zip(results, setup["ckpts"]):
        assert r["path"] == path
        want = setup["jax"](params, stats, compute_sdr=not fast, sdr_backend="host")
        _assert_metrics_close({k: v for k, v in r.items() if k not in ("path", "step")}, want)
    best = max(results, key=lambda r: r[metric])
    best_loss = min(results, key=lambda r: r["loss"])
    assert out["best_path"] == best["path"] and out["best_metric"] == best[metric]
    assert out["best_loss_path"] == best_loss["path"] and out["best_loss"] == best_loss["loss"]
    prefix = "fast_" if fast else ""
    for name, src in (("best_checkpoint.pt", best["path"]), ("best_loss_checkpoint.pt", best_loss["path"])):
        assert (tmp_path / f"{prefix}{name}").read_bytes() == pathlib.Path(src).read_bytes()
    curve = np.load(tmp_path / f"{prefix}sdr_curve.npy")
    np.testing.assert_array_equal(curve, [[r["step"], r[metric]] for r in results])
    # the copies sit beside the checkpoints and are not taken for checkpoints
    sweep_checkpoints(str(run), tc, model, step, loader(), fast=True, max_items=1)
    assert sorted(os.listdir(run)) == [
        "checkpoint_10.pt", "checkpoint_20.pt", "checkpoint_30.pt",
        "fast_best_checkpoint.pt", "fast_best_loss_checkpoint.pt", "fast_sdr_curve.npy"]
    assert len(ckpt.list_checkpoints(str(run))) == 3


def test_sweep_of_a_diverged_run_copies_nothing(setup, tmp_path, capsys):
    """Every checkpoint NaN: reported, no best checkpoint, no curve, no copy
    (the JAX package's behavior, `voicesplit_tpu/eval/sweep.py:69-79`).  The
    batched SDR projection carries the NaN through (the host projection,
    as the JAX package's, refuses a non-finite estimate)."""
    tc = setup["tc"]
    for i, seed in enumerate(SEEDS[:2]):
        _port_checkpoint(tc, tmp_path, seed, i + 1, poison=True)
    model, step, loader = _port_eval(tc)
    out = sweep_checkpoints(str(tmp_path), tc, model, step, loader(), sdr_backend="device")
    assert out["best_path"] is None and np.isnan(out["best_metric"])
    assert all(np.isnan(r["sdr"]) for r in out["results"])
    assert "all checkpoints scored NaN" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_1.pt", "checkpoint_2.pt"]
    with pytest.raises(FileNotFoundError):
        sweep_checkpoints(str(tmp_path / "empty"), tc, model, step, loader())


def _one_json_line(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def test_cli_test_evaluates_a_port_checkpoint(setup, capsys):
    """The config from the checkpoint, the CPU by name: one JSON line, the
    JAX package's `validate` of the same weights (host SDR)."""
    path, params, stats = setup["ckpts"][1]
    got = test_cli.main(["--checkpoint_path", path, "--device", "cpu", "--sdr_backend", "host"])
    assert _one_json_line(capsys) == got
    _assert_metrics_close(got, setup["jax"](params, stats, sdr_backend="host"))


def test_cli_test_evaluates_a_jax_checkpoint(setup, tmp_path, capsys):
    """A ``checkpoint_<step>.msgpack`` written by the JAX package's
    `save_checkpoint` (the wide model: conv8 the dilation-32 block, conv9
    the projection), read through `load_jax_checkpoint`."""
    pytest.importorskip("msgpack")
    jc, tc = setup["jc"], setup["tc"]
    params, stats = weights.random_jax_variables(make_masknet(tc, device="cpu"), 9)
    assert "conv9" in params and "conv10" not in params
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(step=jnp.asarray(4, jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params))
    path = jckpt.save_checkpoint(str(tmp_path), jstate, jc)
    assert path.endswith("checkpoint_4.msgpack")
    got = test_cli.main(["--checkpoint_path", path, "--device", "cpu", "--max_items", "3"])
    assert _one_json_line(capsys) == got
    _assert_metrics_close(got, setup["jax"](params, stats, sdr_backend="host", max_items=3))


def test_cli_sweep_evaluates_every_checkpoint(setup, tmp_path, capsys):
    """`cli/sweep.py` with the config given (`-c`): one JSON line with the
    best paths; the copies and the curve beside the checkpoints."""
    run = tmp_path / "run"
    for i, seed in enumerate(SEEDS):
        _port_checkpoint(setup["tc"], run, seed, i + 1)
    got = sweep_cli.main(["--checkpoints_path", str(run), "-c", str(setup["root"] / "config.json"),
                          "--device", "cpu"])
    printed = _one_json_line(capsys)
    assert printed == {k: v for k, v in got.items() if k != "results"}
    assert printed["n_checkpoints"] == 3
    assert printed["best_path"] == str(run / f"checkpoint_{1 + int(np.argmax([r['sdr'] for r in got['results']]))}.pt")
    for name in ("best_checkpoint.pt", "best_loss_checkpoint.pt", "sdr_curve.npy"):
        assert (run / name).exists()
