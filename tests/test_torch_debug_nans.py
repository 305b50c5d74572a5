"""The port's training entry point beyond pre-mixed triplets, at a narrow
width on the CPU: NaN triage (`Trainer(debug_nans=True)`), online mixing
against the JAX `Trainer` with the JAX `OnlineMixIterator`, resume with the
regularizers on, synchronous checkpoints and ``keep=``, and the training CLI
with ``--online``, ``--emb_mode``, ``--embeddings_dir`` and ``--debug_nans``.
"""

import json
import pathlib
import re

import numpy as np
import pytest
import torch

import jax

from test_torch_trainer import AUDIO_LEN, EMB, _config_text, _records
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data.online import OnlineMixIterator as JaxOnlineMixIterator
from voicesplit_tpu.data.online import discover_utterances as jax_discover_utterances
from voicesplit_tpu.train.trainer import Trainer as JaxTrainer
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli import train as train_cli
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data.dataset import IteratorState
from voicesplit_tpu_torch.data.online import OnlineMixIterator, discover_utterances
from voicesplit_tpu_torch.data.synthetic import _speaker_wav, build_synthetic_dataset
from voicesplit_tpu_torch.dsp.audio_io import save_wav_float
from voicesplit_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    list_checkpoints,
    load_checkpoint,
    save_checkpoint,
)
from voicesplit_tpu_torch.train.trainer import NanOpMode, Trainer

SR = 16000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads for this file's tests: several test processes
    share one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """``train/``: 4 speakers × 3 utterances of 1 s, one directory each;
    ``test/``: 3 synthetic triplets."""
    root = tmp_path_factory.mktemp("online")
    rng = np.random.default_rng(0)
    for s in range(4):
        d = root / "train" / f"spk{s}"
        d.mkdir(parents=True)
        for k in range(3):
            save_wav_float(_speaker_wav(rng, s, SR, SR), str(d / f"u{k}.wav"), SR)
    fmt = load_config_from_str(_config_text(root)).dataset.format
    build_synthetic_dataset(str(root / "test"), 3, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=fmt,
                            seed=1)
    return root


def _text(root, dropout=0.0, spec_aug=(0, 0), **train):
    d = json.loads(_config_text(root, **train))
    d["model"]["dropout"] = dropout
    d["train_config"].update(spec_aug_time=spec_aug[0], spec_aug_freq=spec_aug[1])
    return json.dumps(d)


def _online(module, config, **kwargs):
    discover = discover_utterances if module is OnlineMixIterator else jax_discover_utterances
    active = config.audio.active
    return module(discover(config.dataset.train_dir), config.train_config.batch_size,
                  sample_rate=active.sample_rate, audio_len=config.audio.audio_len,
                  hop_length=active.hop_length, emb_dim=config.model.emb_dim,
                  emb_mode="spectral", seed=config.train_config.seed, **kwargs)


def _trainer(text, log_dir, **kwargs):
    config = load_config_from_str(text)
    kwargs.setdefault("train_loader", _online(OnlineMixIterator, config))
    return Trainer(config, log_dir=str(log_dir), enable_tb=False, device="cpu", **kwargs)


# ---------------------------------------------------------------------------
# NaN triage


class _Loader:
    """Clean random batches; batch number `poison_at` carries a NaN in its
    mixed waveform."""

    def __init__(self, B, L, poison_at=None):
        self.B, self.L, self.poison_at, self.count = B, L, poison_at, 0
        self.rng = np.random.default_rng(0)

    def batches_per_epoch(self):
        return 1000

    @property
    def state(self):
        return IteratorState()

    def load_state(self, state):
        pass

    def __iter__(self):
        return self

    def __next__(self):
        target = 0.05 * self.rng.standard_normal((self.B, self.L)).astype(np.float32)
        mixed = target + 0.05 * self.rng.standard_normal((self.B, self.L)).astype(np.float32)
        if self.count == self.poison_at:
            mixed[0, 7] = np.nan
        self.count += 1
        return {"emb": self.rng.standard_normal((self.B, EMB)).astype(np.float32),
                "target_wav": target, "mixed_wav": mixed,
                "wav_len": np.full((self.B,), self.L, np.int32)}


def _triage_trainer(workspace, tmp_path, poison_at, text=None, **kwargs):
    text = text or _config_text(workspace, summary_interval=1000, check_interval=1000,
                                checkpoint_interval=10000)
    L = int(SR * AUDIO_LEN)
    loader = _Loader(2, L, poison_at)
    return Trainer(load_config_from_str(text), log_dir=str(tmp_path), train_loader=loader,
                   enable_tb=False, prefetch_depth=0, device="cpu", **kwargs)


@pytest.mark.parametrize("regularized", [False, True])
def test_poisoned_batch_is_caught_at_its_step_and_names_the_op(workspace, tmp_path,
                                                              regularized):
    """A NaN in batch 2: `fit` returns at step 3 (the guard is checked every
    step whatever the summary and check intervals), and the report names
    the first op whose output was not finite, with the traceback."""
    text = _text(workspace, 0.3 if regularized else 0.0, (4, 6) if regularized else (0, 0),
                 summary_interval=1000, check_interval=1000, checkpoint_interval=10000)
    tr = _triage_trainer(workspace, tmp_path, 2, text=text, debug_nans=True)
    res = tr.fit(max_steps=10, validate_at_epoch_start=False)
    tr.close()
    assert res["exploded"] is True and res["step"] == 3 and np.isnan(res["loss"])
    report = res["nan_report"]
    assert "nan" in report.lower() and "FloatingPointError" in report
    first, second = report.splitlines()[:2]
    # the first op to meet the poisoned samples, in the STFT's framing
    assert re.match(r"nan or inf in the output of \S+ \(shape \(2, 1, 4000\)", first), first
    assert second == "the batch's mixed_wav hold non-finite values"
    assert "Traceback" in report and "frame_signal" in report
    # the re-run started from the pre-step copy
    assert tr.state.step == 2


def test_without_debug_the_guard_keeps_its_cadence(workspace, tmp_path):
    text = _config_text(workspace, summary_interval=1000, check_interval=4,
                        checkpoint_interval=10000)
    tr = _triage_trainer(workspace, tmp_path, 0, text=text)
    res = tr.fit(max_steps=50, validate_at_epoch_start=False)
    tr.close()
    assert res["exploded"] is True and res["step"] == 4 and "nan_report" not in res


def test_nan_op_mode_names_the_producer_and_skips_identities():
    x = torch.tensor([1.0, -1.0])
    with NanOpMode():
        y = torch.as_tensor(x.clone())  # the input itself: no new value
        y.div_(0.0)  # in place: the same tensor
        assert torch.equal(torch.exp(x), torch.tensor([np.e, 1 / np.e], dtype=torch.float32))
        with pytest.raises(FloatingPointError, match=r"output of .*log.*every input was finite"):
            torch.log(x - 1.0)
        with pytest.raises(FloatingPointError, match="an input was already non-finite"):
            y * 2


# ---------------------------------------------------------------------------
# Online mixing, regularizers, checkpoints


def test_online_fit_matches_the_jax_trainer(workspace, tmp_path):
    """Both packages' `Trainer` over their own `OnlineMixIterator` (spectral
    d-vectors, 4 batches an epoch) from the same weights, regularizers off:
    the same mixtures in the same order across an epoch boundary and a
    checkpoint interval, so every step's loss and every validation agree at
    the tolerances of `test_fit_matches_the_jax_trainer` (fp32; 1e-3).

    Five steps: after that the two fp32 Adam trajectories part about tenfold
    a step (over 6 batches an epoch of this corpus the loss was 9e-5 apart
    at step 5, 4e-4 at step 6 and 4e-3 at step 7), as Adam's first steps
    move each weight by about lr·sign(g), whatever the size of g."""
    text = _text(workspace, checkpoint_interval=3)
    jc = jax_config(text)
    jax_loader = _online(JaxOnlineMixIterator, jc, items_per_epoch=8)
    jtr = JaxTrainer(jc, log_dir=str(tmp_path / "jax"), enable_tb=False, train_loader=jax_loader)
    tr = _trainer(text, tmp_path / "port",
                  train_loader=_online(OnlineMixIterator, load_config_from_str(text),
                                       items_per_epoch=8))
    tr.model.load_state_dict(weights.state_dict_from_jax(
        jax.device_get(jtr.state.params), jax.device_get(jtr.state.batch_stats)))
    assert tr.train_loader.batches_per_epoch() == jtr.train_loader.batches_per_epoch() == 4
    want = jtr.fit(max_steps=5)
    got = tr.fit(max_steps=5)
    tr.close()
    assert got["step"] == want["step"] == 5
    jl, tl = _records(tmp_path / "jax", "train_loss"), _records(tmp_path / "port", "train_loss")
    assert [r["step"] for r in tl] == [r["step"] for r in jl] == list(range(1, 6))
    np.testing.assert_allclose([r["train_loss"] for r in tl], [r["train_loss"] for r in jl],
                               rtol=1e-3)
    np.testing.assert_allclose([r["grad_norm"] for r in tl], [r["grad_norm"] for r in jl],
                               rtol=2e-2)
    je, te = _records(tmp_path / "jax", "eval_loss"), _records(tmp_path / "port", "eval_loss")
    # epoch starts at steps 0 and 4, the checkpoint interval at 3
    assert [r["step"] for r in te] == [r["step"] for r in je] == [0, 3, 4]
    np.testing.assert_allclose([r["eval_loss"] for r in te], [r["eval_loss"] for r in je],
                               rtol=1e-3)
    assert load_checkpoint(str(tmp_path / "port" / "checkpoint_5.pt"))["data_state"] == {
        "epoch": 1, "position": 1, "seed": 3}


@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_regularized_online_run_resumes_exactly(workspace, tmp_path, prefetch_depth):
    """Dropout 0.3 and SpecAugment on, online mixing: seven steps in one run
    against four, a checkpoint and a resumed second run; the same weights,
    optimizer and losses bit for bit (the regularizers' draws follow the
    step counter, not the readahead)."""
    text = _text(workspace, 0.3, (4, 6), checkpoint_interval=1000)
    runs = {}
    for name, steps, ckpt in (("whole", 7, None), ("first", 4, None),
                              ("second", 7, tmp_path / "first" / "checkpoint_4.pt")):
        tr = _trainer(text, tmp_path / name, prefetch_depth=prefetch_depth,
                      checkpoint_path=str(ckpt) if ckpt else None)
        runs[name] = tr.fit(max_steps=steps, validate_at_epoch_start=False)
        tr.close()
    assert runs["second"]["step"] == 7
    a = load_checkpoint(str(tmp_path / "whole" / "checkpoint_7.pt"))
    b = load_checkpoint(str(tmp_path / "second" / "checkpoint_7.pt"))
    for group in ("model", "batch_stats"):
        for k, v in a[group].items():
            assert torch.equal(v, b[group][k]), k
    assert a["data_state"] == b["data_state"]
    losses = {n: [r["train_loss"] for r in _records(tmp_path / n, "train_loss")] for n in runs}
    assert losses["first"] + losses["second"] == losses["whole"]
    # the regularizers act: the same run without them takes other steps
    plain = _trainer(_text(workspace, checkpoint_interval=1000), tmp_path / "plain",
                     prefetch_depth=prefetch_depth)
    plain.fit(max_steps=2, validate_at_epoch_start=False)
    plain.close()
    assert [r["train_loss"] for r in _records(tmp_path / "plain", "train_loss")] != \
        losses["whole"][:2]


def test_synchronous_checkpoints_and_keep(workspace, tmp_path):
    """`async_checkpoint=False` writes in the loop; ``keep=`` prunes to the
    newest, for both writers."""
    tr = _trainer(_text(workspace, checkpoint_interval=2), tmp_path / "sync",
                  async_checkpoint=False)
    assert tr._ckpt_writer is None
    tr.fit(max_steps=5, validate_at_epoch_start=False)
    assert [pathlib.Path(p).name for p in list_checkpoints(str(tmp_path / "sync"))] == [
        "checkpoint_2.pt", "checkpoint_4.pt", "checkpoint_5.pt"]
    writer = AsyncCheckpointer()
    for step in (6, 7, 8):
        tr.state.step = step
        save_checkpoint(str(tmp_path / "sync"), tr.state, tr.config, keep=3)
        writer.save(str(tmp_path / "async"), tr.state, tr.config, keep=2)
        writer.wait()
    tr.close()
    assert [pathlib.Path(p).name for p in list_checkpoints(str(tmp_path / "sync"))] == [
        "checkpoint_6.pt", "checkpoint_7.pt", "checkpoint_8.pt"]
    assert [pathlib.Path(p).name for p in list_checkpoints(str(tmp_path / "async"))] == [
        "checkpoint_7.pt", "checkpoint_8.pt"]
    assert load_checkpoint(str(tmp_path / "async" / "checkpoint_8.pt"))["step"] == 8


@pytest.mark.parametrize("flags", [
    ["--online", "--emb_mode", "spectral", "--debug_nans"],
    ["--online", "--embeddings_dir", "EMB"],
    ["--online"],
])
def test_cli_trains_online_with_the_regularizers(workspace, tmp_path, flags):
    """The training CLI on the CPU with dropout and SpecAugment in the
    config: spectral, precomputed (one speaker's ``<speaker>.npy``, the rest
    pseudo) and pseudo d-vectors; ``--debug_nans`` checks every step."""
    emb_dir = tmp_path / "emb"
    emb_dir.mkdir()
    np.save(emb_dir / "spk1.npy", np.random.default_rng(0).standard_normal(EMB).astype(np.float32))
    config_path = tmp_path / "c.json"
    config_path.write_text(_text(workspace, 0.2, (3, 5), checkpoint_interval=2,
                                 logs_path=str(tmp_path / "logs")))
    argv = ["-c", str(config_path), "--max_steps", "3", "--device", "cpu"]
    argv += [str(emb_dir) if f == "EMB" else f for f in flags]
    result = train_cli.main(argv)
    assert result["step"] == 3 and not result.get("exploded")
    assert np.isfinite(result["loss"]) and result["wall_seconds"]["train_step"] > 0
    assert [pathlib.Path(p).name for p in list_checkpoints(str(tmp_path / "logs"))] == [
        "checkpoint_2.pt", "checkpoint_3.pt"]


def test_cli_online_without_a_card_raises_unless_the_cpu_is_named(workspace, tmp_path):
    config_path = tmp_path / "c.json"
    config_path.write_text(_text(workspace, logs_path=str(tmp_path / "logs")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["-c", str(config_path), "--online", "--max_steps", "1"])
