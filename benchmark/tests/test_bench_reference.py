"""The reference against the program's CPU path at a tiny size, the
faults that ``correct`` has to catch, and (on the card) the control."""

from __future__ import annotations

import time
import types

import numpy as np
import pytest
import torch

import checks
import harness
import program
from tiny import TRAIN_TEST_LIMITS, tiny_cell

SEED = 2 ** 31 + 101
TRAIN = ["voicesplit.train.b8", "voicefilter.train.b8"]
SERVE = ["voicefilter.serve.b1", "voicesplit.serve.b8"]


def _drive(cell, prog=program, seconds=0.2):
    drive = harness.drive_train if cell.train else harness.drive_serve
    return drive(cell, SEED, seconds, False, "cpu", time.perf_counter(), prog)


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_agrees_in_fp32(name):
    """Computed in fp32 on both sides, the program's first step and the
    reference's agree to rounding: the same model, loss, DSP and Adam.  (The
    power-law loss's gradient, 0.3·|x|^-0.7, is steep where the masked
    spectrogram nears 0, which turns fp32 rounding into gaps of about 1e-3.)"""
    cell = tiny_cell(name, compute_dtype="float32")
    run = _drive(cell)
    ref = harness.reference_readings(cell, SEED, run, "cpu")
    p = run.readings
    assert abs(p["losses"][0] - ref["losses"][0]) <= 1e-5 * abs(ref["losses"][0])
    gaps = checks.grad_gaps(p["grad"], ref["grad"])
    assert max(gaps.values()) < 1e-2, max(gaps.items(), key=lambda kv: kv[1])


@pytest.mark.parametrize("name", SERVE)
def test_serving_agrees_in_fp32(name):
    cell = tiny_cell(name, batch=2, compute_dtype="float32")
    run = _drive(cell)
    ref = harness.reference_readings(cell, SEED, run, "cpu")
    assert checks.row_gaps(run.readings["waves"], ref["waves"]).max() < 1e-5


def _readings(cell, run, side=None, device="cpu"):
    ref = harness.reference_readings(cell, SEED, run, device)
    unit = None if cell.train else harness.reference_readings(cell, SEED, run, device, "bf16")
    return harness.readings_against(cell, side or run.readings, ref, unit)


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_bf16_readings_inside_the_limits(name):
    """At the configurations' bf16 the tiny run's numbers are finite and
    inside the cell's limits (a training cell has none yet)."""
    cell = tiny_cell(name, batch=2)
    readings = _readings(cell, _drive(cell))
    assert all(np.isfinite(v) for v in readings.values()), readings
    assert all(readings[k] <= v for k, v in cell.limits.items()), (readings, cell.limits)


# --- faults planted under the timed path -------------------------------------


class StateUnchanged(program.Trainer):
    """A step that returns its state unchanged."""

    def step(self, batch):
        saved = {k: v.detach().clone() for k, v in self.tensors().items()}
        metrics = super().step(batch)
        with torch.no_grad():
            for k, v in self.tensors().items():
                v.copy_(saved[k])
        return metrics


class HalfBatchTrainer(program.Trainer):
    """Half of the batch left out, the mean taken over the rest."""

    def step(self, batch):
        half = next(iter(batch.values())).shape[0] // 2
        return super().step({k: v[:half] for k, v in batch.items()})


class HalfBatchSeparator(program.Separator):
    """Half of the batch left out: the first half's answers stand in for
    the rest."""

    def __call__(self, mixed, emb):
        half = mixed.shape[0] // 2
        out = super().__call__(mixed[:half], emb[:half])
        return torch.cat([out, out[: mixed.shape[0] - half]])


class AlteredAnswer(program.Separator):
    """An answer altered where it is produced: the first row negated."""

    def __call__(self, mixed, emb):
        out = super().__call__(mixed, emb).clone()
        out[0] = -out[0]
        return out


FAULTS = [(n, "Trainer", StateUnchanged) for n in TRAIN]
FAULTS += [(n, "Trainer", HalfBatchTrainer) for n in TRAIN]
FAULTS += [(n, "Separator", AlteredAnswer) for n in SERVE]
FAULTS += [("voicesplit.serve.b8", "Separator", HalfBatchSeparator)]


@pytest.mark.parametrize("name,role,fault", FAULTS,
                         ids=[f"{n}-{f.__name__}" for n, _, f in FAULTS])
def test_fault_is_not_correct(name, role, fault):
    """The whole run but the look for a card, with the timed path broken
    underneath: ``correct`` comes out false.  Training runs in fp32 here,
    against limits that a sound run keeps (test_sound_run_result_line)."""
    if name in TRAIN:
        cell = tiny_cell(name, batch=2, compute_dtype="float32", limits=TRAIN_TEST_LIMITS)
    else:
        cell = tiny_cell(name, batch=2)
    broken = types.SimpleNamespace(Trainer=program.Trainer, Separator=program.Separator)
    setattr(broken, role, fault)
    result = harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                              program=broken, log=lambda s: None)
    assert result["correct"] is False
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_sound_run_result_line(name):
    """The result's keys, in order, and the end-to-end metrics of the cell."""
    cell = tiny_cell(name, batch=2, compute_dtype="float32",
                     limits=TRAIN_TEST_LIMITS if name in TRAIN else None)
    result = harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(),
                              log=lambda s: None)
    assert result["correct"] is True, result["checks"]
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in result["metrics"].values())


# --- the control, on the card at each cell's own size -----------------------------


def test_no_limits_no_run():
    """A cell with no limits is not run: nothing would decide `correct`."""
    cell = tiny_cell(TRAIN[0], batch=2)
    with pytest.raises(ValueError):
        harness.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter(), log=lambda s: None)


@pytest.mark.gpu
@pytest.mark.parametrize("name", SERVE)
def test_control_is_not_correct(name):
    """The reference in fp8 put in the program's place fails a limit of the
    cell on three seeds, at the cell's own size."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = harness.Cell(name)
    harness.set_environment(cell)
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        run = _drive_card(cell, seed)
        ref = harness.reference_readings(cell, seed, run, "cuda")
        unit = None if cell.train else harness.reference_readings(cell, seed, run, "cuda", "bf16")
        ctl = harness.reference_readings(cell, seed, run, "cuda", "fp8")
        judged = checks.judge(harness.readings_against(cell, ctl, ref, unit), cell.limits)
        assert not all(j["ok"] for j in judged), judged
        del run
        torch.cuda.empty_cache()


def _drive_card(cell, seed):
    drive = harness.drive_train if cell.train else harness.drive_serve
    return drive(cell, seed, 1.0, False, "cuda", time.perf_counter(), program)
