"""The port's `utils/profiling.py` against the JAX package's: the mask-net
step's FLOP and byte count, `StepCost` and `time_fn`; the card's peaks,
which `chip_smoke.py` takes from it; the exporter.  Its spans:
`test_torch_spans.py`."""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from voicesplit_tpu.utils import profiling as jprof
from voicesplit_tpu_torch.utils import profiling as prof

REPO = pathlib.Path(__file__).resolve().parents[1]

SHAPES = {
    "serving-width": dict(batch=2, frames=301),
    "wide": dict(batch=8, frames=301, lstm_dim=800, bytes_per_el=4),
    "narrow": dict(batch=1, frames=40, num_freq=33, conv_channels=8, conv_out=2, lstm_dim=16,
                   fc1=24, emb=16, n_fft=64),
}


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_train_step_cost_is_the_jax_formula(shape):
    got = prof.masknet_train_step_cost(**SHAPES[shape])
    want = jprof.masknet_train_step_cost(**SHAPES[shape])
    assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)


def test_step_cost_bound_and_mfu_as_jax_at_the_same_peaks():
    got = prof.StepCost(flops=3.1e12, hbm_bytes=7.0e9)
    want = jprof.StepCost(flops=3.1e12, hbm_bytes=7.0e9)
    for peaks in ((1e14, 1e12), (prof.BF16_FLOPS, prof.HBM_BYTES_PER_S)):
        assert got.speed_of_light_s(*peaks) == want.speed_of_light_s(*peaks)
    assert got.mfu(0.02, 5e14) == want.mfu(0.02, 5e14)
    # the defaults are the H100's: bf16 tensor cores and HBM3
    assert got.speed_of_light_s() == max(3.1e12 / 989e12, 7.0e9 / 3.35e12)
    assert got.mfu(0.01) == 3.1e12 / (0.01 * 989e12)


def test_no_tpu_figure_is_carried_over():
    names = [n for n in vars(prof) if n.isupper()]
    assert not [n for n in names if "V5E" in n or "TPU" in n], names
    assert prof.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert prof.HBM_BYTES_PER_S == 3.35e12


def test_chip_smoke_takes_its_peaks_from_profiling():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.HBM_BYTES_PER_S is prof.HBM_BYTES_PER_S
    assert smoke.PEAK_FLOPS is prof.PEAK_FLOPS


def test_time_fn_warms_up_then_times_each_call_synchronized():
    calls, synced = [], []
    r = prof.time_fn(lambda x: calls.append(x) or x, 7, n_warmup=3, n_iters=5,
                     sync=synced.append)
    assert calls == [7] * 8 and synced == [7] * 8
    assert set(r) == {"median_s", "best_s", "mean_s"}
    assert 0 <= r["best_s"] <= r["median_s"]
    jr = jprof.time_fn(lambda: 1, n_warmup=1, n_iters=2, sync=lambda res: res)
    assert set(jr) == set(r)


def test_time_fn_default_sync_runs_on_the_cpu():
    r = prof.time_fn(torch.ones, 4, n_iters=3)
    assert np.isfinite(r["median_s"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path / "tb")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "tb" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)

