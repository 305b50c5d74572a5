"""Every cell of ``BENCHMARK.json`` resolves to its files, and the file
keeps to the benchmark's contract as far as a file can be checked here."""

from __future__ import annotations

import json
import math
import re
from pathlib import Path

import pytest

import harness
import weights

ROOT = Path(harness.ROOT)
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.Cell(cell, SPEC)
    assert c.chips == 1
    assert c.traffic["kind"] in ("train", "serve")
    assert set(c.limits) == ({"loss_gap", "grad_gap", "change_gap"} if c.train
                             else {"wave_gap"})
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        harness._reader(m["name"])  # raises without a reader


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in SPEC[group]:
            assert NAME.match(entry["name"]), entry["name"]
            assert entry["name"] not in seen
            seen.add(entry["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_config_file(config):
    entry = {c["name"]: c for c in SPEC["configs"]}[config]
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["reduced"] == entry["reduced"] == []
    assert data["config"]["model_name"] == config
    repo_config = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    assert data["config"] == repo_config  # a frozen copy, nothing reduced


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_state_layout_is_the_programs(config):
    """The state the benchmark makes has the program's names and shapes, so
    ``load_state_dict`` takes it whole."""
    from voicesplit_tpu_torch.config import load_config_from_str
    from voicesplit_tpu_torch.models.masknet import make_masknet

    data = json.loads((ROOT / "configs" / f"{config}.json").read_text())
    model = make_masknet(load_config_from_str(json.dumps(data)), device="cpu")
    ours = {name: shape for name, shape, _, _ in weights.layout(data)}
    theirs = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == theirs
    assert sum(math.prod(s) for s in ours.values()) > 18_000_000


def test_weights_from_the_seed():
    data = json.loads((ROOT / "configs" / "voicefilter.json").read_text())
    a = weights.make(data, 2 ** 31 + 11, "cpu")
    b = weights.make(data, 2 ** 31 + 11, "cpu")
    c = weights.make(data, 2 ** 31 + 12, "cpu")
    assert all(bool((a[k] == b[k]).all()) for k in a)
    assert not bool((a["fc1.weight"] == c["fc1.weight"]).all())
    assert all(bool((a[k] > 0).all()) for k in a if k.endswith(".bn.var"))


def test_inputs_from_the_seed():
    import synthetic

    a = synthetic.mixtures(2 ** 31 + 5, 4, 800, 16000, 16, 16)
    b = synthetic.mixtures(2 ** 31 + 5, 4, 800, 16000, 16, 16)
    assert all((a[k] == b[k]).all() for k in a)
    assert len({row.tobytes() for row in a["mixed_wav"]}) == 4
    assert float(abs(a["mixed_wav"]).max()) < 1.0
