"""The benchmark's run: set-up, the measured window, the traced span, the
check against the reference, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the configuration (``configs/<config>.json``), the
traffic mix (``traffic/<traffic>.json``), the limits of the numbers that
decide ``correct`` (``limits/<cell>.json``) and each per-layer metric's
reader (``metrics/<metric>.py``, or ``metrics/<name before the first
dot>.py``).  A traffic mix is one of two kinds, read by one general
run loop each:

- ``train``: one train step object drives ``check_steps`` steps (whose
  loss, first gradient and change the reference follows) and
  ``warmup_steps`` more in set-up, then steps back to back over batches
  made in set-up and kept in pinned host memory, cycled; the window ends
  in a synchronize.
- ``serve``: one client in a closed loop; each call separates a batch held
  in pinned host memory and copies the waveforms back to the host.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BETA1 = 0.9  # Adam's, as the configurations' optimizer takes it
FORBIDDEN = ("jax", "jaxlib", "flax", "voicesplit_tpu")


# --- the cell, from BENCHMARK.json -----------------------------------------------

def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, spec: Optional[dict] = None):
        spec = spec if spec is not None else _json(ROOT / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        w = cells[name]
        self.chips = int(w["chips"])
        conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
        self.config = _json(ROOT / conf["file"])["config"]
        self.traffic = _json(HERE / "traffic" / f"{w['traffic']}.json")
        limits = HERE / "limits" / f"{name}.json"
        self.limits = _json(limits) if limits.exists() else {}

        def applies(m: dict) -> bool:
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in spec["end_to_end"] if applies(m)]
        self.per_layer = [m for m in spec["per_layer"] if applies(m)]

    @classmethod
    def unlisted(cls, name: str, spec: Optional[dict] = None) -> "Cell":
        """A cell that ``BENCHMARK.json`` does not list, named
        ``<config>.<traffic>`` from its files, on one chip, with no metrics
        and the limits of ``limits/<name>.json`` if there are any: for
        `calibrate.py` and the tests."""
        spec = dict(spec if spec is not None else _json(ROOT / "BENCHMARK.json"))
        config, traffic = name.split(".", 1)
        spec["workloads"] = [{"name": name, "config": config, "traffic": traffic, "chips": 1}]
        spec["end_to_end"], spec["per_layer"] = [], []
        return cls(name, spec)

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    @property
    def audio(self) -> dict:
        return self.config["audio"]["voicefilter"]

    @property
    def samples(self) -> int:
        return int(round(self.traffic["clip_s"] * self.audio["sample_rate"]))

    @property
    def frames(self) -> int:
        return 1 + self.samples // self.audio["hop_length"]

    @property
    def train(self) -> bool:
        return self.traffic["kind"] == "train"


def set_environment(cell: Cell) -> None:
    """The cell's switches of the program, and every build and kernel cache
    in fixed directories of the checkout (the program builds its kernels
    into ``build/`` there itself)."""
    os.environ.update({k: str(v) for k, v in cell.traffic["env"].items()})
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


# --- device helpers -----------------------------------------------------------

def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host(arrays: Dict[str, np.ndarray], device) -> Dict:
    """Host tensors, pinned when the card is the device."""
    import torch

    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    if torch.device(device).type == "cuda":
        out = {k: v.pin_memory() for k, v in out.items()}
    return out


def _inputs(cell: Cell, seed: int) -> Dict[str, np.ndarray]:
    from synthetic import mixtures

    t = cell.traffic
    return mixtures(seed, cell.batch * int(t["batches"]), cell.samples,
                    cell.audio["sample_rate"], cell.config["model"]["emb_dim"],
                    int(t["speakers"]))


def _norms(tensors: Dict) -> Dict[str, float]:
    import torch

    keys = sorted(tensors)
    vals = torch.stack([torch.linalg.vector_norm(tensors[k].float()) for k in keys]).tolist()
    return dict(zip(keys, vals))


# --- the two run loops ----------------------------------------------------------

class Run:
    """What a run loop hands back: set-up seconds, the window's work and
    time, the traced span (with ``trace``), the program's readings for the
    check, and what the reference needs to follow."""

    setup_s: float
    window_s: float
    attempted: int
    failed: int
    latencies: List[float]
    memory_peak: int
    trace = None
    traced_iters = 0
    iter_s: Optional[float] = None
    readings: dict


def _windowed(step: Callable[[int], None], seconds: float, trace: bool, skip: int, span: int,
              device) -> tuple:
    """Call ``step(i)`` for i = 0, 1, ... until `seconds` have passed; with
    `trace`, steps ``skip`` … ``skip + span − 1`` run under the profiler,
    between two synchronizations.  Returns (iterations, seconds, trace,
    seconds an iteration outside the traced span, or None where none ran
    outside it)."""
    from devtrace import record

    i, tr, traced_s = 0, None, 0.0
    start = time.perf_counter()
    while time.perf_counter() - start < seconds or (trace and tr is None):
        if trace and tr is None and i == skip:
            _sync(device)
            t1 = time.perf_counter()

            def traced(i0=i):
                for j in range(i0, i0 + span):
                    step(j)
                _sync(device)

            tr = record(traced)
            traced_s = time.perf_counter() - t1
            i += span
            continue
        step(i)
        i += 1
    _sync(device)
    window_s = time.perf_counter() - start
    plain = i - (span if trace else 0)
    iter_s = (window_s - traced_s) / plain if plain > 0 else None
    return i, window_s, tr, iter_s


def drive_train(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
                program) -> Run:
    import torch

    import weights

    t = cell.traffic
    B, nb = cell.batch, int(t["batches"])
    data = _inputs(cell, seed)
    batches = [_host({k: v[i * B:(i + 1) * B] for k, v in data.items()}, device)
               for i in range(nb)]
    trainer = program.Trainer(cell.config, weights.make(cell.config, seed, device), device)
    before = {k: v.detach().clone() for k, v in trainer.tensors().items()}
    losses, grad = [], None
    for k in range(int(t["check_steps"])):
        losses.append(trainer.step(batches[k % nb])["loss"])
        if k == 0:  # the first gradient as the optimizer got it, kept on the host
            grad = {n: (m / (1.0 - BETA1)).cpu() for n, m in trainer.first_moments().items()}
    change = _norms({k: v.detach() - before[k] for k, v in trainer.tensors().items()})
    del before
    readings = {"losses": [float(x) for x in losses], "grad": grad, "change": change}
    done = int(t["check_steps"])
    for k in range(int(t["warmup_steps"])):
        trainer.step(batches[(done + k) % nb])
    done += int(t["warmup_steps"])
    _sync(device)
    run = Run()
    run.setup_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window_losses = []

    def step(i: int) -> None:
        window_losses.append(trainer.step(batches[(done + i) % nb])["loss"])

    run.attempted, run.window_s, run.trace, run.iter_s = _windowed(
        step, seconds, trace, int(t["trace_skip"]), int(t["trace_steps"]), device)
    run.traced_iters = int(t["trace_steps"])
    run.failed = sum(int(not math.isfinite(x)) for x in torch.stack(window_losses).tolist()) \
        if window_losses else 0
    run.latencies = []
    run.memory_peak = _memory_peak(device)
    run.readings = readings
    run.check_batches = [batches[k % nb] for k in range(int(t["check_steps"]))]
    del trainer, window_losses
    return run


def drive_serve(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
                program) -> Run:
    import torch

    import weights

    t = cell.traffic
    B, nb = cell.batch, int(t["batches"])
    data = _inputs(cell, seed)
    pool = [_host({k: data[k][i * B:(i + 1) * B] for k in ("mixed_wav", "emb")}, device)
            for i in range(nb)]
    sep = program.Separator(cell.config, weights.make(cell.config, seed, device), device)
    for i in range(int(t["warmup_calls"])):
        sep(pool[i % nb]["mixed_wav"], pool[i % nb]["emb"]).cpu()
    _sync(device)
    run = Run()
    run.setup_s = time.perf_counter() - t0
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # the window keeps one call's answer out of each block of `keep_every`
    # calls, at an offset drawn from the seed, for the check
    every = int(t["keep_every"])
    offsets = np.random.default_rng([seed % 2 ** 63, 1]).integers(0, every, size=1 << 15)
    kept, lat, bad = {}, [], []

    def call(i: int) -> None:
        x = pool[i % nb]
        t1 = time.perf_counter()
        y = sep(x["mixed_wav"], x["emb"]).cpu()
        lat.append(time.perf_counter() - t1)
        if not np.isfinite(y.numpy()).all():
            bad.append(i)
        if i % every == offsets[(i // every) % len(offsets)]:
            kept[i] = y

    run.attempted, run.window_s, run.trace, run.iter_s = _windowed(
        call, seconds, trace, int(t["trace_skip"]), int(t["trace_calls"]), device)
    run.traced_iters = int(t["trace_calls"])
    run.failed = len(bad)
    run.latencies = lat
    run.memory_peak = _memory_peak(device)
    # the sample that the reference checks, drawn from the seed among them
    n_calls = min(len(kept), math.ceil(int(t["check_rows"]) / B))
    if n_calls == 0:
        raise RuntimeError("the window kept no answer for the check: lengthen --seconds")
    picks = sorted(np.random.default_rng([seed % 2 ** 63, 2]).choice(
        sorted(kept), size=n_calls, replace=False).tolist())
    run.readings = {"calls": picks, "waves": torch.cat([kept[i] for i in picks]).numpy()}
    run.check_inputs = {k: torch.cat([pool[i % nb][k] for i in picks])
                        for k in ("mixed_wav", "emb")}
    del sep, kept
    return run


def _memory_peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


# --- the reference's side of the check ----------------------------------------------

def reference_readings(cell: Cell, seed: int, run: Run, device, precision: str = "fp32",
                       rows: Optional[slice] = None) -> dict:
    """The reference's readings for what `run` checks, from the seed's
    weights and the same inputs; `precision` "fp8" is the control, and
    `rows` keeps only those rows of each training batch (a planted fault)."""
    import reference
    import weights

    reference.fp32_matmuls()
    state = weights.make(cell.config, seed, device)
    if cell.train:
        batches = [{k: v[rows] if rows is not None else v for k, v in b.items()}
                   for b in run.check_batches]
        batches = [{k: v.to(device) for k, v in b.items()} for b in batches]
        out = reference.train(state, batches, cell.config, precision)
        change = {k: out["final"][k] - state[k] for k in state}
        return {"losses": out["losses"], "grad": out["first_grad"], "change": _norms(change)}
    x = {k: v.to(device) for k, v in run.check_inputs.items()}
    waves = reference.separate(state, x["mixed_wav"], x["emb"], cell.config, precision)
    return {"waves": waves.cpu().numpy()}


def readings_against(cell: Cell, program: dict, ref: dict, unit: dict) -> Dict[str, float]:
    """The numbers that decide `correct` (and, beside them, those read but
    not compared): `program`'s readings against the fp32 reference's `ref`;
    serving takes `unit`, the reference's in bf16, as its unit."""
    import checks

    if cell.train:
        return checks.train_readings(program, ref)
    return {"wave_gap": checks.wave_gap(program["waves"], ref["waves"], unit["waves"])}


# --- metrics -------------------------------------------------------------------

def end_to_end(cell: Cell, run: Run) -> Dict[str, dict]:
    clip_s = float(cell.traffic["clip_s"])
    values = {"setup_s": run.setup_s}
    if cell.train:
        values["train_audio_s_per_s"] = run.attempted * cell.batch * clip_s / run.window_s
    else:
        values["serve_audio_s_per_s"] = run.attempted * cell.batch * clip_s / run.window_s
        values["serve_p95_ms"] = float(np.percentile(run.latencies, 95)) * 1e3
    out = {}
    for m in cell.end_to_end:
        if m["name"] not in values:
            raise KeyError(f"metric {m['name']!r} is not measured by a {cell.traffic['kind']} run")
        out[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    return out


def _reader(name: str):
    for stem in (name, name.split(".")[0]):
        path = HERE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(f"bench_metric_{stem}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} under benchmark/metrics/")


class Context:
    """What a per-layer reader reads: the trace, the iterations it spans,
    the seconds an iteration took outside the traced span (where the
    profiler's host overhead does not slow the host), and the work of one
    iteration counted from the cell's shapes."""

    def __init__(self, cell: Cell, run: Run):
        import costs

        model = cell.config["model"]
        B, T, Fq = cell.batch, cell.frames, cell.audio["num_freq"]
        fused = cell.traffic["env"].get("VOICESPLIT_FUSED_CHAIN") == "1"
        self.trace = run.trace
        self.iterations = run.traced_iters
        self.iter_s = run.iter_s
        self.flops = costs.step_flops(model, cell.audio, cell.config["loss"]["loss_name"], B, T,
                                      cell.train)["total"]
        self.conv_bound_ms = costs.conv_bound_ms(model, B, T, Fq, cell.train, fused)
        self.lstm_bound_ms = costs.lstm_bound_ms(model, B, T, cell.train)
        self.peak_flops = costs.BF16_FLOPS


def per_layer(cell: Cell, run: Run) -> Dict[str, dict]:
    ctx = Context(cell, run)
    out = {}
    for m in cell.per_layer:
        value = _reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


# --- one run ---------------------------------------------------------------------

def device_block(device, run: Run, chips: int) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        block = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                 "memory_peak_bytes": run.memory_peak}
    else:
        block = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if run.trace is not None:
        block["busy_s"] = run.trace.busy_s()
        block["window_s"] = run.trace.span_s
    return block


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
             program=None, log=None) -> dict:
    """Set-up, window, (traced span,) the check; returns the result line's
    object.  `program` is the module that builds the system under test
    (`program.py`, imported here after the cell's switches are set)."""
    import torch

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    if program is None:
        import program as program_mod

        program = program_mod
    if not cell.limits:
        raise ValueError(f"no limits for cell {cell.name!r} under benchmark/limits/")
    drive = drive_train if cell.train else drive_serve
    run = drive(cell, seed, seconds, trace, device, t0, program)
    block = device_block(device, run, cell.chips)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    result = {"correct": False, "attempted": run.attempted, "failed": run.failed}
    if trace:
        result["metrics"] = per_layer(cell, run)
        by_kind = run.trace.seconds_by_kind()
        other = run.trace.seconds_by_name("other")
        log(json.dumps({"card": card_line(), "device_s_by_kind": by_kind,
                        "unmatched_device_s": other[:20]}))
    else:
        result["metrics"] = end_to_end(cell, run)
    result["device"] = block
    if trace:
        from devtrace import breakdown

        result["breakdown"] = breakdown(run.trace)
    run.trace = None
    ref = reference_readings(cell, seed, run, device)
    unit = None if cell.train else reference_readings(cell, seed, run, device, "bf16")
    readings = readings_against(cell, run.readings, ref, unit)
    import checks

    judged = checks.judge(readings, cell.limits)
    result["correct"] = all(j["ok"] for j in judged)
    result["checks"] = {j["name"]: {"value": j["value"], "limit": j["limit"]} for j in judged}
    for j in judged:
        log(f"check {j['name']} = {j['value']!r} (limit {j['limit']!r}) "
            f"{'ok' if j['ok'] else 'FAILED'}")
    return result
