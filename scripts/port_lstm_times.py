#!/usr/bin/env python3
"""Times the PyTorch port's LSTM kernel wrappers on the card.

    python3 scripts/port_lstm_times.py [--root DIR] [--tag NAME] [--iters 20] [--library] [--only SUBSTR,...]
    python3 scripts/port_lstm_times.py --compare PARENT_DIR [--iters 20] [--library] [--only SUBSTR,...]

Imports `voicesplit_tpu_torch` from DIR (default: this checkout) and builds
its kernels there, so that an older tree unpacked with ``git archive`` into
a git-ignored directory is timed by the same script in the same call (run
parent, change, change, parent).  It uses only the wrappers' public calls,
which are the same in every tree since the port's second slice, at the
shapes of their paths (T=301 frames, H=400 units unless said):

- ``lstm_cuda.lstm_fwd`` at B=1 (serving) and B=2 (training), one direction;
- ``lstm_cuda.bilstm_fwd`` at B=8, both directions;
- ``lstm_cuda.lstm_bwd`` at B=2 and ``lstm_cuda.bilstm_bwd`` at B=8, on the
  forward kernel's outputs and random cotangents;
- both two-direction wrappers at B=24 rows a direction, more than one
  cluster of the backward walk holds (a tree that refuses the shape gets
  its error instead of a time);
- at H=800 (`configs/voicesplit_wide.json`) ``lstm_fwd`` at B=1 and B=2,
  ``bilstm_fwd`` at B=8 (the evaluation sweep's padded batch), ``lstm_bwd``
  at B=2 and ``bilstm_bwd`` at B=8, and both two-direction wrappers at B=24
  (more clusters of the split walk than the card holds at once: the grid
  route in bf16 too), the backward on the plain forward's outputs;
- the GE2E speaker encoder's shapes (fp32 only, H=768, T=80 frames):
  ``lstm_fwd`` at 96 rows (a training step), 32 (an extraction batch) and
  16 (the training CLI's held-out EER batch), ``lstm_bwd`` at 96 rows on
  the plain forward's outputs (``encoder_*``);
- for every entry the route it took (``<entry>/route``), where the tree
  counts routes;
- where the tree has it, ``lstm_cuda.lstm_dwhh``, the dW_hh kernel that the
  two backward wrappers launch after their reverse walk, alone on the same
  inputs (``walk_ms`` is then the backward's time less it);

with bf16 and fp32 operands (the encoder's entries fp32 only).
``--library`` adds cuDNN's ``torch.nn.LSTM`` (bf16; the encoder's fp32
with TF32 off, over an input H wide, as its upper layers take) over the
model's LSTM input, forward and ``.backward()`` alone, which the port never
calls (both also cover the input projection), and, beside each ``lstm_dwhh``
time, one ``torch.matmul`` of the same product (``h_prev^T . dgates`` per
direction, batched over directions; ``library_ms["<entry>/dwhh"]``) at the
GE2E shape in fp32 and at B=2 and B=8 (H=400) in bf16.  ``--only`` keeps
the entries whose name holds one of the comma-separated substrings.  Each time is
the mean of ``--iters`` calls after two warm ones, between CUDA events,
beside its bound (``bound_ms``: `chip_smoke.py`'s `lstm_bound`,
`lstm_bwd_bound`, `lstm_dwhh_bound` at the entry's shape).  Prints one JSON
line with the card's name and power limit.

``--compare PARENT_DIR`` runs the script four times in one call, each in a
fresh process: the parent tree, this one, this one, the parent (tags
``parent``, ``change``, ``change``, ``parent``; ``--library`` on the first
run of this tree), prints the four lines, then one line that sets each
entry's mean time in the change beside the parent's, with their ratio.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T_FRAMES, HIDDEN, WIDE, IN_FEATURES = 301, 400, 800, 8 * 601 + 256
# the GE2E speaker encoder's LSTM: frames a window, hidden units (fp32)
ENCODER_FRAMES, ENCODER_HIDDEN = 80, 768
# name: (directions, rows a direction, hidden units, frames)
FORWARD = {"lstm_fwd_B1": (1, 1, HIDDEN, T_FRAMES), "lstm_fwd_B2": (1, 2, HIDDEN, T_FRAMES),
           "bilstm_fwd_B8": (2, 8, HIDDEN, T_FRAMES), "bilstm_fwd_B24": (2, 24, HIDDEN, T_FRAMES),
           "lstm_fwd_B1_H800": (1, 1, WIDE, T_FRAMES), "lstm_fwd_B2_H800": (1, 2, WIDE, T_FRAMES),
           "bilstm_fwd_B8_H800": (2, 8, WIDE, T_FRAMES), "bilstm_fwd_B24_H800": (2, 24, WIDE, T_FRAMES),
           "encoder_lstm_fwd_R96": (1, 96, ENCODER_HIDDEN, ENCODER_FRAMES),
           "encoder_lstm_fwd_R32": (1, 32, ENCODER_HIDDEN, ENCODER_FRAMES),
           "encoder_lstm_fwd_R16": (1, 16, ENCODER_HIDDEN, ENCODER_FRAMES)}
BACKWARD = {"lstm_bwd_B2": (1, 2, HIDDEN, T_FRAMES), "bilstm_bwd_B8": (2, 8, HIDDEN, T_FRAMES),
            "bilstm_bwd_B24": (2, 24, HIDDEN, T_FRAMES),
            "lstm_bwd_B2_H800": (1, 2, WIDE, T_FRAMES), "bilstm_bwd_B8_H800": (2, 8, WIDE, T_FRAMES),
            "bilstm_bwd_B24_H800": (2, 24, WIDE, T_FRAMES),
            "encoder_lstm_bwd_R96": (1, 96, ENCODER_HIDDEN, ENCODER_FRAMES)}
LIBRARY = ("lstm_fwd_B1", "lstm_fwd_B2", "bilstm_fwd_B8", "lstm_bwd_B2", "bilstm_bwd_B8",
           "lstm_fwd_B1_H800", "lstm_fwd_B2_H800", "bilstm_fwd_B8_H800", "lstm_bwd_B2_H800",
           "bilstm_bwd_B8_H800", "encoder_lstm_fwd_R96", "encoder_lstm_fwd_R32",
           "encoder_lstm_fwd_R16", "encoder_lstm_bwd_R96")
# entries whose dW_hh product is also timed as one torch.matmul (--library),
# in the operand type the path runs
DWHH_LIBRARY = {"lstm_bwd_B2": "bfloat16", "bilstm_bwd_B8": "bfloat16", "encoder_lstm_bwd_R96": "float32"}


def _entries(only) -> dict:
    """FORWARD and BACKWARD, or the entries whose name holds one of `only`."""
    return {k: v for k, v in {**FORWARD, **BACKWARD}.items() if not only or any(o in k for o in only)}


def _dtypes(key: str) -> tuple:
    return ("float32",) if key.startswith("encoder") else ("bfloat16", "float32")


def _chip_smoke():
    """This checkout's `chip_smoke.py` as a module (it imports the standard
    library, numpy and the port's peaks at its top)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bound(key: str, dtype: str, smoke=None) -> dict:
    """The least time of entry `key` in `dtype` (``<entry>/dwhh``: the dW_hh
    kernel alone): `chip_smoke.py`'s `lstm_bound`, `lstm_bwd_bound` or
    `lstm_dwhh_bound` at the entry's shape."""
    smoke = smoke or _chip_smoke()
    name, _, part = key.partition("/")
    d, b, H, T = {**FORWARD, **BACKWARD}[name]
    if part == "dwhh":
        return smoke.lstm_dwhh_bound(d, b, dtype, H, T)
    return (smoke.lstm_bound if name in FORWARD else smoke.lstm_bwd_bound)(d, b, dtype, H, T)


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--library", action="store_true")
    parser.add_argument("--compare", default=None)
    parser.add_argument("--only", default="")
    args = parser.parse_args(argv)
    only = [o for o in args.only.split(",") if o]
    if args.compare:
        return compare(args)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("port_lstm_times: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import _build, lstm_cuda

    if not Path(lstm_cuda.__file__).resolve().is_relative_to(root):
        print(f"port_lstm_times: imported {lstm_cuda.__file__}, not from {root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    dwhh = getattr(lstm_cuda, "lstm_dwhh", None)
    routes_fwd = getattr(lstm_cuda, "ROUTES", None)
    routes_bwd = getattr(lstm_cuda, "ROUTES_BWD", None)
    times: dict = {}
    for dt in ("bfloat16", "float32"):
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cpu").manual_seed(0)
        entry = times[dt] = {}
        for key, (d, b, H, T) in _entries(only).items():
            if dt not in _dtypes(key):
                continue
            R = d * b
            s = H ** -0.5
            xp = torch.randn(T, R, 4 * H, generator=g).to(dev, dtype)
            ws = [torch.empty(H, 4 * H).uniform_(-s, s, generator=g).to(dev, dtype) for _ in range(d)]
            h0, c0, dhf, dcf = (torch.randn(R, H, generator=g).to(dev) for _ in range(4))
            dhs = torch.randn(T, R, H, generator=g).to(dev)
            with torch.inference_mode():
                if d == 1:
                    fwd = lambda: lstm_cuda.lstm_fwd(xp, ws[0], h0, c0)  # noqa: E731
                else:
                    fwd = lambda: lstm_cuda.bilstm_fwd(xp, ws[0], ws[1])  # noqa: E731
                if key in FORWARD:
                    before = dict(routes_fwd) if routes_fwd is not None else None
                    try:
                        fwd()
                    except RuntimeError as err:  # a tree that refuses the shape
                        entry[key] = f"refused: {err}"
                        continue
                    if routes_fwd is not None:
                        entry[f"{key}/route"] = [k for k in routes_fwd if routes_fwd[k] != before[k]]
                    entry[key] = time_ms(torch, fwd, args.iters)
                    continue
                if H == HIDDEN:
                    hs, cs, gates = fwd()
                elif d == 1:  # the plain forward on the card
                    hs, cs, gates = lstm_cuda.lstm_fwd_ref(xp, ws[0], h0, c0)
                else:
                    hs, cs, gates = lstm_cuda.bilstm_fwd_ref(xp, ws[0], ws[1])
                if d == 1:
                    bwd = lambda: lstm_cuda.lstm_bwd(  # noqa: E731
                        ws[0], gates, cs, hs, h0, c0, dhs, dhf, dcf, dtype)
                else:
                    bwd = lambda: lstm_cuda.bilstm_bwd(ws[0], ws[1], gates, cs, hs, dhs, dtype)  # noqa: E731
                try:
                    before = dict(routes_bwd) if routes_bwd is not None else None
                    dxp = bwd()[0]
                except RuntimeError as err:  # a walk that does not hold the shape
                    entry[key] = f"refused: {err}"
                    continue
                if routes_bwd is not None:
                    entry[f"{key}/route"] = [k for k in routes_bwd if routes_bwd[k] != before[k]]
                entry[key] = time_ms(torch, bwd, args.iters)
                if dwhh is not None:
                    h_init = h0 if d == 1 else None
                    entry[f"{key}/dwhh"] = time_ms(
                        torch, lambda: dwhh(hs, h_init, dxp, d, dtype), args.iters)
                    entry[f"{key}/walk"] = entry[key] - entry[f"{key}/dwhh"]
            del xp, ws, dhs
        torch.cuda.empty_cache()

    smoke = _chip_smoke()
    bounds = {dt: {key: bound(key, dt, smoke)["bound_ms"] for key in times[dt]
                   if not key.endswith(("/route", "/walk")) and isinstance(times[dt][key], float)}
              for dt in times}
    report = {"tag": args.tag, "root": str(root), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "build_seconds": build_s, "iters": args.iters, "ms": times,
              "bound_ms": bounds}
    if args.library:
        g = torch.Generator(device="cpu").manual_seed(1)
        library = report["library_ms"] = {}
        entries = _entries(only)
        for key in (k for k in LIBRARY if k in entries):
            d, b, H, T = entries[key]
            dtype = torch.float32 if key.startswith("encoder") else torch.bfloat16
            features = H if key.startswith("encoder") else IN_FEATURES
            lstm = torch.nn.LSTM(features, H, batch_first=True, bidirectional=d == 2).to(dev, dtype)
            x = torch.randn(b, T, features, generator=g).to(dev, dtype)
            if key in FORWARD:
                with torch.inference_mode():
                    library[key] = time_ms(torch, lambda: lstm(x), args.iters)
            else:
                x.requires_grad_(True)
                out, _ = lstm(x)
                cot = torch.randn_like(out)
                library[key] = time_ms(
                    torch, lambda: out.backward(cot, retain_graph=True), args.iters)
        for key in (k for k in DWHH_LIBRARY if k in entries):
            d, b, H, T = entries[key]
            dtype = getattr(torch, DWHH_LIBRARY[key])
            # h_prev^T . dgates of each direction: [D, H, T B] @ [D, T B, 4H]
            hp = torch.randn(d, H, T * b, generator=g).to(dev, dtype)
            dg = torch.randn(d, T * b, 4 * H, generator=g).to(dev, dtype)
            with torch.inference_mode():
                library[f"{key}/dwhh"] = time_ms(torch, lambda: torch.matmul(hp, dg), args.iters)
    print(json.dumps(report))
    return 0


def compare(args) -> int:
    """Parent, change, change, parent in fresh processes; the four lines and
    a summary line of means and ratios (change / parent)."""
    here = Path(__file__).resolve()
    runs = [("parent", args.compare), ("change", str(here.parents[1])), ("change", str(here.parents[1])),
            ("parent", args.compare)]
    reports = []
    for i, (tag, root) in enumerate(runs):
        cmd = [sys.executable, str(here), "--root", root, "--tag", tag, "--iters", str(args.iters),
               "--only", args.only]
        if args.library and i == 1:
            cmd.append("--library")
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        reports.append(json.loads(line))
    summary: dict = {}
    for dt in ("bfloat16", "float32"):
        for key in _entries([o for o in args.only.split(",") if o]):
            if dt not in _dtypes(key):
                continue
            got = {tag: [r["ms"][dt].get(key) for r in reports if r["tag"] == tag] for tag in ("parent", "change")}
            if all(isinstance(v, float) for vals in got.values() for v in vals):
                p, c = (sum(got[t]) / len(got[t]) for t in ("parent", "change"))
                summary[f"{key}/{dt}"] = {"parent_ms": p, "change_ms": c, "ratio": c / p,
                                          "route": reports[1]["ms"][dt].get(f"{key}/route")}
            else:
                summary[f"{key}/{dt}"] = {"parent": got["parent"], "change": got["change"]}
    print(json.dumps({"compare": summary, "nvidia_smi": reports[0]["nvidia_smi"],
                      "library_ms": reports[1].get("library_ms"), "bound_ms": reports[1]["bound_ms"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
