#!/usr/bin/env python3
"""Times the PyTorch port's conv kernel wrappers on the card.

    python3 scripts/port_conv_times.py [--root DIR] [--tag NAME] [--iters 10] [--library] [--channels] [--eval]

Imports `voicesplit_tpu_torch` from DIR (default: this checkout) and builds
its kernels there, so that an older tree unpacked with ``git archive`` into
a git-ignored directory is timed by the same script in the same call (run
parent, change, change, parent).  It uses only the wrappers' public calls,
which are the same in every tree since the port's fourth slice:

- ``conv_cuda.conv_dilated_fwd`` as the forward (``fwd``) and, with flipped
  weights, as the data gradient (``fwd_data_gradient``);
- ``conv_fused.conv_dgrad`` (flipped weights, with its bias gradient);
- ``conv_fused.conv_bn_act_fwd`` with the chain's mish prologue (none on
  the (7,1) layer, as the chain calls it), bias and statistics, and
  ``conv_fused.conv_wgrad_prologue``, the prologue pass alone (once per
  batch: it does not depend on the layer);
- ``conv_fused.conv_wgrad`` with the same prologue, its prologue pass inside
  its time, and ``conv_cuda.conv_dilated_wgrad``;

at the six layer kinds of conv2 … conv7 ((7,1), and (5,5) at time dilation
1, 2, 4, 8, 16) on ``[B, 301, 601, 64]`` bf16 activations, B=2 and B=8.
``--library`` adds cuDNN's time for the same function (``F.conv2d`` and
``aten.convolution_backward`` on channels-last bf16; for the chain's forward
also the eager BatchNorm + activation pass before the conv and
``torch.var_mean`` of its output), which the port never calls.  Each time
is the mean of ``--iters`` calls after two warm ones, between CUDA events.
Prints one JSON line with the card's name and power limit, the times per
layer and their sums over the six layers (one launch per layer; the dilated
forward runs twice per train step, as forward and as data gradient).

``--channels`` times the other widths instead, those of ``chip_smoke.py
--phases channels`` (this checkout's ``CHANNEL_DILATED_WIDTHS``,
``CHANNEL_CHAIN_WIDTHS`` and ``CHANNEL_LAYERS``) at ``[2, 301, 601, Cin]``
bf16: ``conv_dilated_fwd`` (forward, and on ``[2, 301, 601, Cout]`` with
flipped weights as data gradient) and ``conv_dilated_wgrad`` at each
(Cin, Cout), and ``conv_bn_act_fwd`` (mish prologue but on (7,1)),
``conv_dgrad`` and ``conv_wgrad`` at each chain width; keys
``"<width>/<layer>"``, and with ``--library`` cuDNN's times beside them.

``--eval`` times an eval-mode conv block instead, at B=1 and B=8 on the six
layer kinds, mish and relu, as the model runs it from the fp32 OIHW
parameters: ``eager_block`` is the dilated kernel's route with the bias,
BatchNorm and activation as eager passes (``conv_cuda.conv2d_dilated_bias``,
then ``bn_act.bn_act_eval``), ``eval_block`` the one-launch block
(``conv_cuda.conv2d_bn_act_eval``, weights cast in the same call), and
``eval_kernel`` / ``plain_kernel`` the eval-mode kernel and the plain
forward kernel alone on prepared weights.  A tree without the eval block
(before it existed) reports the eager block and the plain kernel only.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

LAYERS = {"7x1": ((7, 1), 1), "5x5-d1": ((5, 5), 1), "5x5-d2": ((5, 5), 2),
          "5x5-d4": ((5, 5), 4), "5x5-d8": ((5, 5), 8), "5x5-d16": ((5, 5), 16)}
SHAPE = (301, 601, 64)  # T, F, C of the model's conv activations (3 s clips)


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


def channel_times(torch, F, bn_act, cc, cf, g, iters: int, library: bool) -> dict:
    """The other widths of ``chip_smoke.py``'s channels phase at B=2: kernel
    times by wrapper and ``"<width>/<layer>"``, and cuDNN's beside them."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    T, F_ = SHAPE[:2]
    times: dict = {}
    lib: dict = {}

    def put(table, name, key, fn):
        table.setdefault(name, {})[key] = time_ms(torch, fn, iters)

    def lib_calls(x, d, w, dt):
        kt, kf = w.shape[:2]
        pad = ((kt - 1) * dt // 2, (kf - 1) // 2)
        x_nchw, d_nchw = x.permute(0, 3, 1, 2), d.permute(0, 3, 1, 2)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

        def bwd(mask):
            return torch.ops.aten.convolution_backward(
                d_nchw, x_nchw, w_oihw, None, (1, 1), pad, (dt, 1), False, (0, 0), 1, mask)
        return (lambda: F.conv2d(x_nchw, w_oihw, None, padding=pad, dilation=(dt, 1)),
                lambda: bwd((True, False, False)), lambda: bwd((False, True, False)), x_nchw, w_oihw, pad)

    with torch.inference_mode():
        for width, (cin, cout) in smoke.CHANNEL_DILATED_WIDTHS.items():
            x = torch.randn(2, T, F_, cin, generator=g).to("cuda", torch.bfloat16)
            d = torch.randn(2, T, F_, cout, generator=g).to("cuda", torch.bfloat16)
            for layer in smoke.CHANNEL_LAYERS:
                (kt, kf), dt = smoke.ALL_CONV_LAYERS[layer]
                w = (torch.randn(kt, kf, cin, cout, generator=g) * (kt * kf * cin) ** -0.5).to("cuda", torch.bfloat16)
                wf = cc.flip_weight(w)
                key = f"{width}/{layer}"
                put(times, "conv_dilated_fwd", key, lambda: cc.conv_dilated_fwd(x, w, dt))
                put(times, "conv_dilated_fwd_data_gradient", key, lambda: cc.conv_dilated_fwd(d, wf, dt))
                put(times, "conv_dilated_wgrad", key, lambda: cc.conv_dilated_wgrad(x, d, kt, kf, dt))
                if library:
                    fwd, dgrad, wgrad, *_ = lib_calls(x, d, w, dt)
                    put(lib, "conv2d", key, fwd)
                    put(lib, "data_gradient", key, dgrad)
                    put(lib, "weight_gradient", key, wgrad)
            del x, d
            torch.cuda.empty_cache()
        for C in smoke.CHANNEL_CHAIN_WIDTHS:
            x = torch.randn(2, T, F_, C, generator=g).to("cuda", torch.bfloat16)
            d = torch.randn(2, T, F_, C, generator=g).to("cuda", torch.bfloat16)
            bias = (0.1 * torch.randn(C, generator=g)).cuda()
            bn = (0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
                  torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g))
            scal = cf._scal_table(*bn).cuda()
            bn = [v.cuda() for v in bn]
            for layer in smoke.CHANNEL_LAYERS:
                (kt, kf), dt = smoke.ALL_CONV_LAYERS[layer]
                act = None if layer == "7x1" else "mish"
                on = act is not None
                w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to("cuda", torch.bfloat16)
                wf = cc.flip_weight(w)
                key = f"chain{C}/{layer}"
                put(times, "conv_bn_act_fwd", key, lambda: cf.conv_bn_act_fwd(x, w, bias, scal, dt, act, on))
                put(times, "conv_dgrad", key, lambda: cf.conv_dgrad(d, wf, dt))
                put(times, "conv_wgrad", key, lambda: cf.conv_wgrad(x, d, scal, kt, kf, dt, act, on))
                if library:
                    fwd, dgrad, wgrad, x_nchw, w_oihw, pad = lib_calls(x, d, w, dt)
                    cbias = bias.to(torch.bfloat16)

                    def chain_forward():
                        y = bn_act.bn_act_eval(x_nchw, bn[2], bn[3], bn[0], bn[1], act) if on else x_nchw
                        raw = F.conv2d(y, w_oihw, cbias, padding=pad, dilation=(dt, 1))
                        return raw, torch.var_mean(raw, dim=(0, 2, 3), correction=0)
                    put(lib, "chain_forward", key, chain_forward)
                    put(lib, "data_gradient", key, dgrad)
                    put(lib, "weight_gradient", key, wgrad)
            del x, d
            torch.cuda.empty_cache()
    out = {"ms": times, "widths": {k: list(v) for k, v in smoke.CHANNEL_DILATED_WIDTHS.items()},
           "chain_widths": list(smoke.CHANNEL_CHAIN_WIDTHS), "layers": list(smoke.CHANNEL_LAYERS)}
    if library:
        out["library_ms"] = lib
    return out


def eval_times(torch, bn_act, cc, g, iters: int) -> dict:
    """The eval-mode block at B=1 and B=8: ms by name and
    ``"B<b>/<layer>/<act>"``, and sums over the six layers by name, batch
    and activation."""
    T, F_, C = SHAPE
    has_eval = hasattr(cc, "conv_bn_act_eval")
    times: dict = {}
    with torch.inference_mode():
        for b in (1, 8):
            x = torch.randn(b, T, F_, C, generator=g).to("cuda", torch.bfloat16)
            for layer, ((kt, kf), dt) in LAYERS.items():
                conv = torch.nn.Conv2d(C, C, (kt, kf)).cuda()  # fp32 OIHW weights and bias, as the model holds them
                bn = torch.nn.Module()
                bn.scale, bn.bias = torch.rand(C, device="cuda") + 0.5, 0.1 * torch.randn(C, device="cuda")
                bn.mean, bn.var, bn.epsilon = 0.2 * torch.randn(C, device="cuda"), torch.rand(C, device="cuda") + 0.5, 1e-5
                w_perm = conv.weight.detach().permute(2, 3, 1, 0)
                w = w_perm.to(torch.bfloat16).contiguous()
                for act in ("mish", "relu"):
                    key = f"B{b}/{layer}/{act}"

                    def eager_block():
                        y = cc.conv2d_dilated_bias(x, w_perm, conv.bias, (dt, 1))
                        return bn_act.bn_act_eval(y.permute(0, 3, 1, 2), bn.scale, bn.bias, bn.mean, bn.var, act)
                    calls = {"eager_block": eager_block, "plain_kernel": lambda: cc.conv_dilated_fwd(x, w, dt)}
                    if has_eval:
                        calls["eval_block"] = lambda: cc.conv2d_bn_act_eval(x, w_perm, conv.bias, bn, act, (dt, 1))
                        calls["eval_kernel"] = lambda: cc.conv_bn_act_eval(
                            x, w, conv.bias, bn.scale, bn.bias, bn.mean, bn.var, act, 1e-5, dt)
                    for name, fn in calls.items():
                        times.setdefault(name, {})[key] = time_ms(torch, fn, iters)
            del x
            torch.cuda.empty_cache()
    sums = {name: {f"B{b}/{act}": sum(t[f"B{b}/{layer}/{act}"] for layer in LAYERS)
                   for b in (1, 8) for act in ("mish", "relu")} for name, t in times.items()}
    return {"eval_ms": times, "eval_ms_per_call": sums}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    parser.add_argument("--tag", default="")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--library", action="store_true")
    parser.add_argument("--channels", action="store_true",
                        help="time chip_smoke.py's channel widths instead of 64 channels")
    parser.add_argument("--eval", action="store_true",
                        help="time the eval-mode conv block against the kernel and eager passes")
    args = parser.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("port_conv_times: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch.ops import _build, bn_act
    from voicesplit_tpu_torch.ops import conv_cuda as cc
    from voicesplit_tpu_torch.ops import conv_fused as cf

    if not Path(cf.__file__).resolve().is_relative_to(root):
        print(f"port_conv_times: imported {cf.__file__}, not from {root}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    g = torch.Generator(device="cpu").manual_seed(0)
    if args.eval:
        report = {"tag": args.tag, "root": str(root), "device": torch.cuda.get_device_name(0),
                  "nvidia_smi": smi, "build_seconds": build_s, "iters": args.iters,
                  **eval_times(torch, bn_act, cc, g, args.iters)}
        print(json.dumps(report))
        return 0
    if args.channels:
        report = {"tag": args.tag, "root": str(root), "device": torch.cuda.get_device_name(0),
                  "nvidia_smi": smi, "build_seconds": build_s, "iters": args.iters,
                  **channel_times(torch, F, bn_act, cc, cf, g, args.iters, args.library)}
        print(json.dumps(report))
        return 0
    C = SHAPE[-1]
    names = ("conv_dilated_fwd", "conv_dilated_fwd_data_gradient", "conv_dgrad", "conv_bn_act_fwd",
             "conv_wgrad", "conv_dilated_wgrad")
    times = {name: {} for name in names}
    library = {name: {} for name in ("conv2d", "data_gradient", "weight_gradient", "chain_forward")}
    prologue_pass = {}
    for b in (2, 8):
        x = torch.randn(b, *SHAPE, generator=g).to("cuda", torch.bfloat16)
        d = torch.randn(b, *SHAPE, generator=g).to("cuda", torch.bfloat16)
        bias = (0.1 * torch.randn(C, generator=g)).cuda()
        bn = (0.2 * torch.randn(C, generator=g), torch.rand(C, generator=g) + 0.5,
              torch.rand(C, generator=g) + 0.5, 0.1 * torch.randn(C, generator=g))
        scal = cf._scal_table(*bn).cuda()
        bn = [v.cuda() for v in bn]  # mean, var, scale, beta
        with torch.inference_mode():
            prologue_pass[f"B{b}"] = time_ms(torch, lambda: cf.conv_wgrad_prologue(x, scal, "mish"),
                                             args.iters)
            for layer, ((kt, kf), dt) in LAYERS.items():
                act = None if layer == "7x1" else "mish"
                on = act is not None
                w = (torch.randn(kt, kf, C, C, generator=g) * (kt * kf * C) ** -0.5).to(
                    "cuda", torch.bfloat16)
                wf = cc.flip_weight(w)
                key = f"B{b}/{layer}"
                calls = {
                    "conv_dilated_fwd": lambda: cc.conv_dilated_fwd(x, w, dt),
                    "conv_dilated_fwd_data_gradient": lambda: cc.conv_dilated_fwd(d, wf, dt),
                    "conv_dgrad": lambda: cf.conv_dgrad(d, wf, dt),
                    "conv_bn_act_fwd": lambda: cf.conv_bn_act_fwd(x, w, bias, scal, dt, act, on),
                    "conv_wgrad": lambda: cf.conv_wgrad(x, d, scal, kt, kf, dt, act, on),
                    "conv_dilated_wgrad": lambda: cc.conv_dilated_wgrad(x, d, kt, kf, dt),
                }
                for name, fn in calls.items():
                    times[name][key] = time_ms(torch, fn, args.iters)
                if args.library:
                    pad = ((kt - 1) * dt // 2, (kf - 1) // 2)
                    x_nchw, d_nchw = x.permute(0, 3, 1, 2), d.permute(0, 3, 1, 2)
                    w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

                    def lib_bwd(mask):
                        return torch.ops.aten.convolution_backward(
                            d_nchw, x_nchw, w_oihw, None, (1, 1), pad, (dt, 1), False, (0, 0), 1, mask)

                    library["conv2d"][key] = time_ms(
                        torch, lambda: F.conv2d(x_nchw, w_oihw, None, padding=pad, dilation=(dt, 1)),
                        args.iters)
                    library["data_gradient"][key] = time_ms(
                        torch, lambda: lib_bwd((True, False, False)), args.iters)
                    library["weight_gradient"][key] = time_ms(
                        torch, lambda: lib_bwd((False, True, False)), args.iters)
                    cbias = bias.to(torch.bfloat16)

                    def lib_chain():
                        y = bn_act.bn_act_eval(x_nchw, bn[2], bn[3], bn[0], bn[1], act) if on else x_nchw
                        raw = F.conv2d(y, w_oihw, cbias, padding=pad, dilation=(dt, 1))
                        return raw, torch.var_mean(raw, dim=(0, 2, 3), correction=0)

                    library["chain_forward"][key] = time_ms(torch, lib_chain, args.iters)
        del x, d
        torch.cuda.empty_cache()

    def per_step(t):
        return {f"B{b}": sum(t[f"B{b}/{layer}"] for layer in LAYERS) for b in (2, 8)}

    report = {"tag": args.tag, "root": str(root), "device": torch.cuda.get_device_name(0),
              "nvidia_smi": smi, "build_seconds": build_s, "iters": args.iters,
              "ms": times, "ms_per_step": {name: per_step(t) for name, t in times.items()},
              "prologue_pass_ms": prologue_pass}
    if args.library:
        report["library_ms"] = library
        report["library_ms_per_step"] = {name: per_step(t) for name, t in library.items()}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
