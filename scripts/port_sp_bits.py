#!/usr/bin/env python3
"""Where the sharded long-form pass leaves the one-device pass's bits, on
the card.

    python3 scripts/port_sp_bits.py [--seconds 20 120] [--shards 2 3 4] [--seed 0]

For each clip length, conv route (library convs; ``VOICESPLIT_PALLAS_CONV=1``),
cuDNN setting (default; ``torch.backends.cudnn.deterministic``) and shard
count: the mask of K in-process shards (`parallel.sequence.InProcessExchange`)
against the world of one's, bit for bit or the largest difference, and
`chip_smoke._sp_differences` for an interior shard: every operation whose
output differs when both passes give it the same inputs (each conv block's
raw conv, the LSTM input projection, `lstm_fwd` from the true carry, fc1,
fc2).  Full width (`configs/voicesplit.json`, bf16), random weights from
``--seed``.  One JSON line a case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402  (the repository root, after the path)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, nargs="+", default=[20.0, 120.0])
    parser.add_argument("--shards", type=int, nargs="+", default=[2, 3, 4])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch
    import torch.nn.functional as tnf

    if not torch.cuda.is_available():
        print("port_sp_bits: no CUDA device", file=sys.stderr)
        return 1
    from voicesplit_tpu_torch import weights
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.ops import lstm_cuda
    from voicesplit_tpu_torch.parallel import sequence

    config = load_config(str(ROOT / "configs" / "voicesplit.json"))
    ap = make_audio_processor(config)
    model = weights.init_random_(make_masknet(config), args.seed)
    for seconds in args.seconds:
        n = int(seconds * ap.sample_rate)
        wav, emb = cs.synthetic_batch(args.seed + 11, 1, n, ap.sample_rate, config.model.emb_dim)
        e = torch.as_tensor(emb, device="cuda")
        with torch.inference_mode():
            spec, _ = ap.wav2spec_batch(torch.as_tensor(wav, device="cuda"))
        T = spec.shape[1]
        for route in ("library", "dilated"):
            for deterministic in (False, True):
                with cs._Env("VOICESPLIT_PALLAS_CONV", "1" if route == "dilated" else "0"):
                    torch.backends.cudnn.deterministic = deterministic
                    with torch.inference_mode():
                        one = sequence.make_sp_mask_fn(model, sequence.InProcessExchange(1))(spec, e, T)
                    for k in args.shards:
                        Tp = sequence.pad_frames(T, k, model.conv_context_left)
                        with torch.inference_mode():
                            mask = sequence.make_sp_mask_fn(model, sequence.InProcessExchange(k))(
                                tnf.pad(spec, (0, 0, 0, Tp - T)), e, T)[:, :T]
                        case = {"seconds": seconds, "frames": T, "route": route,
                                "cudnn_deterministic": deterministic, "shards": k,
                                "same_bits": torch.equal(mask, one),
                                "max_abs_diff": (mask - one).abs().max().item(),
                                "ops": cs._sp_differences(torch, lstm_cuda, model, spec, e, k,
                                                          shard=1 if k < 3 else k // 2)["differs"]}
                        print(json.dumps(case), flush=True)
                torch.backends.cudnn.deterministic = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
