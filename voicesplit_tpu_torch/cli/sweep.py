"""Checkpoint-sweep CLI (PyTorch counterpart of `voicesplit_tpu/cli/sweep.py`;
reference `test_all_checkpoints.py` / `test_fast_all_checkpoints.py`).

    python -m voicesplit_tpu_torch.cli.sweep --checkpoints_path dir \
        [-c config.json] [--fast] [--test_dir dir] [--device cuda|cpu]

Evaluates every ``checkpoint_<step>.pt`` in the directory, copies
``[fast_]best_checkpoint.pt`` and ``[fast_]best_loss_checkpoint.pt`` beside
them and saves the metric curve (`eval.sweep.sweep_checkpoints`).  The
config defaults to the one embedded in the last checkpoint.  Prints one JSON
line: the best paths and metrics and the number of checkpoints.  The device
is the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(description="Sweep all checkpoints")
    parser.add_argument("--checkpoints_path", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--test_dir", type=str, default=None)
    parser.add_argument("--fast", action="store_true",
                        help="batched SI-SNR only (no SDR projection)")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--max_items", type=int, default=None)
    parser.add_argument(
        "--sdr_backend", choices=["auto", "host", "device"], default="auto",
        help="host = per-item float64 projection; device = batched on the card",
    )
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data.dataset import test_dataloader
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.eval.sweep import sweep_checkpoints
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.checkpoint import config_from_checkpoint, list_checkpoints
    from voicesplit_tpu_torch.train.steps import make_eval_step

    ckpts = list_checkpoints(args.checkpoints_path)
    if not ckpts:
        raise SystemExit(f"no checkpoints in {args.checkpoints_path}")
    config = load_config(args.config_path) if args.config_path else config_from_checkpoint(ckpts[-1])
    if args.test_dir:
        config.dataset.test_dir = args.test_dir
    ap = make_audio_processor(config, device=args.device)
    model = make_masknet(config, device=args.device)
    sdr_backend = args.sdr_backend
    if sdr_backend == "auto":
        sdr_backend = "device" if ap.device.type == "cuda" else "host"
    if args.batch_size:
        config.test_config.batch_size = args.batch_size
    elif args.fast:
        config.test_config.batch_size = 5  # reference fast sweep default
    elif sdr_backend == "device":
        config.test_config.batch_size = 8  # SDR is batched on the card too
    else:
        config.test_config.batch_size = 1  # reference full sweep forces bs=1

    out = sweep_checkpoints(
        args.checkpoints_path, config, model, make_eval_step(config, model, ap),
        test_dataloader(config, ap), fast=args.fast, max_items=args.max_items,
        sdr_backend=sdr_backend,
    )
    summary = {
        "best_path": out["best_path"],
        "best_metric": out["best_metric"],
        "best_loss_path": out["best_loss_path"],
        "best_loss": out["best_loss"],
        "n_checkpoints": len(out["results"]),
    }
    print(json.dumps(summary))
    return {**summary, "results": out["results"]}


if __name__ == "__main__":
    main()
