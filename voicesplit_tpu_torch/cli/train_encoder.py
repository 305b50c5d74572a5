"""GE2E speaker-encoder training CLI (PyTorch counterpart of
`voicesplit_tpu/cli/train_encoder.py`).

    python -m voicesplit_tpu_torch.cli.train_encoder --data_root DIR \
        [--speakers_per_batch 16] [--utts_per_speaker 6] [--steps 100000] \
        [--lr 1e-4] [--output_path logs/encoder] [-c config.json] \
        [--eval_interval 500] [--holdout_speakers 4] \
        [--resume encoder_<step>.pt|encoder_<step>.msgpack] [--device cpu]

Trains `SpeakerEncoder` with the GE2E softmax loss on a
``root/<speaker>/*.wav`` tree (`train/encoder.py::train_ge2e`: N speakers x
M random 80-frame crops a step, learnable (w, b) with their gradients scaled
by 0.01, global-norm clip 3.0, Adam).  Progress: the pairwise cosine EER of
held-out speakers every ``--eval_interval`` steps.  Checkpoints
``encoder_<step>.pt`` (`train/encoder.py::save_encoder_checkpoint`);
``--resume`` takes one of them or the JAX CLI's ``encoder_<step>.msgpack``.
`cli/extract_embeddings.py --encoder_checkpoint` reads both.  The device is
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

# the held-out EER's batch: at most EVAL_SPEAKERS speakers x EVAL_CROPS crops
EVAL_SPEAKERS, EVAL_CROPS = 8, 4


def eval_rows(pool: int) -> int:
    """The encoder's rows (windows) in one held-out EER batch drawn from
    `pool` speakers."""
    return min(pool, EVAL_SPEAKERS) * EVAL_CROPS


def _discover_speakers(root: str, min_utts: int):
    speakers = {}
    for d in sorted(os.listdir(root)):
        p = os.path.join(root, d)
        if not os.path.isdir(p):
            continue
        wavs = sorted(glob(os.path.join(p, "**", "*.wav"), recursive=True))
        if len(wavs) >= min_utts:
            speakers[d] = wavs
    return speakers


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train the GE2E speaker encoder (PyTorch)")
    parser.add_argument("--data_root", type=str, required=True,
                        help="root/<speaker>/*.wav tree")
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--speakers_per_batch", type=int, default=16)
    parser.add_argument("--utts_per_speaker", type=int, default=6)
    parser.add_argument("--steps", type=int, default=100000)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--output_path", type=str, default="logs/encoder")
    parser.add_argument("--checkpoint_interval", type=int, default=1000)
    parser.add_argument("--eval_interval", type=int, default=500)
    parser.add_argument("--log_interval", type=int, default=50)
    parser.add_argument("--holdout_speakers", type=int, default=4,
                        help="speakers reserved for the EER metric (0 = eval on train speakers)")
    parser.add_argument("--resume", type=str, default=None,
                        help="encoder_<step>.pt, or the JAX CLI's encoder_<step>.msgpack")
    parser.add_argument("--seed", type=int, default=0)
    # small-topology overrides (tests / quick experiments)
    parser.add_argument("--lstm_hidden", type=int, default=768)
    parser.add_argument("--lstm_layers", type=int, default=3)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from voicesplit_tpu_torch.config import Config, load_config
    from voicesplit_tpu_torch.device import resolve_device
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.losses.ge2e import pairwise_eer
    from voicesplit_tpu_torch.train.encoder import (
        MelSampler,
        load_encoder_checkpoint,
        save_encoder_checkpoint,
        train_ge2e,
    )

    config = load_config(args.config_path) if args.config_path else Config()
    dev = resolve_device(args.device)
    ap = make_audio_processor(config, device=dev)
    N, M = args.speakers_per_batch, args.utts_per_speaker

    speakers = _discover_speakers(args.data_root, min_utts=2)
    if len(speakers) < N + args.holdout_speakers:
        raise SystemExit(
            f"need >= {N + args.holdout_speakers} speakers with >=2 utts, "
            f"found {len(speakers)} under {args.data_root}"
        )
    names = sorted(speakers)
    holdout = names[: args.holdout_speakers]
    train_speakers = {
        k: v for k, v in speakers.items() if k not in set(holdout)
    } if args.holdout_speakers else speakers

    params = opt_state = None
    step0 = 0
    if args.resume:
        ckpt = load_encoder_checkpoint(args.resume)
        params, opt_state, step0 = ckpt["params"], ckpt["opt_state"], int(ckpt["step"])
        print(f" > resumed {args.resume} at step {step0}")

    eval_sampler = MelSampler(ap, speakers, window=80, rng=np.random.default_rng(args.seed + 1))

    def eval_eer(encoder):
        pool = holdout if holdout else names
        mels, ids = eval_sampler.batch(min(len(pool), EVAL_SPEAKERS), EVAL_CROPS, names=pool)
        with torch.inference_mode():
            emb = encoder(torch.as_tensor(mels, device=dev))
        return pairwise_eer(emb, ids)

    os.makedirs(args.output_path, exist_ok=True)
    chunk = min(
        x for x in (args.eval_interval or args.steps, args.checkpoint_interval, args.steps) if x > 0
    )
    step = step0
    while step < args.steps:
        n_now = min(chunk, args.steps - step)
        encoder, params, opt_state, _ = train_ge2e(
            ap, train_speakers,
            n_speakers=N, m_utts=M, steps=n_now, lr=args.lr,
            lstm_hidden=args.lstm_hidden, lstm_layers=args.lstm_layers,
            emb_dim=config.model.emb_dim, seed=args.seed + step,
            log_interval=args.log_interval,
            params=params, opt_state=opt_state, step0=step, device=dev,
        )
        step += n_now
        if args.eval_interval and step % args.eval_interval == 0:
            print(f"step {step}  holdout pairwise EER {eval_eer(encoder):.3f}", flush=True)
        if step % args.checkpoint_interval == 0 or step >= args.steps:
            path = os.path.join(args.output_path, f"encoder_{step}.pt")
            save_encoder_checkpoint(path, params, opt_state, step)
            print(f" > saved {path}", flush=True)


if __name__ == "__main__":
    main()
