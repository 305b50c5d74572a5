"""Training CLI (PyTorch counterpart of `voicesplit_tpu/cli/train.py`;
reference `train.py:140-163`).

    python -m voicesplit_tpu_torch.cli.train -c config.json \
        [--checkpoint_path checkpoint_<step>.pt] [--logs_path dir] \
        [--max_steps N] [--eval_sdr] [--online [--emb_mode pseudo|spectral] \
        [--embeddings_dir DIR]] [--debug_nans] [--device cuda|cpu] \
        [--coordinator HOST:PORT --num_processes N --process_id K \
        [--model_parallel K]]

Trains on the triplets under the config's ``dataset.train_dir`` (read by the
native loader), or with ``--online`` on 2-speaker mixtures made afresh each
epoch from the speaker-per-directory corpus there (`data/online.py`; d-vectors
from ``--embeddings_dir``'s ``<speaker>.npy``, else per ``--emb_mode``);
validates on ``dataset.test_dir``, and writes checkpoints, ``metrics.jsonl``
and a copy of the config into the logs directory.  ``--checkpoint_path``
resumes (full restore: weights, optimizer, step and the position in the
data) or warm-starts (where shapes differ).  ``--debug_nans`` checks the
guard every step and names the first op with a non-finite output
(`train/trainer.py`).  The device is the CUDA card unless ``--device cpu``
is given.  Returns the result of ``fit()`` with ``wall_seconds`` and the
train loader's class name.

Data-parallel training: start one process a rank with the same flags and its
own ``--process_id``; ``--coordinator`` is rank 0's ``host:port`` (any free
port), ``--num_processes`` the world size.  The process group (NCCL on the
card, gloo with ``--device cpu``) starts before anything touches the device
and ends with the run.  ``--model_parallel K`` lays the processes out as a
``(N / K, K)`` mesh and splits the gates, conv channels and ``fc1``'s inputs
over its model axis (`parallel/sharding.py`: each process owns its slices of
those parameters and of their Adam moments); the K processes of a model group
share their batch, so ``batch_size`` is the batch of one data row, and the
global batch is ``batch_size × N / K``.  N must be a multiple of K: one
process with ``--model_parallel 2`` raises ``ValueError``.  Only rank 0 writes
the logs directory, a checkpoint of the full state.
"""

from __future__ import annotations

import argparse
import os
from glob import glob

def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a voice-separation model (PyTorch)")
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("--checkpoint_path", type=str, default=None,
                        help="checkpoint to resume (full) or warm-start (partial)")
    parser.add_argument("--logs_path", type=str, default=None)
    parser.add_argument("--model_parallel", type=int, default=1,
                        help="model-axis size for the wide variant")
    parser.add_argument("--max_steps", type=int, default=None)
    parser.add_argument("--eval_sdr", action="store_true",
                        help="compute SDR and SI-SNRi during eval (slower)")
    parser.add_argument("--online", action="store_true",
                        help="mix 2-speaker training batches on the fly from a "
                             "speaker-per-directory corpus at dataset.train_dir "
                             "instead of reading pre-mixed triplets")
    parser.add_argument("--emb_mode", choices=["pseudo", "spectral"], default="pseudo",
                        help="--online, for speakers without a precomputed embedding: "
                             "pseudo = identity tokens, spectral = training-free "
                             "signal-derived d-vectors of the reference utterance")
    parser.add_argument("--embeddings_dir", type=str, default=None,
                        help="with --online: <speaker>.npy d-vectors")
    parser.add_argument("--coordinator", type=str, default=None,
                        help="several processes: rank 0's address host:port (with "
                             "--num_processes 1, a world of one)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="several processes: their total number")
    parser.add_argument("--process_id", type=int, default=None,
                        help="several processes: this one's index")
    parser.add_argument("--debug_nans", action="store_true",
                        help="NaN-triage mode: check the explosion guard every step, keep "
                             "the pre-step state, and on explosion re-run the failing step "
                             "op by op to name the first op with a non-finite output")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from voicesplit_tpu_torch.parallel.mesh import initialize_distributed

    started = initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                     device=args.device)
    try:
        return _train(args)
    finally:
        if started:
            dist.destroy_process_group()


def _train(args):
    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.parallel.mesh import make_mesh, rank
    from voicesplit_tpu_torch.train.trainer import Trainer

    # every rank makes the mesh (and its sub-groups) before anything else
    mesh = make_mesh(model=args.model_parallel)
    config = load_config(args.config_path)
    if args.logs_path:
        config.train_config.logs_path = args.logs_path
    if rank() == 0:
        os.makedirs(config.train_config.logs_path, exist_ok=True)
        # keep a copy of the config next to the checkpoints (reference
        # copy_config_file behavior, utils/generic_utils.py:583-594)
        with open(os.path.join(config.train_config.logs_path, "config.json"), "w") as f:
            f.write(config.to_json())

    train_loader = None
    if args.online:
        from voicesplit_tpu_torch.data.online import OnlineMixIterator, discover_utterances

        embeddings = None
        if args.embeddings_dir:
            embeddings = {os.path.splitext(os.path.basename(p))[0]: p
                          for p in glob(os.path.join(args.embeddings_dir, "*.npy"))}
        active = config.audio.active
        train_loader = OnlineMixIterator(
            discover_utterances(config.dataset.train_dir),
            config.train_config.batch_size,
            sample_rate=active.sample_rate,
            audio_len=config.audio.audio_len,
            hop_length=active.hop_length,
            emb_dim=config.model.emb_dim,
            embeddings=embeddings,
            emb_mode=args.emb_mode,
            seed=config.train_config.seed,
            shard_id=mesh.coords(rank())[0],
            num_shards=mesh.data,
        )

    trainer = Trainer(config, checkpoint_path=args.checkpoint_path, mesh=mesh,
                      model_parallel=args.model_parallel, train_loader=train_loader,
                      debug_nans=args.debug_nans, device=args.device)
    try:
        result = trainer.fit(max_steps=args.max_steps, compute_sdr_in_eval=args.eval_sdr)
    finally:
        trainer.close()
    print(f"done: {result}")
    return {**result, "wall_seconds": dict(trainer.wall_seconds),
            "train_loader": type(trainer.train_loader).__name__}


if __name__ == "__main__":
    main()
