"""Single-checkpoint evaluation CLI (PyTorch counterpart of
`voicesplit_tpu/cli/test.py`; reference `test.py:25-100`).

    python -m voicesplit_tpu_torch.cli.test --checkpoint_path ckpt \
        [-c config.json] [--test_dir dir] [--no_sdr] [--device cuda|cpu]

``--checkpoint_path`` is the port's ``checkpoint_<step>.pt`` or the JAX
package's ``checkpoint_<step>.msgpack``, told apart by the suffix and read
by `train.checkpoint.read_model_checkpoint` (`load_weights`), which holds
either to the model's shapes before loading.  The config defaults to the
one embedded in the checkpoint (reference `test.py:85-89`).  Prints one
JSON line: mean loss, SI-SNR, SDR, SI-SNRi.  The device is the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json


def load_weights(checkpoint_path: str, config_path=None, streaming: bool = False):
    """The config (from `config_path`, else the checkpoint's own) and the
    ``state_dict`` of its model (the streaming one with `streaming`) from a
    port ``.pt`` or JAX ``.msgpack`` checkpoint, read once and held to the
    model's names and shapes before anything is loaded."""
    from voicesplit_tpu_torch.config import load_config, load_config_from_str
    from voicesplit_tpu_torch.train.checkpoint import check_model_variables, read_model_checkpoint

    sd, config_str = read_model_checkpoint(checkpoint_path)
    config = load_config(config_path) if config_path else load_config_from_str(config_str)
    return config, check_model_variables(config, sd, checkpoint_path, streaming)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate one checkpoint")
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--test_dir", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--no_sdr", action="store_true")
    parser.add_argument("--max_items", type=int, default=None)
    parser.add_argument(
        "--sdr_backend", choices=["auto", "host", "device"], default="auto",
        help="host = per-item float64 projection; device = batched on the card",
    )
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.data.dataset import test_dataloader
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor
    from voicesplit_tpu_torch.eval.validation import validate
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.steps import make_eval_step

    config, sd = load_weights(args.checkpoint_path, args.config_path)
    if args.test_dir:
        config.dataset.test_dir = args.test_dir
    if args.batch_size:
        config.test_config.batch_size = args.batch_size

    ap = make_audio_processor(config, device=args.device)
    model = make_masknet(config, device=args.device)
    model.load_state_dict(sd)
    metrics = validate(
        make_eval_step(config, model, ap), test_dataloader(config, ap),
        compute_sdr=not args.no_sdr, log_sample=False, max_items=args.max_items,
        sdr_backend=args.sdr_backend,
    )
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
