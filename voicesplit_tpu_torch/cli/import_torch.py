"""Import a reference torch checkpoint into the port (PyTorch counterpart of
`voicesplit_tpu/cli/import_torch.py`).

    python -m voicesplit_tpu_torch.cli.import_torch \
        --torch_checkpoint checkpoint_50000.pt --output_dir ckpts/ \
        [-c config.json]

The reference saves ``checkpoint_%d.pt`` payloads
``{'model','optimizer','step','config_str'}`` (reference `train.py:126-132`).
This maps the model weights into the port's `MaskNet` (the BiLSTM input
rows permuted to the port's flatten order, `train/torch_import.py`) and
writes a ``checkpoint_<step>.pt`` with a fresh optimizer state; the config
comes from the embedded ``config_str`` (reference `test.py:87-89`) unless
``-c`` overrides it.  The result serves, evaluates and fine-tunes like any
checkpoint of the port's trainer.  Runs on the host only.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="reference .pt -> the port's checkpoint")
    parser.add_argument("--torch_checkpoint", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default=None,
                        help="override the checkpoint-embedded config")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.train.torch_import import import_torch_checkpoint

    config = load_config(args.config_path) if args.config_path else None
    path = import_torch_checkpoint(args.torch_checkpoint, args.output_dir, config)
    print(f"imported {args.torch_checkpoint} -> {path}")
    return path


if __name__ == "__main__":
    main()
