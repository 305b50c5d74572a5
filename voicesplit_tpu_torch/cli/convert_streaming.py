"""Convert an offline BiLSTM checkpoint into a streaming warm start (PyTorch
counterpart of `voicesplit_tpu/cli/convert_streaming.py`).

    python -m voicesplit_tpu_torch.cli.convert_streaming \
        --checkpoint_path checkpoint_<step>.pt --output_dir stream_ckpts/ \
        [--no_causal] [--device cuda|cpu]

Seeds the zero-lookahead deployment model (causal convs and a forward-only
LSTM) from a trained offline BiLSTM checkpoint, the port's ``.pt`` or the
JAX package's ``.msgpack``: ``lstm.fwd_*`` verbatim, ``fc1`` collapsed as
``W_f + W_b``, everything else copied
(`train/checkpoint.py::bilstm_to_streaming_sd`).  Writes
``checkpoint_0.pt``; fine-tune with `cli.train --checkpoint_path <it> -c
<causal config>` or serve with `cli.separate --streaming`.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="BiLSTM → streaming warm start")
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--no_causal", action="store_true",
                        help="keep symmetric (non-causal) convs in the written config; "
                             "only the LSTM becomes forward-only")
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.train.checkpoint import convert_bilstm_checkpoint_to_streaming

    path = convert_bilstm_checkpoint_to_streaming(
        args.checkpoint_path, args.output_dir, causal=not args.no_causal, device=args.device
    )
    print(f"wrote streaming warm-start: {path}")
    return path


if __name__ == "__main__":
    main()
