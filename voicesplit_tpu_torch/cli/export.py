"""Export a servable separation program (PyTorch counterpart of
`voicesplit_tpu/cli/export.py`): a ``torch.export`` ``.pt2`` program with the
weights inside, plus a JSON manifest beside it.

    python -m voicesplit_tpu_torch.cli.export --checkpoint_path ckpt \
        --output sep.pt2 [-c config.json] [--seconds 3.0] \
        [--platforms cuda,cpu] [--fixed_batch N]
    python -m voicesplit_tpu_torch.cli.export --checkpoint_path ckpt \
        --output chunk.pt2 --streaming [--chunk_frames 50] [--batch_size 1]

``--checkpoint_path`` is the port's ``checkpoint_<step>.pt`` or the JAX
package's ``checkpoint_<step>.msgpack``, both read by `cli.test.load_weights`
and held to the model's shapes first; with ``--streaming`` a streaming
checkpoint of either package (its ``cli.convert_streaming`` writes one), and
a BiLSTM checkpoint raises ``ValueError``.  The config is the checkpoint's
own unless ``-c`` names one.
``--platforms`` names the devices the program is exported for (default: the
CUDA card); each gets its own file (``sep.cuda.pt2``, ``sep.cpu.pt2`` for
two) and the manifest ``<output>.json`` lists them.  A server loads one with
`voicesplit_tpu_torch.export.load_artifact`, or with
``import voicesplit_tpu_torch.ops`` (the kernels' operators) and
``torch.export.load(path).module()``: no model code is needed.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Export a separation program (torch.export)")
    parser.add_argument("--checkpoint_path", type=str, required=True)
    parser.add_argument("-c", "--config_path", type=str, default=None)
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--seconds", type=float, default=3.0,
                        help="clip length of the e2e program (static shape)")
    parser.add_argument("--platforms", type=str, default=None,
                        help="comma list of cuda, cpu (default: the card)")
    parser.add_argument("--fixed_batch", type=int, default=None,
                        help="pin B instead of exporting it symbolic")
    parser.add_argument("--streaming", action="store_true",
                        help="export the streaming chunk step instead")
    parser.add_argument("--chunk_frames", type=int, default=50)
    parser.add_argument("--batch_size", type=int, default=1,
                        help="streaming state batch size")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.cli.test import load_weights
    from voicesplit_tpu_torch.export import (
        export_separator, export_streaming, save_artifact, separator_manifest,
    )

    platforms = args.platforms.split(",") if args.platforms else None
    config, variables = load_weights(args.checkpoint_path, args.config_path, args.streaming)
    if args.streaming:
        data, manifest = export_streaming(
            config, variables, chunk_frames=args.chunk_frames,
            batch_size=args.batch_size, platforms=platforms,
        )
    else:
        data = export_separator(
            config, variables, seconds=args.seconds, platforms=platforms,
            symbolic_batch=args.fixed_batch is None, batch_size=args.fixed_batch or 1,
        )
        manifest = separator_manifest(
            args.seconds, config.audio.active.sample_rate, config.model.emb_dim,
            args.fixed_batch, list(data),
        )
    files = save_artifact(args.output, data, manifest)
    for dev, path in files.items():
        print(f"wrote {path} ({len(data[dev]) / 1e6:.1f} MB, {dev})")
    print(f"wrote {args.output}.json")
    return files


if __name__ == "__main__":
    main()
