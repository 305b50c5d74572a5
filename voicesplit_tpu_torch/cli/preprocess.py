"""Offline preprocessing CLI (PyTorch counterpart of
`voicesplit_tpu/cli/preprocess.py`; reference `preprocess_by_csv.py`).

    python -m voicesplit_tpu_torch.cli.preprocess -c config.json -r DATASET_ROOT \
        [-d train.csv] [-t test.csv] -o OUT_DIR [-l] [--noise_csv noise.csv] \
        [--save_specs] [--num_workers N] [--limit N] [--device cuda|cpu]

CSV rows are ``[clean, embedding_ref, interference]``; with ``-l`` ids are
resolved LibriSpeech-style (``spk-chap-utt`` → ``spk/chap/…-norm.wav``).
Writes ``train/`` and/or ``test/`` triplet directories under OUT_DIR;
``--save_specs`` also writes the spectrograms, computed on the device (the
CUDA card unless ``--device cpu`` is given; without a card the CLI raises).
Returns ``{split: triplets written}``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="Mix CSV triplets into a dataset (PyTorch)")
    parser.add_argument("-c", "--config_path", type=str, required=True)
    parser.add_argument("-r", "--dataset_root_dir", type=str, required=True)
    parser.add_argument("-d", "--train_data_csv", type=str, default=None)
    parser.add_argument("-t", "--test_data_csv", type=str, default=None)
    parser.add_argument("-o", "--out_dir", type=str, required=True)
    parser.add_argument("-l", "--librispeech", action="store_true")
    parser.add_argument("--noise_csv", type=str, default=None,
                        help="noise-file CSV: switches to the non-overlap/noise "
                             "mixer emitting 4 variants per row")
    parser.add_argument("--save_specs", action="store_true",
                        help="also write *-target.npy / *-mixed.npy spectrograms")
    parser.add_argument("--num_workers", type=int, default=None)
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from voicesplit_tpu_torch.config import load_config
    from voicesplit_tpu_torch.data.preprocess import preprocess_csv, preprocess_csv_sequential
    from voicesplit_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    config = load_config(args.config_path)
    written = {}
    for csv_path, split in ((args.train_data_csv, "train"), (args.test_data_csv, "test")):
        if not csv_path:
            continue
        out = os.path.join(args.out_dir, split)
        common = dict(librispeech=args.librispeech, num_workers=args.num_workers,
                      save_specs=args.save_specs, limit=args.limit, device=device)
        if args.noise_csv:
            n = preprocess_csv_sequential(
                config, csv_path, args.noise_csv, args.dataset_root_dir, out, **common)
        else:
            n = preprocess_csv(config, csv_path, args.dataset_root_dir, out, **common)
        print(f"{split}: wrote {n} triplets to {out}")
        written[split] = n
    return written


if __name__ == "__main__":
    main()
