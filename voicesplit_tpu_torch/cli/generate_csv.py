"""VCTK-style triplet-CSV generator (counterpart of
`voicesplit_tpu/cli/generate_csv.py`; capability of reference
`scripts/generate_VCTK_dev_csv.py:6-46`).

For every ordered speaker pair, pick a clean utterance and a distinct
embedding reference from the clean speaker and an interference utterance
from the other speaker, rejecting clips shorter than ``audio_len`` seconds
(VCTK texts are parallel, so same-name clips are rejected between speakers).

    python -m voicesplit_tpu_torch.cli.generate_csv --dataset_dir VCTK/wav48 \
        --output dev.csv [--speakers p225 p226 ...] [--sample_rate 16000] \
        [--audio_len 3.0] [--max_pairs N] [--seed 0]

The same ``random.Random(seed)`` draws in the same order as the JAX CLI, so a
seed gives the same rows; the file is written with the `csv` module in the
bytes that JAX's ``pandas.DataFrame.to_csv(index=False)`` writes.  Host only.
"""

from __future__ import annotations

import argparse
import csv
import os
import random

COLUMNS = ["clean_utterance", "embedding_utterance", "interference_utterance"]


def triplet_rows(dataset_dir: str, speakers=None, sample_rate: int = 16000,
                 audio_len: float = 3.0, max_pairs=None, seed: int = 0):
    """The CSV's rows: ``[clean, embedding, interference]`` paths relative to
    `dataset_dir`, one per ordered speaker pair that has usable clips, at
    most `max_pairs`."""
    from voicesplit_tpu_torch.dsp.audio_io import load_wav

    rng = random.Random(seed)
    speakers = speakers or sorted(
        d for d in os.listdir(dataset_dir) if os.path.isdir(os.path.join(dataset_dir, d))
    )
    min_samples = int(sample_rate * audio_len)

    def long_enough(spk: str, name: str) -> bool:
        try:
            wav = load_wav(os.path.join(dataset_dir, spk, name), sample_rate)
        except Exception:
            return False
        return len(wav) >= min_samples

    def pick(spk: str, reject=(), tries: int = 20):
        files = [f for f in os.listdir(os.path.join(dataset_dir, spk)) if f.endswith(".wav")]
        rng.shuffle(files)
        for name in files[:tries]:
            # reject parallel-text / duplicate clips by suffix (utterance id)
            suffix = name.replace(spk, "")
            if suffix in reject:
                continue
            if long_enough(spk, name):
                return name, suffix
        return None, None

    rows = []
    # every ORDERED speaker pair (the reference builds N*(N-1) rows; unordered
    # pairs would skew which speakers ever appear as the clean target)
    for clean_spk in speakers:
        for intf_spk in speakers:
            if intf_spk == clean_spk:
                continue
            clean, clean_sfx = pick(clean_spk)
            if clean is None:
                continue
            emb, _ = pick(clean_spk, reject=(clean_sfx,))
            if emb is None:
                continue
            intf, _ = pick(intf_spk, reject=(clean_sfx,))
            if intf is None:
                continue
            rows.append([os.path.join(clean_spk, clean), os.path.join(clean_spk, emb),
                         os.path.join(intf_spk, intf)])
            if max_pairs and len(rows) >= max_pairs:
                return rows
    return rows


def write_csv(rows, path: str) -> None:
    """pandas' ``to_csv(index=False)`` bytes: a header, ``\\n`` line ends,
    fields quoted only where they need it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
        w.writerow(COLUMNS)
        w.writerows(rows)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate a triplet CSV from a speaker-per-directory corpus")
    parser.add_argument("--dataset_dir", type=str, required=True,
                        help="root with one subdirectory of wavs per speaker")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--speakers", type=str, nargs="*", default=None,
                        help="speaker subdirectories (default: all)")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--audio_len", type=float, default=3.0)
    parser.add_argument("--max_pairs", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    rows = triplet_rows(args.dataset_dir, args.speakers, args.sample_rate, args.audio_len,
                        args.max_pairs, args.seed)
    write_csv(rows, args.output)
    print(f"wrote {len(rows)} triplets to {args.output}")
    return rows


if __name__ == "__main__":
    main()
