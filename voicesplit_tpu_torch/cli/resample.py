"""Parallel resample / normalize of a wav tree (counterpart of
`voicesplit_tpu/cli/resample.py`; capability of reference
`scripts/normalise-resample.sh` without ffmpeg).

    python -m voicesplit_tpu_torch.cli.resample --root DIR \
        [--sample_rate 16000] [--suffix -norm] [--mode ebu|peak] \
        [--target_lufs -23] [--peak 0.95] [--num_workers N]

Polyphase resampling (`dsp/audio_io.py`), then ``--mode ebu`` (default,
ffmpeg-normalize's behaviour) normalizes the integrated loudness to
``--target_lufs`` by BS.1770 (`dsp/loudness.py`), ``--mode peak`` scales to
a peak level; each ``x.wav`` is written beside it as ``x<suffix>.wav``
(float32), over a ``spawn`` process pool.  Inputs already carrying the
suffix are skipped.  Host only.
"""

from __future__ import annotations

import argparse
import os
from functools import partial
from multiprocessing import cpu_count, get_context


def _process(path: str, sample_rate: int, suffix: str, mode: str,
             peak: float, target_lufs: float) -> bool:
    import numpy as np

    from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float

    try:
        wav = load_wav(path, sample_rate)
        if mode == "ebu":
            from voicesplit_tpu_torch.dsp.loudness import loudness_normalize

            wav = loudness_normalize(wav, sample_rate, target_lufs)
        else:
            m = float(np.max(np.abs(wav)))
            if m > 0:
                wav = wav * (peak / m)
        out = os.path.splitext(path)[0] + suffix + ".wav"
        save_wav_float(wav, out, sample_rate)
        return True
    except Exception as e:
        print(f"skip {path}: {e}")
        return False


def main(argv=None):
    parser = argparse.ArgumentParser(description="Resample + normalize a wav tree")
    parser.add_argument("--root", type=str, required=True)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--suffix", type=str, default="-norm")
    parser.add_argument("--mode", type=str, default="ebu", choices=["ebu", "peak"],
                        help="ebu = R128 loudness normalize (ffmpeg-normalize's "
                             "default behavior); peak = scale to --peak")
    parser.add_argument("--target_lufs", type=float, default=-23.0)
    parser.add_argument("--peak", type=float, default=0.95)
    parser.add_argument("--num_workers", type=int, default=None)
    args = parser.parse_args(argv)

    files = []
    for dirpath, _, names in os.walk(args.root):
        for n in names:
            if n.endswith(".wav") and not n.endswith(args.suffix + ".wav"):
                files.append(os.path.join(dirpath, n))
    worker = partial(_process, sample_rate=args.sample_rate, suffix=args.suffix,
                     mode=args.mode, peak=args.peak, target_lufs=args.target_lufs)
    with get_context("spawn").Pool(args.num_workers or cpu_count()) as pool:
        results = pool.map(worker, files)
    print(f"processed {sum(results)}/{len(files)} files under {args.root}")
    return sum(results), len(files)


if __name__ == "__main__":
    main()
