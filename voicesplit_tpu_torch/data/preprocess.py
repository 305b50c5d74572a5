"""Offline preprocessing: CSV triplets → mixed triplet files on disk
(counterpart of `voicesplit_tpu/data/preprocess.py`).

Capability of reference `preprocess_by_csv.py:17-108` and
`preprocess_by_csv_without_voice_overlay.py:17-125`: read
``[clean, embedding_ref, interference]`` CSV rows, resolve LibriSpeech
``spk-chap-utt`` ids to paths, fan the mixing out over a spawned process
pool, and write ``*-{ref_emb,target,mixed}.wav`` triplets.  The same rows
and seeds give the JAX package's files.

With ``save_specs`` the ``*-target.npy`` / ``*-mixed.npy`` spectrograms are
computed after the pool has written the wavs, in this process, batched, with
the port's `AudioProcessor` on `device` (the CUDA card unless the CPU is
named): the workers never touch the card, so they open no CUDA context.
The CSV is parsed with the standard library's `csv` module.
"""

from __future__ import annotations

import csv
import os
from functools import partial
from multiprocessing import cpu_count, get_context
from typing import List, Optional, Sequence, Tuple

import numpy as np

from voicesplit_tpu_torch.config import Config, DatasetFormat
from voicesplit_tpu_torch.data.mixer import MixedSample, mix_overlap, mix_sequential
from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float

_HEADER_WORDS = ("utterance", "clean", "embedding", "interference", "noise", "file", "path")
SPEC_BATCH = 16  # clips per spectrogram call


def _read_csv_rows(path: str) -> List[List[str]]:
    """CSV rows (blank lines skipped) with header auto-detection: the first
    row is a header only when it looks like one, since the reference's own
    fixtures come both with and without."""
    with open(path, newline="") as f:
        rows = [row for row in csv.reader(f) if row]
    if rows:
        first = [cell.strip().lower() for cell in rows[0]]
        if any(any(w in cell for w in _HEADER_WORDS) for cell in first):
            rows = rows[1:]
    return rows


def read_triplet_csv(path: str) -> List[Tuple[str, str, str]]:
    """Rows of ``[clean, embedding_ref, interference]`` (header optional)."""
    return [tuple(row[:3]) for row in _read_csv_rows(path)]


def resolve_librispeech(utt_id: str, root: str, suffix: str = "-norm.wav") -> str:
    """``spk-chap-utt`` → ``root/spk/chap/spk-chap-utt-norm.wav``
    (reference `preprocess_by_csv.py:74-99`)."""
    spk, chap = utt_id.split("-")[:2]
    return os.path.join(root, spk, chap, utt_id + suffix)


def resolve_triplets(
    rows: Sequence[Tuple[str, str, str]], root: str, librispeech: bool = False
) -> List[Tuple[str, str, str]]:
    if librispeech:
        return [tuple(resolve_librispeech(x, root) for x in row) for row in rows]
    return [tuple(os.path.join(root, x) for x in row) for row in rows]


def _paths_for(out_dir: str, fmt: DatasetFormat, num: int, sub: Optional[int] = None):
    tag = "%06d" % num if sub is None else "%06d_%d" % (num, sub)

    def p(pattern: str, force_npy: bool = False) -> str:
        out = os.path.join(out_dir, pattern.replace("*", tag))
        if force_npy and out.endswith(".pt"):
            out = out[:-3] + ".npy"
        return out

    return {
        "emb_wav": p(fmt.emb_wav),
        "target_wav": p(fmt.target_wav),
        "mixed_wav": p(fmt.mixed_wav),
        "target": p(fmt.target, force_npy=True),
        "mixed": p(fmt.mixed, force_npy=True),
    }


def write_sample(sample: MixedSample, out_dir: str, fmt: DatasetFormat, num: int,
                 sample_rate: int, sub: Optional[int] = None) -> None:
    """Write one triplet's wavs (float32, unnormalized)."""
    paths = _paths_for(out_dir, fmt, num, sub)
    save_wav_float(sample.emb_wav, paths["emb_wav"], sample_rate)
    save_wav_float(sample.target_wav, paths["target_wav"], sample_rate)
    save_wav_float(sample.mixed_wav, paths["mixed_wav"], sample_rate)


def write_specs(config: Config, out_dir: str, keys: Sequence[Tuple[int, Optional[int]]],
                device=None) -> None:
    """``*-target.npy`` / ``*-mixed.npy`` spectrograms of the written wavs
    `keys` (``(num, sub)``), each as the JAX package's ``ap.wav2spec`` of
    the file read back, computed on `device` in batches of clips of one
    length."""
    import torch

    from voicesplit_tpu_torch.dsp.processor import make_audio_processor

    ap = make_audio_processor(config, device=device)
    fmt, sr = config.dataset.format, config.audio.active.sample_rate
    jobs = []  # (wav path, spec path)
    for num, sub in keys:
        paths = _paths_for(out_dir, fmt, num, sub)
        jobs += [(paths["target_wav"], paths["target"]), (paths["mixed_wav"], paths["mixed"])]
    wavs = {wav: load_wav(wav, sr) for wav, _ in jobs}
    by_len: dict = {}
    for wav, spec in jobs:
        by_len.setdefault(len(wavs[wav]), []).append((wav, spec))
    with torch.inference_mode():
        for group in by_len.values():
            for i in range(0, len(group), SPEC_BATCH):
                chunk = group[i : i + SPEC_BATCH]
                batch = torch.as_tensor(np.stack([wavs[w] for w, _ in chunk]), device=ap.device)
                specs = ap.wav2spec_batch(batch)[0].cpu().numpy()
                for (_, path), s in zip(chunk, specs):
                    np.save(path, s)


def _map(worker, jobs, num_workers: Optional[int]) -> list:
    num_workers = num_workers or cpu_count()
    if num_workers <= 1:
        return [worker(j) for j in jobs]
    with get_context("spawn").Pool(num_workers) as pool:
        return pool.map(worker, jobs)


def _mix_one(args: Tuple[int, Tuple[str, str, str]], out_dir: str, fmt: DatasetFormat,
             sample_rate: int, audio_len: float) -> bool:
    """Worker: True when a triplet was written."""
    num, (clean_path, emb_path, intf_path) = args
    try:
        emb = load_wav(emb_path, sample_rate)
        clean = load_wav(clean_path, sample_rate)
        intf = load_wav(intf_path, sample_rate)
    except Exception as e:
        print(f"skip {num}: unreadable input ({e})")
        return False
    sample = mix_overlap(emb, clean, intf, sample_rate, audio_len)
    if sample is None:
        return False
    write_sample(sample, out_dir, fmt, num, sample_rate)
    return True


def preprocess_csv(
    config: Config,
    csv_path: str,
    dataset_root: str,
    out_dir: str,
    librispeech: bool = False,
    num_workers: Optional[int] = None,
    save_specs: bool = False,
    limit: Optional[int] = None,
    device=None,
) -> int:
    """Mix every CSV row into `out_dir`; returns the number written."""
    os.makedirs(out_dir, exist_ok=True)
    rows = resolve_triplets(read_triplet_csv(csv_path), dataset_root, librispeech)
    if limit:
        rows = rows[:limit]
    worker = partial(
        _mix_one, out_dir=out_dir, fmt=config.dataset.format,
        sample_rate=config.audio.active.sample_rate, audio_len=config.audio.audio_len,
    )
    written = _map(worker, list(enumerate(rows)), num_workers)
    if save_specs:
        write_specs(
            config, out_dir, [(num, None) for num, ok in enumerate(written) if ok], device)
    return int(sum(written))


def _mix_one_sequential(
    args: Tuple[int, Tuple[str, str, str], Tuple[str, str]],
    out_dir: str,
    fmt: DatasetFormat,
    sample_rate: int,
    seed: int,
) -> int:
    """Worker for the non-overlap/noise variant; returns the variants written."""
    num, (clean_path, emb_path, intf_path), (noise1_path, noise2_path) = args
    try:
        emb = load_wav(emb_path, sample_rate)
        clean = load_wav(clean_path, sample_rate)
        intf = load_wav(intf_path, sample_rate)
        n1 = load_wav(noise1_path, sample_rate)
        n2 = load_wav(noise2_path, sample_rate)
    except Exception as e:
        print(f"skip {num}: unreadable input ({e})")
        return 0
    rng = np.random.default_rng((seed, num))
    samples = mix_sequential(emb, clean, intf, n1, n2, sample_rate, rng)
    for sub, sample in enumerate(samples, start=1):
        write_sample(sample, out_dir, fmt, num, sample_rate, sub=sub)
    return len(samples)


def preprocess_csv_sequential(
    config: Config,
    csv_path: str,
    noise_csv_path: str,
    dataset_root: str,
    out_dir: str,
    librispeech: bool = False,
    num_workers: Optional[int] = None,
    save_specs: bool = False,
    limit: Optional[int] = None,
    seed: int = 0,
    device=None,
) -> int:
    """Non-overlap/noise preprocessing (reference
    `preprocess_by_csv_without_voice_overlay.py:17-125`): each triplet row
    gets a random noise pair from the noise CSV; up to 4 variants are
    written per row.  Returns the variants written."""
    os.makedirs(out_dir, exist_ok=True)
    rows = resolve_triplets(read_triplet_csv(csv_path), dataset_root, librispeech)
    if limit:
        rows = rows[:limit]
    noise_files = [os.path.join(dataset_root, r[0]) for r in _read_csv_rows(noise_csv_path)]
    if len(noise_files) < 2:
        raise ValueError("noise CSV needs at least 2 files")
    rng = np.random.default_rng(seed)
    noise_pairs = [
        tuple(noise_files[i] for i in rng.choice(len(noise_files), 2, replace=False))
        for _ in rows
    ]
    worker = partial(
        _mix_one_sequential, out_dir=out_dir, fmt=config.dataset.format,
        sample_rate=config.audio.active.sample_rate, seed=seed,
    )
    jobs = [(i, row, pair) for i, (row, pair) in enumerate(zip(rows, noise_pairs))]
    written = _map(worker, jobs, num_workers)
    if save_specs:
        write_specs(
            config, out_dir,
            [(num, sub) for num, n in enumerate(written) for sub in range(1, n + 1)], device)
    return int(sum(written))
