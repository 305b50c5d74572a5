"""Utterance mixing — the capability of the reference's offline mixers (a
numpy-only copy of the JAX package's `voicesplit_tpu/data/mixer.py`).

Two mixing modes, matching reference behavior but written as pure
functions over arrays (no file IO inside), so the same code serves the
offline preprocess CLI *and* on-the-fly training-time mixing:

- `mix_overlap` — paper-style overlapped 2-speaker mix (reference
  `mix_wavfiles`, `utils/generic_utils.py:300-345`): trim silence at
  top_db=20, crop both utterances to `audio_len` seconds (reject if
  shorter), ``mixed = clean + interference``, normalize everything by
  ``1.1 * max|mixed|``.
- `mix_sequential` — non-overlapping/noise variant (reference
  `mix_wavfiles_without_voice_overlay`, `utils/generic_utils.py:53-297`):
  random 2-4 s segments, two summed noise beds, VAD-split interleave,
  emitting four sub-variants per input — mixed, identity (input=output),
  zero-mask (interference only), and random-amplitude.

All randomness flows through an explicit ``np.random.Generator`` so the
pipeline is deterministic and checkpointable (the reference used global
``random`` state).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from voicesplit_tpu_torch.dsp.audio_io import split_on_silence, trim_silence


@dataclass
class MixedSample:
    """One training triplet: reference audio for the d-vector, the target
    (clean) waveform, and the 2-speaker mixture."""

    emb_wav: np.ndarray
    target_wav: np.ndarray
    mixed_wav: np.ndarray
    variant: str = "mixed"  # mixed | identity | zero_mask | random_amp


def _minmax_scale(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """sklearn.preprocessing.minmax_scale semantics (reference `:27-51`)."""
    xmin, xmax = x.min(), x.max()
    scale = (hi - lo) / (xmax - xmin) if xmax > xmin else 0.0
    return (x - xmin) * scale + lo


def mix_overlap(
    emb_audio: np.ndarray,
    clean_audio: np.ndarray,
    interference: np.ndarray,
    sample_rate: int,
    audio_len: float = 3.0,
    trim_top_db: float = 20.0,
    rng: Optional[np.random.Generator] = None,
    crop_jitter: bool = False,
    snr_jitter_db: float = 0.0,
    gain_jitter_db: float = 0.0,
    allow_short: bool = False,
    min_clean_s: float = 1.0,
) -> Optional[MixedSample]:
    """Paper-style overlapped mix; returns None if an utterance is too short
    after silence trimming (the reference discards those, `:316-318`).

    Defaults reproduce the reference exactly (head crop, unit gains,
    ≥`audio_len` sources).  The opt-in augmentations (all drawn from the
    caller's `rng`, keeping the pipeline deterministic/resumable):

    - ``crop_jitter`` — random crop offset instead of the head crop, so a
      long utterance yields different `audio_len` windows every epoch.
    - ``snr_jitter_db`` — interference gain jittered uniformly in
      ±that many dB before summing (mixing-SNR diversity).
    - ``gain_jitter_db`` — post-normalization attenuation of target AND
      mixture by a shared uniform [−x, 0] dB gain (absolute-level
      diversity; the ideal mask is unchanged).
    - ``allow_short`` — sources shorter than `audio_len` (but with the
      clean source ≥ `min_clean_s`) are placed at a random offset in a
      zero bed instead of rejected: partial overlap, and target silence
      the mask must zero — both realistic, and it admits speakers the
      strict ≥3 s rule would exclude entirely.
    """
    emb_audio, _ = trim_silence(emb_audio, top_db=trim_top_db)
    clean_audio, _ = trim_silence(clean_audio, top_db=trim_top_db)
    interference, _ = trim_silence(interference, top_db=trim_top_db)

    n = int(sample_rate * audio_len)
    if clean_audio.shape[0] < n or interference.shape[0] < n:
        if not (allow_short and rng is not None):
            return None
        if clean_audio.shape[0] < int(sample_rate * min_clean_s):
            return None
        if interference.shape[0] < 1:
            return None

    def place(x: np.ndarray) -> np.ndarray:
        if x.shape[0] >= n:
            start = 0
            if crop_jitter and rng is not None and x.shape[0] > n:
                start = int(rng.integers(0, x.shape[0] - n + 1))
            return x[start : start + n]
        out = np.zeros(n, dtype=x.dtype)
        off = int(rng.integers(0, n - x.shape[0] + 1)) if rng is not None else 0
        out[off : off + x.shape[0]] = x
        return out

    clean_audio = place(clean_audio)
    interference = place(interference)
    if snr_jitter_db > 0.0 and rng is not None:
        interference = interference * 10.0 ** (
            rng.uniform(-snr_jitter_db, snr_jitter_db) / 20.0
        )
    mixed = clean_audio + interference

    norm = np.max(np.abs(mixed)) * 1.1
    if norm <= 0:
        return None
    gain = 1.0
    if gain_jitter_db > 0.0 and rng is not None:
        gain = 10.0 ** (rng.uniform(-gain_jitter_db, 0.0) / 20.0)
    return MixedSample(
        emb_wav=emb_audio.astype(np.float32),
        target_wav=(clean_audio * (gain / norm)).astype(np.float32),
        mixed_wav=(mixed * (gain / norm)).astype(np.float32),
    )


def _random_amp(x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Reference `get_audios_with_random_amp` per-signal rescale (`:27-51`)."""
    lo = rng.uniform(-1, -0.3)
    hi = -lo + rng.uniform(0.0, 0.02)
    return _minmax_scale(x, lo, hi)


def mix_sequential(
    emb_audio: np.ndarray,
    clean_audio: np.ndarray,
    interference: np.ndarray,
    noise_1: np.ndarray,
    noise_2: np.ndarray,
    sample_rate: int,
    rng: np.random.Generator,
    trim_top_db: float = 20.0,
) -> List[MixedSample]:
    """Non-overlapping mix with noise beds; returns up to 4 variants
    (empty list if inputs are too short — the reference's discards).

    Behavior per reference `mix_wavfiles_without_voice_overlay`: random
    2-4 s crops of clean/interference, one shared noise bed = sum of two
    noise files at a random offset, a coin flip choosing whether the
    clean utterance is VAD-split around the interference or vice versa,
    then one norm factor of ``1.1 * max|mixed|`` applied to everything.
    """
    emb_audio, _ = trim_silence(emb_audio, top_db=trim_top_db)
    clean_audio, _ = trim_silence(clean_audio, top_db=trim_top_db)
    interference, _ = trim_silence(interference, top_db=trim_top_db)

    # embedding reference must cover >= 1.1 * window * hop samples (`:73-78`)
    if emb_audio.shape[0] < 1.1 * 80 * 160:
        return []

    two_clean = bool(rng.integers(0, 2))
    n_clean = int(sample_rate * rng.integers(2, 5))
    n_intf = int(sample_rate * rng.integers(2, 5))
    out_len = n_clean + n_intf

    if min(len(noise_1), len(noise_2)) < out_len + 1:
        return []
    start = int(rng.integers(0, min(len(noise_1), len(noise_2)) - out_len))
    noise = noise_1[start : start + out_len] + noise_2[start : start + out_len]

    if clean_audio.shape[0] < n_clean or interference.shape[0] < n_intf:
        return []

    emb_r = _random_amp(emb_audio, rng)
    clean_r = _random_amp(clean_audio, rng)[:n_clean]
    intf_r = _random_amp(interference, rng)[:n_intf]
    noise_r = _random_amp(noise, rng)

    # noise scaled relative to signal floor (`:104-110`).  Bounds are
    # sorted: for quiet inputs (floor > -0.1, e.g. low-amplitude clips
    # after trim) the reference's uniform(floor, -0.1) has low > high
    # and numpy raises — the sample should mix, not crash the run.
    floor = float(min(clean_audio.min(), interference.min()))
    lo = float(rng.uniform(*sorted((floor, -0.1))))
    # reference semantics (hi just below -lo); clamped positive so tiny
    # |lo| can't push hi below lo
    hi = max(-lo - float(rng.uniform(0.0, 0.02)), 0.5 * -lo)
    noise = _minmax_scale(noise, lo, hi)

    clean_audio = clean_audio[:n_clean]
    interference = interference[:n_intf]

    def interleave(a: np.ndarray, b: np.ndarray, nz: np.ndarray, split_a: bool, top_db: float):
        """Place `b` inside (or beside) `a` with a continuous noise bed.

        Returns (mixed, target-with-b-zeroed) when `a` is the clean source;
        caller flips roles for the interference-split case.
        """
        parts = split_on_silence(a, top_db=top_db)
        if len(parts) > 1:
            clip = int(parts[len(parts) // 2][1])
            p1, p2 = a[:clip], a[clip:]
            p1 = p1 + nz[: len(p1)]
            b_n = b + nz[len(p1) : len(p1) + len(b)]
            p2 = p2 + nz[len(p1) + len(b) : len(p1) + len(b) + len(p2)]
            mixed = np.concatenate([p1, b_n, p2])
            if split_a:  # a is clean → zero the inserted interference
                target = np.concatenate([p1, np.zeros_like(b_n), p2])
            else:  # a is interference → only the middle (clean) is target
                target = np.concatenate([np.zeros_like(p1), b_n, np.zeros_like(p2)])
        else:
            a_n = a + nz[: len(a)]
            b_n = b + nz[len(a) : len(a) + len(b)]
            mixed = np.concatenate([a_n, b_n])
            if split_a:
                target = np.concatenate([a_n, np.zeros_like(b_n)])
            else:
                target = np.concatenate([np.zeros_like(a_n), b_n])
        return mixed, target

    if two_clean:
        mixed, target = interleave(clean_audio, interference, noise, True, 20.0)
        mixed_r, target_r = interleave(clean_r, intf_r, noise_r, True, 20.0)
        intf_only = interference + noise[n_clean : n_clean + n_intf]
    else:
        mixed, target = interleave(interference, clean_audio, noise, False, 15.0)
        mixed_r, target_r = interleave(intf_r, clean_r, noise_r, False, 15.0)
        intf_only = interference + noise[: n_intf]

    out: List[MixedSample] = []
    norm = np.max(np.abs(mixed)) * 1.1
    if norm > 0:
        out.append(
            MixedSample(
                (emb_audio / norm).astype(np.float32),
                (target / norm).astype(np.float32),
                (mixed / norm).astype(np.float32),
                "mixed",
            )
        )
        clean_n = (clean_audio + noise[: n_clean]) / norm if two_clean else (
            clean_audio + noise[n_intf : n_intf + n_clean]
        ) / norm
        # identity: input == output (teaches mask≈1 on own voice, `:250-264`)
        out.append(
            MixedSample(
                (emb_audio / norm).astype(np.float32),
                clean_n.astype(np.float32),
                clean_n.astype(np.float32),
                "identity",
            )
        )
        # zero-mask: mixture contains no target speaker (`:266-280`)
        out.append(
            MixedSample(
                (emb_audio / norm).astype(np.float32),
                np.zeros_like(intf_only, dtype=np.float32),
                (intf_only / norm).astype(np.float32),
                "zero_mask",
            )
        )
    norm_r = np.max(np.abs(mixed_r)) * 1.1
    if norm_r > 0:
        out.append(
            MixedSample(
                (emb_r / norm_r).astype(np.float32),
                (target_r / norm_r).astype(np.float32),
                (mixed_r / norm_r).astype(np.float32),
                "random_amp",
            )
        )
    return out
