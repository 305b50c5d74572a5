"""ITU-R BS.1770-4 integrated loudness (EBU R128) — numpy, host-side.

The reference's dataset-prep pipeline runs `ffmpeg-normalize`
(`scripts/normalise-resample.sh:12`), whose default behavior is EBU R128
loudness normalization to a target LUFS.  This module implements the
measurement that underlies it (a copy of the JAX package's
`voicesplit_tpu/dsp/loudness.py`, which imports nothing of JAX either):

- K-weighting: stage-1 high-shelf (+~4 dB above ~1.5 kHz, head model)
  followed by the RLB high-pass (~38 Hz), as second-order IIR sections
  whose coefficients are derived for arbitrary sample rates with the
  standard bilinear-transform parameterization.
- Integrated loudness: mean-square over 400 ms blocks with 75% overlap,
  -70 LUFS absolute gate then -10 LU relative gate,10*log10 - 0.691.

Mono-only (the pipeline is mono 16 kHz); multi-channel weighting is out
of scope.  This is offline dataset prep — plain numpy/scipy on the
host, not a device path.
"""

from __future__ import annotations

import numpy as np


def _k_weighting_sos(fs: float) -> np.ndarray:
    """Two biquads (shelf, high-pass) as an sos array [2, 6]."""
    # stage 1: spherical-head high-shelf (BS.1770-4 Annex 1 values at
    # 48 kHz; parameterized for any fs via the standard pre-warped
    # bilinear design used by pyloudnorm/librosa implementations)
    db = 3.999843853973347
    f0 = 1681.974450955533
    Q = 0.7071752369554196
    K = np.tan(np.pi * f0 / fs)
    Vh = np.power(10.0, db / 20.0)
    Vb = np.power(Vh, 0.4996667741545416)
    a0 = 1.0 + K / Q + K * K
    b0 = (Vh + Vb * K / Q + K * K) / a0
    b1 = 2.0 * (K * K - Vh) / a0
    b2 = (Vh - Vb * K / Q + K * K) / a0
    a1 = 2.0 * (K * K - 1.0) / a0
    a2 = (1.0 - K / Q + K * K) / a0
    shelf = [b0, b1, b2, 1.0, a1, a2]

    # stage 2: RLB weighting (high-pass)
    f0 = 38.13547087602444
    Q = 0.5003270373238773
    K = np.tan(np.pi * f0 / fs)
    a0 = 1.0 + K / Q + K * K
    a1 = 2.0 * (K * K - 1.0) / a0
    a2 = (1.0 - K / Q + K * K) / a0
    # BS.1770 specifies the RLB numerator UNNORMALIZED ([1, -2, 1]
    # with a0-normalized denominator) — at 48 kHz this reproduces the
    # spec's table coefficients exactly
    hp = [1.0, -2.0, 1.0, 1.0, a1, a2]
    return np.asarray([shelf, hp], dtype=np.float64)


def _sosfilt(sos: np.ndarray, x: np.ndarray) -> np.ndarray:
    try:
        from scipy.signal import sosfilt

        return sosfilt(sos, x)
    except Exception:  # pragma: no cover - scipy is baked in
        y = x.astype(np.float64)
        for b0, b1, b2, _, a1, a2 in sos:
            out = np.empty_like(y)
            z1 = z2 = 0.0
            for i, v in enumerate(y):
                w = v - a1 * z1 - a2 * z2
                out[i] = b0 * w + b1 * z1 + b2 * z2
                z2, z1 = z1, w
            y = out
        return y


def integrated_lufs(wav: np.ndarray, sample_rate: int) -> float:
    """Gated integrated loudness (LUFS) of a mono waveform in [-1, 1]."""
    x = np.asarray(wav, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("integrated_lufs expects mono audio")
    y = _sosfilt(_k_weighting_sos(float(sample_rate)), x)

    block = int(round(0.400 * sample_rate))
    hop = block // 4  # 75% overlap
    if len(y) < block:
        ms = np.asarray([np.mean(np.square(y))]) if len(y) else np.asarray([0.0])
    else:
        n_blocks = 1 + (len(y) - block) // hop
        idx = np.arange(block)[None, :] + hop * np.arange(n_blocks)[:, None]
        ms = np.mean(np.square(y[idx]), axis=1)

    loud = -0.691 + 10.0 * np.log10(np.maximum(ms, 1e-20))
    # absolute gate
    keep = loud > -70.0
    if not np.any(keep):
        return -70.0
    # relative gate: -10 LU below the absolute-gated mean
    ref = -0.691 + 10.0 * np.log10(np.mean(ms[keep]))
    keep &= loud > (ref - 10.0)
    if not np.any(keep):
        return -70.0
    return float(-0.691 + 10.0 * np.log10(np.mean(ms[keep])))


def loudness_normalize(
    wav: np.ndarray, sample_rate: int, target_lufs: float = -23.0,
    peak_ceiling: float = 0.99,
) -> np.ndarray:
    """Gain the waveform to ``target_lufs`` (EBU R128 style).

    Mirrors ffmpeg-normalize's default behavior (target -23 LUFS) with a
    simple peak ceiling instead of a limiter: if the loudness gain would
    clip, the gain is reduced to keep |y| <= peak_ceiling (ffmpeg's
    linear mode does the same).
    """
    lufs = integrated_lufs(wav, sample_rate)
    gain = np.power(10.0, (target_lufs - lufs) / 20.0)
    peak = float(np.max(np.abs(wav))) if len(wav) else 0.0
    if peak * gain > peak_ceiling and peak > 0:
        gain = peak_ceiling / peak
    return (np.asarray(wav, dtype=np.float32) * np.float32(gain)).astype(np.float32)
