"""Speaker d-vectors (counterpart of `voicesplit_tpu/models/speaker_encoder.py`).

Only the training-free `spectral_dvector` is here, a numpy copy of the JAX
package's: online mixing (`data/online.py`, ``emb_mode="spectral"``)
conditions on it.  Not ported yet: the GE2E encoder and its weight import.
"""

from __future__ import annotations

import numpy as np

from voicesplit_tpu_torch.dsp.mel import mel_filterbank


def spectral_dvector(
    wav: np.ndarray,
    sample_rate: int = 16000,
    emb_dim: int = 256,
    n_mels: int = 40,
    n_fft: int = 512,
    hop_length: int = 160,
    seed: int = 1337,
) -> np.ndarray:
    """Training-free, signal-derived d-vector of one reference utterance.

    Stats-pooled log-mel envelope (gain-invariant per-band mean and per-band
    std), high-passed along the mel axis to strip the smooth spectrum shape
    that all speech shares and keep the speaker's formant structure, under a
    fixed seeded random projection to `emb_dim`, L2-normalized.  It lives in
    a signal feature space, so a model trained on it can condition on
    speakers never seen in training.  Host numpy.
    """
    wav = np.asarray(wav, np.float32).reshape(-1)
    # peak-normalize so the log floor (1e-6) bites the same bands at any
    # input gain
    wav = wav / (np.abs(wav).max() + 1e-8)
    if wav.size < n_fft:
        wav = np.pad(wav, (0, n_fft - wav.size))
    n_frames = 1 + (wav.size - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft)[None, :].astype(np.float32)
    mag2 = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [T, F]
    fb = mel_filterbank(sample_rate, n_fft, n_mels)  # [n_mels, F]
    logmel = np.log10(mag2 @ fb.T + 1e-6)  # [T, n_mels]

    mu = logmel.mean(axis=0)
    mu = mu - mu.mean()  # remove the overall gain
    sd = logmel.std(axis=0)

    def _mel_highpass(x: np.ndarray, k: int = 9) -> np.ndarray:
        pad = np.pad(x, (k // 2, k // 2), mode="edge")
        return x - np.convolve(pad, np.ones(k) / k, mode="valid")

    feat = np.concatenate([_mel_highpass(mu), _mel_highpass(sd)])
    feat = (feat - feat.mean()) / (feat.std() + 1e-8)

    proj = np.random.default_rng(seed).standard_normal(
        (emb_dim, feat.size)
    ).astype(np.float32) / np.sqrt(feat.size)
    v = proj @ feat.astype(np.float32)
    return (v / (np.linalg.norm(v) + 1e-8)).astype(np.float32)
