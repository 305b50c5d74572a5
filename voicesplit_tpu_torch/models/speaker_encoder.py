"""Speaker d-vectors (counterpart of `voicesplit_tpu/models/speaker_encoder.py`).

- `SpeakerEncoder`: the GE2E d-vector encoder the reference extracts its
  embeddings with (3 x LSTM(40 mels → 768) over windows of 80 mel frames at
  stride 40, the last frame projected to 256, L2-normalized per window,
  mean over windows), and with `make_corentinj_encoder` the CorentinJ
  Real-Time-Voice-Cloning topology.  Windows are folded into the batch, so
  one `lstm_fwd` launch a layer embeds every window of a batch.
- `load_torch_state_dict` / `load_corentinj_state_dict`: the reference's
  ``embedder.pt`` and CorentinJ's ``pretrained.pt`` state dicts → the
  port's `SpeakerEncoder` state dict.
- `corentinj_mel`: CorentinJ's linear-power mel frontend (host numpy).
- `spectral_dvector`: a training-free, signal-derived d-vector; online mixing
  (`data/online.py`, ``emb_mode="spectral"``) conditions on it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from voicesplit_tpu_torch.device import DeviceLike, resolve_device
from voicesplit_tpu_torch.dsp.mel import mel_filterbank
from voicesplit_tpu_torch.models.lstm import UniLSTM


class SpeakerEncoder(nn.Module):
    """d-vector extractor: mel ``[B, n_mels, T]`` → embedding ``[B, emb_dim]``.

    As the JAX module (`models/speaker_encoder.py:28-73`): the ``n_win``
    windows of `window` frames at `stride` are folded into the batch
    (``[B·n_win, window, n_mels]``), go through `lstm_layers` `UniLSTM`
    layers ``lstm{i}``, the top layer's last frame through ``proj`` (a
    ReLU after it with `proj_relu`), each window L2-normalized, then the
    mean over windows, renormalized with `final_renorm`.  Parameters in
    float32, computed in `compute_dtype`.  The defaults are the GE2E
    topology the reference uses."""

    def __init__(
        self,
        num_mels: int = 40,
        lstm_hidden: int = 768,
        lstm_layers: int = 3,
        emb_dim: int = 256,
        window: int = 80,
        stride: int = 40,
        proj_relu: bool = False,
        final_renorm: bool = False,
        compute_dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_mels, self.lstm_hidden, self.lstm_layers = num_mels, lstm_hidden, lstm_layers
        self.emb_dim, self.window, self.stride = emb_dim, window, stride
        self.proj_relu, self.final_renorm = proj_relu, final_renorm
        self.compute_dtype = compute_dtype
        for i in range(lstm_layers):
            self.add_module(
                f"lstm{i}", UniLSTM(num_mels if i == 0 else lstm_hidden, lstm_hidden, compute_dtype)
            )
        self.proj = nn.Linear(lstm_hidden, emb_dim)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        B, M, T = mel.shape
        if T < self.window:
            raise ValueError(f"need at least {self.window} mel frames, got {T}")
        cd = self.compute_dtype
        wins = mel.unfold(2, self.window, self.stride)  # [B, M, n_win, W]
        n_win = wins.shape[2]
        x = wins.permute(0, 2, 3, 1).reshape(B * n_win, self.window, M).to(cd)
        for i in range(self.lstm_layers):
            x, _ = getattr(self, f"lstm{i}")(x)
        x = x[:, -1, :]  # the last frame (the top layer's final h)
        x = nn.functional.linear(x, self.proj.weight.to(cd), self.proj.bias.to(cd))
        if self.proj_relu:
            x = torch.relu(x)
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)
        out = x.reshape(B, n_win, self.emb_dim).mean(dim=1)
        if self.final_renorm:
            out = out / (torch.linalg.vector_norm(out, dim=-1, keepdim=True) + 1e-8)
        return out


def make_corentinj_encoder(
    compute_dtype: torch.dtype = torch.float32, device: DeviceLike = None
) -> SpeakerEncoder:
    """The CorentinJ Real-Time-Voice-Cloning encoder (3 x LSTM(40 → 256),
    Linear(256 → 256) + ReLU, 160-frame partials at 50% overlap, per-partial
    L2 norm, mean, renorm) on `device` (the CUDA card by default)."""
    return SpeakerEncoder(
        num_mels=40, lstm_hidden=256, lstm_layers=3, emb_dim=256, window=160, stride=80,
        proj_relu=True, final_renorm=True, compute_dtype=compute_dtype,
    ).to(resolve_device(device))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _lstm_layers_from_torch(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """``lstm.{weight_ih,weight_hh}_l{k} [4H, in]`` and the two biases of a
    ``torch.nn.LSTM`` (gate order [i, f, g, o], the port's) → ``lstm{k}.fwd_w_ih
    [in, 4H]``, ``fwd_w_hh [H, 4H]`` and ``fwd_b`` (the biases summed)."""
    out: Dict[str, torch.Tensor] = {}
    k = 0
    while f"lstm.weight_ih_l{k}" in state_dict:
        out[f"lstm{k}.fwd_w_ih"] = _f32(np.asarray(state_dict[f"lstm.weight_ih_l{k}"]).T)
        out[f"lstm{k}.fwd_w_hh"] = _f32(np.asarray(state_dict[f"lstm.weight_hh_l{k}"]).T)
        out[f"lstm{k}.fwd_b"] = _f32(
            np.asarray(state_dict[f"lstm.bias_ih_l{k}"]) + np.asarray(state_dict[f"lstm.bias_hh_l{k}"])
        )
        k += 1
    if k == 0:
        raise ValueError("no lstm.weight_ih_l0: not a speaker encoder state dict")
    return out


def load_torch_state_dict(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """The reference's GE2E ``embedder.pt`` state dict (``lstm.*`` of a
    ``torch.nn.LSTM``, ``proj.linear_layer.{weight, bias}``) → the state
    dict of a `SpeakerEncoder` of its topology."""
    sd = _lstm_layers_from_torch(state_dict)
    sd["proj.weight"] = _f32(state_dict["proj.linear_layer.weight"])
    sd["proj.bias"] = _f32(state_dict["proj.linear_layer.bias"])
    return sd


def load_corentinj_state_dict(state_dict: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """CorentinJ's ``encoder/pretrained.pt`` state dict (pass the payload's
    ``model_state``: ``lstm.*`` and ``linear.{weight, bias}``; the GE2E
    loss's ``similarity_weight`` / ``similarity_bias`` are training-only and
    ignored) → the state dict of `make_corentinj_encoder`."""
    sd = _lstm_layers_from_torch(state_dict)
    sd["proj.weight"] = _f32(state_dict["linear.weight"])
    sd["proj.bias"] = _f32(state_dict["linear.bias"])
    return sd


def corentinj_mel(
    wav: np.ndarray, sample_rate: int = 16000, n_fft: int = 400,
    hop_length: int = 160, n_mels: int = 40,
) -> np.ndarray:
    """CorentinJ's mel frontend: linear-power 40-band mel (no log), 25 ms
    window / 10 ms hop at 16 kHz → ``[n_mels, T]`` (host numpy)."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    if wav.size < n_fft:
        wav = np.pad(wav, (0, n_fft - wav.size))
    n_frames = 1 + (wav.size - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = wav[idx] * np.hanning(n_fft)[None, :].astype(np.float32)
    mag2 = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # [T, F] power
    fb = mel_filterbank(sample_rate, n_fft, n_mels)  # [n_mels, F]
    return (mag2 @ fb.T).T.astype(np.float32)  # [n_mels, T]


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
