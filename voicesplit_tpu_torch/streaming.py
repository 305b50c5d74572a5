"""Chunked low-latency streaming separation (PyTorch counterpart of
`voicesplit_tpu/streaming.py`).

A fixed-shape chunk step that carries all state explicitly:

- **STFT**: an input sample tail of ``n_fft − hop`` gives the frame overlap;
  each chunk computes exactly ``C`` new frames (no center padding
  mid-stream), by index framing and the float32 forward-DFT bases.
- **Conv stack**: features are computed over a sliding window of
  ``ctx_left + ctx_right + C`` spectrogram frames kept in the state; the
  emitted frames lag the input by ``ctx_right`` frames (the lookahead).
- **LSTM**: the streaming `MaskNet`'s forward-only carry ``(h, c)`` threads
  through the chunks (one `lstm_fwd` launch a chunk on the card).
- **iSTFT**: weighted overlap-add with an ``n_fft − hop`` carry; samples are
  divided by the hop-periodic steady-state window-sumsquare envelope.

Algorithmic latency = ``ctx_right·hop + (n_fft − hop)`` samples: with the
symmetric convs 65·160 + 1040 = 11440 (715 ms at 16 kHz), with
``model.causal`` (no lookahead) 1040 (65 ms).

The chunk step runs eagerly under ``torch.inference_mode``, on the
separator's device (the CUDA card unless the caller names the CPU).  The
state is float32 whatever the model's compute dtype; the LSTM carry is
rounded to the compute dtype where the model takes it in, as in JAX.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.device import DeviceLike, resolve_device
from voicesplit_tpu_torch.dsp.normalize import amp_to_db, db_to_amp, denormalize_db, normalize_db
from voicesplit_tpu_torch.dsp.processor import AudioProcessor
from voicesplit_tpu_torch.dsp.stft import _constant, _istft_basis, _stft_basis, overlap_add
from voicesplit_tpu_torch.dsp.windows import get_window, pad_center
from voicesplit_tpu_torch.models.masknet import MaskNet


@dataclass
class StreamState:
    """Everything a stream carries between chunks, float32 on the device."""

    sample_tail: torch.Tensor  # [B, n_fft - hop] input overlap
    spec_hist: torch.Tensor  # [B, ctx_left + ctx_right, F] normalized spec history
    phase_hist: torch.Tensor  # [B, ctx_left + ctx_right, F]
    lstm_h: torch.Tensor  # [B, H]
    lstm_c: torch.Tensor  # [B, H]
    ola_tail: torch.Tensor  # [B, n_fft - hop] overlap-add carry


def _steady_envelope(n_fft: int, hop: int, win_length: int, window: str) -> np.ndarray:
    """Hop-periodic interior window-sumsquare: env[i] = Σ_k w²[i + k·hop]."""
    w2 = pad_center(get_window(window, win_length), n_fft) ** 2
    env = np.zeros(hop, np.float64)
    for i in range(hop):
        env[i] = w2[i::hop].sum()
    return np.maximum(env, 1e-10).astype(np.float32)


class StreamingSeparator:
    """Fixed-chunk streaming inference over a streaming `MaskNet`
    (`make_masknet(config, streaming=True)`, weights loaded).  The model is
    put in eval mode.  `chunk_frames` sets the block size: larger chunks
    mean fewer launches a second of audio and more buffering latency."""

    def __init__(
        self,
        config: Config,
        model: MaskNet,
        chunk_frames: int = 50,
        synthesis_window: str = "hann",
        device: DeviceLike = None,
    ):
        if config.audio.backend != "voicefilter":
            # the chunk step inlines the voicefilter backend's dB normalization;
            # a wavernn / waveglow model fed those specs would give garbage
            raise NotImplementedError(
                "StreamingSeparator supports the 'voicefilter' audio backend "
                f"only (got {config.audio.backend!r})"
            )
        if not model.streaming:
            raise ValueError("StreamingSeparator needs a streaming model (forward-only LSTM)")
        self.config = config
        self.device = resolve_device(device)
        self.model = model.eval()
        self.ap = p = AudioProcessor(config.audio, synthesis_window, self.device)
        self.n_fft, self.hop, self.win = p.n_fft, p.hop_length, p.win_length
        self.F = p.num_freq
        self.C = chunk_frames
        # (left, right) frames each emitted frame needs; right is 0 causal
        self.ctx_left = model.conv_context_left
        self.ctx_right = model.conv_context_right
        self.ctx = model.conv_context
        self.hist_frames = self.ctx_left + self.ctx_right
        self.chunk_samples = self.C * self.hop
        self.latency_samples = self.ctx_right * self.hop + (self.n_fft - self.hop)

        # ordinary tensors (made outside inference mode), cached by dsp/stft.py
        self._fwd_cos, self._fwd_sin = _stft_basis(self.n_fft, self.win, "hann", self.device)
        self._inv_cos, self._inv_sin = _istft_basis(
            self.n_fft, self.win, synthesis_window, None, self.device)
        env = _steady_envelope(self.n_fft, self.hop, self.win, synthesis_window)
        self._env = _constant(np.tile(env, self.C), self.device)
        self._frame_idx = _constant(
            (np.arange(self.C) * self.hop)[:, None] + np.arange(self.n_fft)[None, :], self.device)

    def init_state(self, batch_size: int) -> StreamState:
        B, H = batch_size, self.model.lstm.hidden

        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        return StreamState(
            sample_tail=z(B, self.n_fft - self.hop),
            spec_hist=z(B, self.hist_frames, self.F),
            phase_hist=z(B, self.hist_frames, self.F),
            lstm_h=z(B, H),
            lstm_c=z(B, H),
            ola_tail=z(B, self.n_fft - self.hop),
        )

    def _chunk_step(
        self, state: StreamState, samples: torch.Tensor, emb: torch.Tensor
    ) -> Tuple[StreamState, torch.Tensor]:
        """``samples [B, C·hop]`` in → ``[B, C·hop]`` separated out (delayed)."""
        C, ctx, hop, n_fft = self.C, self.ctx_left, self.hop, self.n_fft
        ap = self.ap

        # STFT of the C new frames
        buf = torch.cat([state.sample_tail, samples], dim=-1)
        frames = buf[:, self._frame_idx]  # [B, C, n_fft]
        re = frames @ self._fwd_cos
        im = frames @ self._fwd_sin
        mag = torch.sqrt(re * re + im * im + 1e-30)
        phase_new = torch.atan2(im, re)
        spec_new = normalize_db(amp_to_db(mag) - ap.ref_level_db, ap.min_level_db)

        # conv features over the sliding window: the C frames lagging by ctx_right
        window = torch.cat([state.spec_hist, spec_new], dim=1)  # [B, hist + C, F]
        feats = self.model.conv_features(window)[:, ctx : ctx + C]

        # the LSTM head with its carry
        mask, (h, c) = self.model.mask_head(feats, emb, lstm_carry=(state.lstm_h, state.lstm_c))

        # spec and phase of the emitted (lagged) frames
        phases = torch.cat([state.phase_hist, phase_new], dim=1)
        est = mask * window[:, ctx : ctx + C]
        phase_out = phases[:, ctx : ctx + C]

        # iSTFT with the overlap-add carry
        S = db_to_amp(denormalize_db(est, ap.min_level_db) + ap.ref_level_db)
        out_frames = (S * torch.cos(phase_out)) @ self._inv_cos + (
            S * torch.sin(phase_out)) @ self._inv_sin  # [B, C, n_fft]
        ola = overlap_add(out_frames, hop)  # [B, C·hop + n_fft - hop]
        ola = torch.cat([ola[:, : n_fft - hop] + state.ola_tail, ola[:, n_fft - hop :]], dim=-1)
        emitted = ola[:, : C * hop] / self._env

        new_state = StreamState(
            sample_tail=buf[:, -(n_fft - hop):].float(),
            spec_hist=window[:, C:].float(),
            phase_hist=phases[:, C:].float(),
            lstm_h=h.float(),
            lstm_c=c.float(),
            ola_tail=ola[:, C * hop :].float(),
        )
        return new_state, emitted

    def process_chunk(self, state: StreamState, samples, emb) -> Tuple[StreamState, torch.Tensor]:
        """One streaming step; `samples` must be ``[B, chunk_samples]``
        (numpy or a tensor), `emb` ``[B, emb]``."""
        samples = torch.as_tensor(samples, dtype=torch.float32, device=self.device)
        if samples.shape[-1] != self.chunk_samples:
            raise ValueError(
                f"chunk must be {self.chunk_samples} samples, got {samples.shape[-1]}"
            )
        emb = torch.as_tensor(emb, dtype=torch.float32, device=self.device)
        with torch.inference_mode():
            return self._chunk_step(state, samples, emb)

    def separate(self, wav: np.ndarray, emb: np.ndarray) -> np.ndarray:
        """Stream a whole ``[B, L]`` signal chunk by chunk, compensating the
        pipeline latency; the output is aligned to the input."""
        wav = np.atleast_2d(np.asarray(wav, np.float32))
        B, L = wav.shape
        cs = self.chunk_samples
        pad = (-L) % cs + self.latency_samples + cs
        padded = np.concatenate([wav, np.zeros((B, pad), np.float32)], axis=-1)
        state = self.init_state(B)
        outs = []
        for i in range(padded.shape[-1] // cs):
            state, out = self.process_chunk(state, padded[:, i * cs : (i + 1) * cs], emb)
            outs.append(out)
        full = torch.cat(outs, dim=-1).cpu().numpy()
        return full[:, self.latency_samples : self.latency_samples + L]
