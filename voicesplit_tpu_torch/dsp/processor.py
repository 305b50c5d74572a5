"""Audio-processor facade: one class, three backend behaviors (PyTorch
counterpart of `voicesplit_tpu/dsp/processor.py`).

The reference wraps three audio processors behind
`WrapperAudioProcessor` (`utils/audio_processor.py:19-59`):

- ``voicefilter`` (default) — 16 kHz, n_fft 1200 / hop 160 / win 400,
  dB-normalized against ``min_level_db`` (`:440-567`);
- ``wavernn`` — ms-based STFT parameters, preemphasis, optional mel
  spectrograms, symmetric or clipped normalization (`:61-336`);
- ``waveglow`` — mel extraction with natural-log dynamic-range compression
  (`:338-438`).

The shared DSP core is `dsp/stft.py` (float32 basis matmuls on the
processor's device); this class binds each backend's normalization around
it.  The batch methods take and return tensors on the processor's device
(``wav2spec_batch``, the differentiable ``spec2wav_batch``, ``mel_batch``,
``griffin_lim_batch``, ``mag_to_mel``, ``mel_to_linear``); the host methods
take and return numpy arrays, like the JAX package's (``wav2spec``,
``spec2wav``, which runs Griffin-Lim when given no phase, ``get_mel``,
``get_mel_bucketed``, ``load_wav``, ``save_wav``).
"""

from __future__ import annotations

from functools import cached_property
from typing import Optional, Tuple

import numpy as np
import torch

from voicesplit_tpu_torch.config import AudioConfig, Config
from voicesplit_tpu_torch.device import DeviceLike, resolve_device
from voicesplit_tpu_torch.dsp import audio_io
from voicesplit_tpu_torch.dsp.griffin_lim import griffin_lim
from voicesplit_tpu_torch.dsp.mel import mel_filterbank
from voicesplit_tpu_torch.dsp.normalize import (
    amp_to_db,
    db_to_amp,
    denormalize_db,
    inv_preemphasis,
    normalize_db,
    preemphasis,
)
from voicesplit_tpu_torch.dsp.stft import _constant, istft_magphase, num_frames, stft, stft_magphase
from voicesplit_tpu_torch.utils.profiling import span


class AudioProcessor:
    """Backend-dispatching audio front-end.

    `synthesis_window` selects the iSTFT window of the mixed-phase
    inversion: matched ``hann`` by default (the reference synthesizes its
    training path with symmetric hamming, `utils/audio_processor.py:509`)."""

    def __init__(
        self, audio: AudioConfig, synthesis_window: str = "hann", device: DeviceLike = None
    ):
        if audio.backend not in ("voicefilter", "wavernn", "waveglow"):
            raise ValueError(f"unknown audio backend {audio.backend!r}")
        self.config = audio
        self.backend = audio.backend
        self.params = p = audio.active
        self.synthesis_window = synthesis_window
        self.device = resolve_device(device)
        self.sample_rate = p.sample_rate
        self.n_fft = p.n_fft
        self.hop_length = p.hop_length
        self.win_length = p.win_length
        self.num_freq = p.num_freq
        self.min_level_db = float(getattr(p, "min_level_db", -100.0))
        self.ref_level_db = float(getattr(p, "ref_level_db", 20.0))
        self.griffin_lim_iters = int(getattr(p, "griffin_lim_iters", 60))
        self.power = float(getattr(p, "power", 1.5))
        self.preemph = float(getattr(p, "preemphasis", 0.0)) if self.backend == "wavernn" else 0.0
        self.mel_spec = bool(audio.mel_spec)

    # --- derived constants ---

    @cached_property
    def mel_basis(self) -> np.ndarray:
        """``[n_mels, F]`` float32 (numpy)."""
        p = self.params
        if self.backend == "voicefilter":
            # reference `utils/audio_processor.py:456-458`: full band, 40 mels
            return mel_filterbank(self.sample_rate, self.n_fft, p.num_mels)
        if self.backend == "wavernn":
            return mel_filterbank(self.sample_rate, self.n_fft, p.num_mels, p.mel_fmin, p.mel_fmax)
        return mel_filterbank(self.sample_rate, self.n_fft, p.n_mel_channels, p.mel_fmin, p.mel_fmax)

    @cached_property
    def _mel_t(self) -> torch.Tensor:
        """The mel basis transposed, ``[F, n_mels]``, on the device."""
        return _constant(np.ascontiguousarray(self.mel_basis.T), self.device)

    @cached_property
    def _mel_pinv_t(self) -> torch.Tensor:
        """The basis' pseudo-inverse (numpy, as JAX) transposed, ``[n_mels, F]``."""
        pinv = np.linalg.pinv(self.mel_basis).astype(np.float32)  # [F, n_mels]
        return _constant(np.ascontiguousarray(pinv.T), self.device)

    # --- batch transforms (tensors on self.device) ---

    def wav2spec_batch(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Waveforms ``[..., L]`` → ``(spec, phase)`` each ``[..., T, F]``.

        voicefilter: ``normalize(amp_to_db(|STFT|) - ref_level_db)`` and the
        raw phase.  wavernn / waveglow apply their own normalization, and
        with ``mel_spec`` return mel spectrograms ``[..., T, n_mels]``."""
        with span("voicesplit.wav2spec"):
            if self.preemph != 0.0:
                y = preemphasis(y, self.preemph)
            mag, phase = stft_magphase(y, self.n_fft, self.hop_length, self.win_length)
            if self.backend == "voicefilter":
                S = amp_to_db(mag) - self.ref_level_db
                return normalize_db(S, self.min_level_db), phase
            if self.mel_spec:
                mag = self.mag_to_mel(mag)
            if self.backend == "waveglow":
                # natural-log magnitudes, ln(max(x, 1e-5)), no dB normalization
                # (reference `utils/audio.py:49-61`)
                return torch.log(torch.clamp(mag, min=1e-5)), phase
            S = self._amp_to_db_floored(mag) - self.ref_level_db
            return self._normalize_generic(S), phase

    def mag_to_mel(self, mag: torch.Tensor) -> torch.Tensor:
        """Linear magnitudes ``[..., T, F]`` → mel ``[..., T, n_mels]``."""
        return torch.matmul(mag, self._mel_t)

    def mel_to_linear(self, mel: torch.Tensor) -> torch.Tensor:
        """Pseudo-inverse mel → linear, floored at 1e-10 (reference
        `_mel_to_linear`, `utils/audio_processor.py:125-127`)."""
        return torch.clamp(torch.matmul(mel, self._mel_pinv_t), min=1e-10)

    def _magnitude(self, spec: torch.Tensor) -> torch.Tensor:
        """A backend's normalized spectrogram back to linear magnitudes
        ``[..., T, F]`` (mel backends through `mel_to_linear`)."""
        if self.backend == "voicefilter":
            return db_to_amp(denormalize_db(spec, self.min_level_db) + self.ref_level_db)
        if self.backend == "waveglow":
            mag = torch.exp(spec)  # inverse dynamic-range compression
        else:
            mag = db_to_amp(self._denormalize_generic(spec) + self.ref_level_db)
        return self.mel_to_linear(mag) if self.mel_spec else mag

    def spec2wav_batch(
        self, spec: torch.Tensor, phase: torch.Tensor, length: Optional[int] = None
    ) -> torch.Tensor:
        """Differentiable mixed-phase inversion ``[..., T, F]`` → ``[..., L]``:
        the backend's denormalization, then the iSTFT with the given
        (mixture) phase; wavernn undoes its preemphasis."""
        with span("voicesplit.spec2wav"):
            wav = istft_magphase(
                self._magnitude(spec), phase, self.n_fft, self.hop_length, self.win_length,
                window=self.synthesis_window, length=length,
            )
            if self.preemph != 0.0:
                wav = inv_preemphasis(wav, self.preemph)
            return wav

    def mel_batch(self, y: torch.Tensor) -> torch.Tensor:
        """GE2E mels ``log10(mel @ |STFT|² + 1e-6)`` as ``[..., n_mels, T]``
        (reference `get_mel`, `utils/audio_processor.py:460-467`)."""
        real, imag = stft(y, self.n_fft, self.hop_length, self.win_length)
        mel = torch.matmul(real * real + imag * imag, self._mel_t)
        return torch.log10(mel + 1e-6).transpose(-1, -2)

    def griffin_lim_batch(self, mag: torch.Tensor, angles: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Griffin-Lim over ``[..., T, F]`` magnitudes from `angles` (default:
        `griffin_lim_angles`' draw; `dsp/griffin_lim.py`)."""
        return griffin_lim(
            mag, self.n_fft, self.hop_length, self.win_length,
            n_iters=self.griffin_lim_iters, angles=angles,
        )

    # --- wavernn / waveglow normalization ---

    def _amp_to_db_floored(self, x: torch.Tensor) -> torch.Tensor:
        # wavernn floors at db_to_amp(min_level_db) (reference `:184-186`)
        min_level = float(np.exp(self.min_level_db / 20 * np.log(10)))
        return 20.0 * torch.log10(torch.clamp(x, min=min_level))

    def _normalize_generic(self, S: torch.Tensor) -> torch.Tensor:
        p = self.params
        if not getattr(p, "signal_norm", True):
            return S
        max_norm = float(getattr(p, "max_norm", 1.0))
        S_norm = (S - self.min_level_db) / -self.min_level_db
        if getattr(p, "symmetric_norm", False):
            S_norm = 2 * max_norm * S_norm - max_norm
            if getattr(p, "clip_norm", True):
                S_norm = torch.clamp(S_norm, -max_norm, max_norm)
        else:
            S_norm = max_norm * S_norm
            if getattr(p, "clip_norm", True):
                S_norm = torch.clamp(S_norm, 0.0, max_norm)
        return S_norm

    def _denormalize_generic(self, S: torch.Tensor) -> torch.Tensor:
        p = self.params
        if not getattr(p, "signal_norm", True):
            return S
        max_norm = float(getattr(p, "max_norm", 1.0))
        if getattr(p, "symmetric_norm", False):
            if getattr(p, "clip_norm", True):
                S = torch.clamp(S, -max_norm, max_norm)
            return (S + max_norm) * -self.min_level_db / (2 * max_norm) + self.min_level_db
        if getattr(p, "clip_norm", True):
            S = torch.clamp(S, 0.0, max_norm)
        return S * -self.min_level_db / max_norm + self.min_level_db

    # --- host conveniences (numpy in / numpy out) ---

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def wav2spec(self, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``[L]`` → ``(spec [T, F], phase [T, F])``."""
        with torch.inference_mode():
            spec, phase = self.wav2spec_batch(self._tensor(y))
        return spec.cpu().numpy(), phase.cpu().numpy()

    def get_spec_from_audio(self, y: np.ndarray):
        return self.wav2spec(y)

    def get_spec_from_audio_path(self, path: str):
        return self.wav2spec(self.load_wav(path))

    def spec2wav(self, spec: np.ndarray, phase: Optional[np.ndarray] = None) -> np.ndarray:
        """``[T, F]`` → waveform.  With a phase: the mixed-phase iSTFT.
        Without: Griffin-Lim on ``S**power`` (reference `spec2wav`,
        `utils/audio_processor.py:483-496`)."""
        with torch.inference_mode():
            if phase is not None:
                wav = self.spec2wav_batch(self._tensor(spec), self._tensor(phase))
            else:
                mag = self._magnitude(self._tensor(spec)) ** self.power
                wav = self.griffin_lim_batch(mag)
                if self.preemph != 0.0:
                    wav = inv_preemphasis(wav, self.preemph)
        return wav.cpu().numpy()

    def inv_spectrogram(self, spec: np.ndarray, phase: Optional[np.ndarray] = None) -> np.ndarray:
        return self.spec2wav(spec, phase)

    def get_mel(self, y: np.ndarray) -> np.ndarray:
        """``[L]`` → log-mel ``[n_mels, T]`` for the GE2E speaker encoder."""
        with torch.inference_mode():
            return self.mel_batch(self._tensor(y)).cpu().numpy()

    def get_mel_bucketed(self, y: np.ndarray, bucket_s: float = 1.0) -> np.ndarray:
        """`get_mel` of the wav zero-padded to the next ``bucket_s`` grid,
        cut to the true length's frames (the JAX package pads so that one
        compiled program serves each bucket; here it keeps the same
        numbers: the last frames see the zero pad)."""
        y = np.asarray(y, np.float32)
        L = len(y)
        step = max(1, int(round(self.sample_rate * bucket_s)))
        Lb = max(step, -(-L // step) * step)
        if Lb != L:
            y = np.pad(y, (0, Lb - L))
        return self.get_mel(y)[:, : self.frames_for(L)]

    def load_wav(self, path: str) -> np.ndarray:
        wav = audio_io.load_wav(path, self.sample_rate)
        if self.backend == "wavernn" and getattr(self.params, "do_trim_silence", False):
            margin = int(self.sample_rate * 0.1)
            if len(wav) > 2 * margin:  # clips under 0.2 s cannot afford the margin
                wav = wav[margin:-margin]
            wav, _ = audio_io.trim_silence(wav, top_db=40, frame_length=1024, hop_length=256)
        return wav

    def save_wav(self, wav: np.ndarray, path: str) -> None:
        audio_io.save_wav(wav, path, self.sample_rate)

    # --- wavernn vocoder utilities (reference `utils/audio_processor.py:282-335`) ---

    @staticmethod
    def mulaw_encode(wav: np.ndarray, qc: int) -> np.ndarray:
        """μ-law companding and quantization to ``2^qc`` levels."""
        mu = 2**qc - 1
        signal = np.sign(wav) * np.log1p(mu * np.abs(wav)) / np.log1p(mu)
        return np.floor((signal + 1) / 2 * mu + 0.5)

    @staticmethod
    def mulaw_decode(wav: np.ndarray, qc: int) -> np.ndarray:
        mu = 2**qc - 1
        return np.sign(wav) / mu * ((1 + mu) ** np.abs(wav) - 1)

    @staticmethod
    def encode_16bits(x: np.ndarray) -> np.ndarray:
        return np.clip(x * 2**15, -(2**15), 2**15 - 1).astype(np.int16)

    @staticmethod
    def quantize(x: np.ndarray, bits: int) -> np.ndarray:
        return (x + 1.0) * (2**bits - 1) / 2

    @staticmethod
    def dequantize(x: np.ndarray, bits: int) -> np.ndarray:
        return 2 * x / (2**bits - 1) - 1

    def find_endpoint(
        self, wav: np.ndarray, threshold_db: float = -40.0, min_silence_sec: float = 0.8
    ) -> int:
        """First index after which the signal stays below `threshold_db`."""
        window = int(self.sample_rate * min_silence_sec)
        hop = max(1, window // 4)
        threshold = float(db_to_amp(torch.tensor(threshold_db, dtype=torch.float32)))
        for x in range(hop, max(hop + 1, len(wav) - window), hop):
            if np.max(np.abs(wav[x : x + window])) < threshold:
                return x + hop
        return len(wav)

    def frames_for(self, n_samples: int) -> int:
        """Spectrogram frames of a waveform of `n_samples`."""
        return num_frames(n_samples, self.n_fft, self.hop_length)


def make_audio_processor(
    config: Config, synthesis_window: str = "hann", device: DeviceLike = None
) -> AudioProcessor:
    """The processor of ``config.audio.backend`` (the reference's
    `WrapperAudioProcessor`, `utils/audio_processor.py:19-31`)."""
    return AudioProcessor(config.audio, synthesis_window=synthesis_window, device=device)
