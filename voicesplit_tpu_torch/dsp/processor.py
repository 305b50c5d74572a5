"""Audio front-end for the voicefilter backend (PyTorch counterpart of
`voicesplit_tpu/dsp/processor.py`).

16 kHz, n_fft 1200 / hop 160 / win 400, dB-normalized against
``min_level_db`` (reference `utils/audio_processor.py:440-567`).  The batch
methods take and return tensors on the processor's device; the host
methods take and return numpy arrays, like the JAX package's.

Only what the serving path needs is here: Griffin-Lim, mel spectrograms
and the wavernn / waveglow backends are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from voicesplit_tpu_torch.config import AudioConfig, Config
from voicesplit_tpu_torch.device import DeviceLike, resolve_device
from voicesplit_tpu_torch.dsp import audio_io
from voicesplit_tpu_torch.dsp.normalize import amp_to_db, db_to_amp, denormalize_db, normalize_db
from voicesplit_tpu_torch.dsp.stft import istft_magphase, num_frames, stft_magphase


class AudioProcessor:
    """voicefilter-backend spectrogram analysis and mixed-phase synthesis."""

    def __init__(
        self, audio: AudioConfig, synthesis_window: str = "hann", device: DeviceLike = None
    ):
        if audio.backend != "voicefilter":
            raise NotImplementedError(
                f"audio backend {audio.backend!r} is not yet ported (only voicefilter)"
            )
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
        self.min_level_db = float(p.min_level_db)
        self.ref_level_db = float(p.ref_level_db)

    # --- batch transforms (tensors on self.device) ---

    def wav2spec_batch(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Waveforms ``[..., L]`` → ``(norm_spec, phase)`` each ``[..., T, F]``:
        ``normalize(amp_to_db(|STFT|) - ref_level_db)`` and the raw phase."""
        mag, phase = stft_magphase(y, self.n_fft, self.hop_length, self.win_length)
        S = amp_to_db(mag) - self.ref_level_db
        return normalize_db(S, self.min_level_db), phase

    def spec2wav_batch(
        self, spec: torch.Tensor, phase: torch.Tensor, length: Optional[int] = None
    ) -> torch.Tensor:
        """Mixed-phase inversion ``[..., T, F]`` → ``[..., L]``: denormalize,
        dB→amp, iSTFT with the given (mixture) phase."""
        mag = db_to_amp(denormalize_db(spec, self.min_level_db) + self.ref_level_db)
        return istft_magphase(
            mag, phase, self.n_fft, self.hop_length, self.win_length,
            window=self.synthesis_window, length=length,
        )

    # --- host conveniences (numpy in / numpy out) ---

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def wav2spec(self, y: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """``[L]`` → ``(spec [T, F], phase [T, F])``."""
        with torch.inference_mode():
            spec, phase = self.wav2spec_batch(self._tensor(y))
        return spec.cpu().numpy(), phase.cpu().numpy()

    def spec2wav(self, spec: np.ndarray, phase: Optional[np.ndarray] = None) -> np.ndarray:
        """``[T, F]`` → waveform with the given phase."""
        if phase is None:
            raise NotImplementedError("Griffin-Lim phase estimation is not yet ported")
        with torch.inference_mode():
            wav = self.spec2wav_batch(self._tensor(spec), self._tensor(phase))
        return wav.cpu().numpy()

    def frames_for(self, n_samples: int) -> int:
        """Spectrogram frames of a waveform of `n_samples`."""
        return num_frames(n_samples, self.n_fft, self.hop_length)

    def load_wav(self, path: str) -> np.ndarray:
        return audio_io.load_wav(path, self.sample_rate)

    def save_wav(self, wav: np.ndarray, path: str) -> None:
        audio_io.save_wav(wav, path, self.sample_rate)


def make_audio_processor(
    config: Config, synthesis_window: str = "hann", device: DeviceLike = None
) -> AudioProcessor:
    return AudioProcessor(config.audio, synthesis_window=synthesis_window, device=device)
