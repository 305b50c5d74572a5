"""DSP front-end of the port: STFT/iSTFT, dB normalization and preemphasis,
Griffin-Lim, mel filterbanks, the three audio backends, loudness, wav IO."""

from voicesplit_tpu_torch.dsp.processor import AudioProcessor, make_audio_processor

__all__ = ["AudioProcessor", "make_audio_processor"]
