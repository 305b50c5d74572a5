"""Metrics/observability writer.

Same surface as the reference's `TensorboardWriter`
(`utils/tensorboard.py:30-59`): train-loss scalar, eval loss/SDR scalars,
mixed/target/estimated audio, spectrogram + mask + squared-error images —
plus a machine-readable `metrics.jsonl` stream (throughput in
audio-seconds/s included) that works even where tensorboardX isn't
installed (a copy of the JAX package's `voicesplit_tpu/utils/logging.py`;
tensorboardX is optional exactly as there).
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

try:
    from tensorboardX import SummaryWriter

    _HAS_TB = True
except Exception:  # pragma: no cover - environment without tensorboardX
    SummaryWriter = None
    _HAS_TB = False

try:  # tensorboardX add_audio needs soundfile, which may be absent
    import soundfile  # noqa: F401

    _HAS_AUDIO = True
except Exception:
    _HAS_AUDIO = False


def plot_spectrogram_to_numpy(spec: np.ndarray) -> np.ndarray:
    """Render a [T, F] spectrogram to an HWC uint8 image (matplotlib Agg),
    the reference's tensorboard image path (`utils/tensorboard.py:16-28`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(12, 3))
    im = ax.imshow(spec.T, aspect="auto", origin="lower", interpolation="none")
    plt.colorbar(im, ax=ax)
    plt.xlabel("Frames")
    plt.ylabel("Channels")
    plt.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    plt.close(fig)
    return data


class MetricsLogger:
    def __init__(
        self,
        log_dir: str,
        sample_rate: int = 16000,
        enable_tb: bool = True,
        enabled: bool = True,
    ):
        """``enabled=False`` makes every log call a no-op — used to gate
        ALL file writes (jsonl included, not just TB) to one process so
        several processes don't interleave appends in a shared log dir."""
        self.sample_rate = sample_rate
        self.enabled = enabled
        if not enabled:
            self.tb = None
            self._jsonl = None
            return
        os.makedirs(log_dir, exist_ok=True)
        self.tb = SummaryWriter(log_dir) if (_HAS_TB and enable_tb) else None
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_scalars(self, scalars: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self.tb:
            for k, v in scalars.items():
                self.tb.add_scalar(k, float(v), step)

    def log_training(self, loss: float, step: int, **extra) -> None:
        self.log_scalars({"train_loss": loss, **extra}, step)

    def log_evaluation(
        self,
        test_loss: float,
        sdr: float,
        step: int,
        mixed_wav: Optional[np.ndarray] = None,
        target_wav: Optional[np.ndarray] = None,
        est_wav: Optional[np.ndarray] = None,
        mixed_spec: Optional[np.ndarray] = None,
        target_spec: Optional[np.ndarray] = None,
        est_spec: Optional[np.ndarray] = None,
        est_mask: Optional[np.ndarray] = None,
    ) -> None:
        """Eval scalars + audio + images (reference `utils/tensorboard.py:38-59`)."""
        if not self.enabled:
            return
        self.log_scalars({"test_loss": test_loss, "SDR": sdr}, step)
        if not self.tb:
            return
        sr = self.sample_rate
        if _HAS_AUDIO:
            for name, wav in (
                ("mixed_wav", mixed_wav),
                ("target_wav", target_wav),
                ("estimated_wav", est_wav),
            ):
                if wav is not None:
                    peak = max(0.01, float(np.max(np.abs(wav))))
                    self.tb.add_audio(name, np.asarray(wav) / peak, step, sr)
        for name, spec in (
            ("data_mixed_spec", mixed_spec),
            ("data_target_spec", target_spec),
            ("result_estimated_spec", est_spec),
            ("result_estimated_mask", est_mask),
        ):
            if spec is not None:
                self.tb.add_image(
                    name, plot_spectrogram_to_numpy(np.asarray(spec)), step, dataformats="HWC"
                )
        if est_spec is not None and target_spec is not None:
            err = np.square(np.asarray(est_spec) - np.asarray(target_spec))
            self.tb.add_image(
                "result_estimation_error", plot_spectrogram_to_numpy(err), step, dataformats="HWC"
            )

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self.tb:
            self.tb.close()
