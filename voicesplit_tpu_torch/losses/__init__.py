"""Training losses: power-law compressed spectral loss and SI-SNR with PIT
(PyTorch counterparts of `voicesplit_tpu/losses`)."""

from voicesplit_tpu_torch.losses.power_law import power_law_compressed_loss
from voicesplit_tpu_torch.losses.si_snr import (
    sequence_mask,
    si_snr,
    si_snr_matrix,
    si_snr_with_pit,
)

__all__ = [
    "power_law_compressed_loss",
    "sequence_mask",
    "si_snr",
    "si_snr_matrix",
    "si_snr_with_pit",
]
