"""Validation loop: configured loss + SDR/SI-SNRi over a held-out set
(counterpart of `voicesplit_tpu/eval/validation.py`).

Capability of reference `validation()` (`utils/generic_utils.py:476-529`):
run the mask net over eval items, invert with the mixture phase, score with
the training criterion and SDR, and push one sample's audio/images to the
metrics logger.  With the "device" SDR backend the BSS_EVAL projection runs
batched on the card too, so only scalars cross to the host (the estimated
waveforms and spectrograms are fetched solely for the one logged sample);
the "host" backend is the reference's arrangement, one float64 numpy
projection per item.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from voicesplit_tpu_torch.data.dataset import BatchIterator
from voicesplit_tpu_torch.eval.metrics import (
    bss_eval_sdr,
    sdr_and_si_snri_batch,
    si_snr_improvement,
)
from voicesplit_tpu_torch.utils.logging import MetricsLogger


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def validate(
    eval_step: Callable[[Dict[str, np.ndarray]], Dict[str, torch.Tensor]],
    loader: BatchIterator,
    logger: Optional[MetricsLogger] = None,
    step: int = 0,
    max_items: Optional[int] = None,
    log_sample: bool = True,
    compute_sdr: bool = True,
    sdr_backend: str = "auto",
) -> Dict[str, float]:
    """Returns mean metrics: loss, si_snr, sdr, si_snri.

    `eval_step` is `train.make_eval_step`'s ``batch -> metrics``; it carries
    the model and decides the device.

    ``sdr_backend``: "host" = the per-item float64 numpy projection (exactly
    the reference's mir_eval-on-CPU arrangement, `generic_utils.py:509`);
    "device" = the batched projection on the device the eval step ran on
    (`metrics.sdr_and_si_snri_batch`, < 0.01 dB off the host values);
    "auto" picks "device" when the eval step ran on the card, else "host".
    ``log_sample``: with a logger, the first item's audio, spectrograms and
    mask go to it (`MetricsLogger.log_evaluation`).

    ``max_items`` caps the number of evaluated ITEMS (not batches).
    Per-item metrics (si_snr/sdr/si_snri) exclude the loader's pad
    duplicates exactly; the scalar loss is a per-batch mean weighted by
    true item count, so a padded final batch contributes its duplicated
    item's loss with slight extra weight inside that one batch mean.
    """
    if sdr_backend not in ("auto", "host", "device"):
        raise ValueError(f"sdr_backend must be auto, host or device, got {sdr_backend!r}")
    losses, loss_weights, snrs, sdrs, snris = [], [], [], [], []
    n_batches = loader.batches_per_epoch()
    if max_items is not None:
        n_batches = min(n_batches, -(-max_items // loader.batch_size))
    loader.load_state(type(loader.state)(seed=loader.state.seed))  # rewind
    first_logged = False
    n_seen = 0
    for _ in range(n_batches):
        host_batch = next(loader)
        # Valid-item count: the loader pads the final partial batch to keep
        # shapes static (`pad_last`); padded duplicates are trimmed from all
        # per-item metrics and loss weighting below.
        n_valid = int(host_batch.get("n_valid", loader.batch_size))
        if max_items is not None:
            n_valid = min(n_valid, max_items - n_seen)
        n_seen += n_valid
        out = eval_step({k: v for k, v in host_batch.items() if k != "n_valid"})
        est_wav = out["est_wav"]
        losses.append(float(out["loss"]))
        loss_weights.append(n_valid)
        snrs.extend(_np(out["si_snr"])[:n_valid].tolist())
        if compute_sdr:
            backend = sdr_backend
            if backend == "auto":
                backend = "device" if est_wav.device.type == "cuda" else "host"
            if backend == "device":
                dev = est_wav.device
                with torch.no_grad():
                    sdr_b, snri_b = sdr_and_si_snri_batch(
                        est_wav,
                        torch.as_tensor(host_batch["target_wav"], device=dev),
                        torch.as_tensor(host_batch["mixed_wav"], device=dev),
                        torch.as_tensor(host_batch["wav_len"], device=dev),
                    )
                sdrs.extend(_np(sdr_b)[:n_valid].tolist())
                snris.extend(_np(snri_b)[:n_valid].tolist())
            else:
                # host path: waveforms come straight from the loader's numpy
                # arrays; only the estimate crosses device→host
                est_all = _np(est_wav)
                wav_len = np.asarray(host_batch["wav_len"])
                target = np.asarray(host_batch["target_wav"])
                mixed = np.asarray(host_batch["mixed_wav"])
                for i in range(n_valid):
                    n = int(wav_len[i])
                    est, tgt, mix = est_all[i][:n], target[i][:n], mixed[i][:n]
                    sdrs.append(bss_eval_sdr(tgt, est))
                    snris.append(si_snr_improvement(est, tgt, mix))
        if logger is not None and log_sample and not first_logged:
            first_logged = True
            logger.log_evaluation(
                test_loss=losses[-1],
                sdr=float(sdrs[0]) if sdrs else 0.0,
                step=step,
                mixed_wav=np.asarray(host_batch["mixed_wav"][0]),
                target_wav=np.asarray(host_batch["target_wav"][0]),
                est_wav=_np(est_wav[0]),
                mixed_spec=_np(out["mixed_spec"][0]),
                target_spec=_np(out["target_spec"][0]),
                est_spec=_np(out["est_spec"][0]),
                est_mask=_np(out["mask"][0]),
            )
        if max_items is not None and n_seen >= max_items:
            break
    result = {
        "loss": float(np.average(losses, weights=loss_weights)) if losses else float("nan"),
        "si_snr": float(np.mean(snrs)) if snrs else float("nan"),
    }
    if compute_sdr and sdrs:
        result["sdr"] = float(np.mean(sdrs))
        result["si_snri"] = float(np.mean(snris))
    if logger is not None:
        logger.log_scalars({f"eval_{k}": v for k, v in result.items()}, step)
    return result
