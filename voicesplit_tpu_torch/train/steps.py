"""Train and eval steps (counterpart of `voicesplit_tpu/train/steps.py`).

One train step: STFT of the raw waveform batch, the mask network in train
mode, masking, the loss, backward through the LSTM kernels, the global
norm of the unclipped gradients, optional clipping, and the Adam update.

Loss paths (from the config, reference `train.py:74-79, 97-108`):

- ``power_law_compression``: spectral loss between the masked and the
  target normalized spectrograms;
- ``si_snr``: both specs are inverted with the mixture phase through the
  differentiable iSTFT and compared in the time domain with SI-SNR (PIT,
  C = 1), masked by the true waveform length.

A batch is a dict of ``mixed_wav [B, L]``, ``target_wav [B, L]``,
``emb [B, E]`` and ``wav_len [B]``, as numpy arrays or tensors; the steps
move them to the audio processor's device.  Metrics are tensors on that
device, so a step does not wait for the card.

Train-time regularizers (off by default), as in the JAX step: SpecAugment
(``spec_aug_time`` / ``spec_aug_freq``) corrupts the mask net's input and
the mask multiplies the clean mixture spec; dropout (``model.dropout``)
acts at the model's two sites.  Their generators are seeded from the step
counter on the step's device, ``(0x5A, step)`` for SpecAugment and
``(0xD0, step)`` for dropout, as the JAX step folds the step into
``PRNGKey(0x5A)`` and ``PRNGKey(0xD0)``: a run is deterministic and a
resumed run draws what the uninterrupted one would.  The bits are torch's,
not JAX's streams.

The streaming model (`MaskNet(streaming=True)`) returns ``(mask, carry)``;
both steps use the mask and drop the carry, as the JAX steps do.

Data parallelism (`parallel/`): under a process group each rank's batch is
its own rows and its loss their mean, so the global loss is the mean of the
ranks' losses.  After the backward the loss and every gradient go into one
fp32 buffer, which is summed over the ranks and divided by the world size
before the global norm and the clipping: every rank then clips by the same
norm, takes the same Adam step and reports the same metrics.  (The
train-mode BatchNorm inside the model sums its statistics over the ranks
itself.)  With no group nothing is reduced.

The gate split (``state.shards``, `parallel/sharding.py`): the step first
gathers the full parameters from the slices, runs the forward and backward on
them, takes the data group's mean of the loss and gradients, and the global
norm and the clipping of the full gradient; then each split parameter's
gradient is cut to the owned slices, and the optimizer steps the slices and
the replicated parameters.  The eval step gathers first too.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import torch
from torch import nn

from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.dsp.augment import spec_time_freq_mask
from voicesplit_tpu_torch.dsp.processor import AudioProcessor
from voicesplit_tpu_torch.losses import power_law_compressed_loss, si_snr, si_snr_with_pit
from voicesplit_tpu_torch.parallel.mesh import group_active, sum_over_ranks_
from voicesplit_tpu_torch.train.state import (
    TrainState,
    clip_by_global_norm_,
    global_norm,
    learning_rate,
)

Batch = Mapping[str, object]
Metrics = Dict[str, torch.Tensor]


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _loss_from_outputs(
    config: Config,
    ap: AudioProcessor,
    output_spec: torch.Tensor,  # [B, T, F] masked (normalized) spec
    target_spec: torch.Tensor,  # [B, T, F]
    mixed_phase: torch.Tensor,  # [B, T, F]
    wav_len: torch.Tensor,  # [B] true sample counts
) -> torch.Tensor:
    if config.loss.loss_name == "si_snr":
        est_wav = ap.spec2wav_batch(output_spec, mixed_phase)
        tgt_wav = ap.spec2wav_batch(target_spec, mixed_phase)
        return si_snr_with_pit(est_wav[:, None, :], tgt_wav[:, None, :], wav_len)
    if config.loss.loss_name == "power_law_compression":
        return power_law_compressed_loss(
            output_spec, target_spec, config.loss.power, config.loss.complex_loss_ratio
        )
    raise ValueError(f"unknown loss {config.loss.loss_name!r}")


SPEC_AUG_SEED = 0x5A
DROPOUT_SEED = 0xD0


def step_generator(tag: int, step: int, device: torch.device) -> torch.Generator:
    """A generator on `device` seeded from ``(tag, step)``; seeding reads no
    device memory, so it costs no wait for the card."""
    return torch.Generator(device=device).manual_seed((tag << 32) + int(step))


def make_train_step(
    config: Config, model: nn.Module, ap: AudioProcessor, optimizer: torch.optim.Optimizer
) -> Callable[[TrainState, Batch], Metrics]:
    """Build the ``(state, batch) -> metrics`` step for `model` and
    `optimizer`, which `state` carries.

    It updates the model's parameters and BatchNorm running statistics
    and the optimizer in place, and adds one to ``state.step``.  Metrics:
    ``loss``, ``grad_norm`` (global norm of the unclipped gradients) and
    ``loss_exploded`` (non-finite or > 1e8, the reference's guard,
    `train.py:115-117`).
    """
    tc = config.train_config
    sa_time, sa_freq, sa_n = tc.spec_aug_time, tc.spec_aug_freq, tc.spec_aug_n
    dropout = config.model.dropout
    params = [p for p in model.parameters() if p.requires_grad]

    def train_step(state: TrainState, batch: Batch) -> Metrics:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state carries another model or optimizer than this step's")
        b = _to_device(batch, ap.device)
        state.gather_()
        model.train()
        optimizer.zero_grad(set_to_none=True)
        mixed_spec, mixed_phase = ap.wav2spec_batch(b["mixed_wav"])
        target_spec, _ = ap.wav2spec_batch(b["target_wav"])
        net_in = mixed_spec
        if sa_time or sa_freq:
            net_in = spec_time_freq_mask(
                mixed_spec, step_generator(SPEC_AUG_SEED, state.step, ap.device),
                sa_time, sa_freq, sa_n,
            )
        drop_gen = step_generator(DROPOUT_SEED, state.step, ap.device) if dropout else None
        mask = model(net_in, b["emb"], dropout_generator=drop_gen)
        if isinstance(mask, tuple):  # streaming model: (mask, lstm carry)
            mask = mask[0]
        # the estimate multiplies the clean mixture spec: SpecAugment
        # corrupts the mask net's input, not the signal path
        loss = _loss_from_outputs(
            config, ap, mask * mixed_spec, target_spec, mixed_phase, b["wav_len"]
        )
        loss.backward()
        grads = [p.grad for p in params]
        loss = loss.detach().float()
        if group_active():
            loss = mean_over_ranks_(loss, grads)
        grad_norm = global_norm(grads)
        if tc.grad_clip_norm:
            clip_by_global_norm_(grads, grad_norm, tc.grad_clip_norm)
        if state.shards is not None:
            state.shards.scatter_grads_()
        for group in optimizer.param_groups:
            group["lr"] = learning_rate(config, state.step)
        optimizer.step()
        if state.shards is not None:
            state.shards.stale = True
        state.step += 1
        return {
            "loss": loss,
            "grad_norm": grad_norm.detach(),
            "loss_exploded": torch.logical_or(~torch.isfinite(loss), loss > 1e8),
        }

    return train_step


def mean_over_ranks_(loss: torch.Tensor, grads: List[torch.Tensor]) -> torch.Tensor:
    """The mean over the data group's ranks of `loss` and of every gradient:
    one fp32 buffer summed by the collective and divided by the group's size;
    `grads` are overwritten with their means, and the mean loss is returned."""
    flat = torch.cat([loss.reshape(1), *(g.reshape(-1).float() for g in grads)])
    flat /= sum_over_ranks_(flat)
    offset = 1
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()
    return flat[0]


def make_multi_train_step(
    config: Config,
    model: nn.Module,
    ap: AudioProcessor,
    optimizer: torch.optim.Optimizer,
    steps_per_dispatch: int,
) -> Callable[[TrainState, Batch], Metrics]:
    """``(state, batches) -> metrics`` running K steps over a stacked batch
    window ``[K, B, ...]``.  Metrics are the last step's loss and
    grad_norm, ``loss_mean`` over the K steps and an any-step
    ``loss_exploded``."""
    single = make_train_step(config, model, ap, optimizer)

    def multi(state: TrainState, batches: Batch) -> Metrics:
        stacked = _to_device(batches, ap.device)
        ms = [
            single(state, {k: v[i] for k, v in stacked.items()})
            for i in range(steps_per_dispatch)
        ]
        losses = torch.stack([m["loss"] for m in ms])
        return {
            "loss": ms[-1]["loss"],
            "grad_norm": ms[-1]["grad_norm"],
            "loss_exploded": torch.stack([m["loss_exploded"] for m in ms]).any(),
            "loss_mean": losses.mean(),
        }

    return multi


def make_eval_step(
    config: Config, model: nn.Module, ap: AudioProcessor, state: Optional[TrainState] = None
) -> Callable[[Batch], Metrics]:
    """``batch -> metrics + artifacts``: the configured loss, SI-SNR of the
    mixed-phase inversion per item (the reference's fast eval,
    `utils/generic_utils.py:531-558`), and the mask and specs.  Runs the
    model in eval mode and restores its mode after.  Given the `state` that
    trains `model`, it first gathers the gate split's slices (a no-op
    without the split, or where nothing moved since the last gather)."""

    def eval_step(batch: Batch) -> Metrics:
        b = _to_device(batch, ap.device)
        if state is not None:
            state.gather_()
        was_training = model.training
        model.eval()
        try:
            with torch.no_grad():
                mixed_spec, mixed_phase = ap.wav2spec_batch(b["mixed_wav"])
                target_spec, _ = ap.wav2spec_batch(b["target_wav"])
                mask = model(mixed_spec, b["emb"])
                if isinstance(mask, tuple):  # streaming model: (mask, lstm carry)
                    mask = mask[0]
                output = mask * mixed_spec
                loss = _loss_from_outputs(
                    config, ap, output, target_spec, mixed_phase, b["wav_len"]
                )
                # the target's exact length: a clip off the hop grid would
                # otherwise invert short
                est_wav = ap.spec2wav_batch(
                    output, mixed_phase, length=b["target_wav"].shape[-1]
                )
                snr = si_snr(est_wav, b["target_wav"], lengths=b["wav_len"])
        finally:
            model.train(was_training)
        return {
            "loss": loss.float(),
            "si_snr": snr.float(),  # [B]
            "mask": mask,
            "est_spec": output,
            "mixed_spec": mixed_spec,
            "target_spec": target_spec,
            "est_wav": est_wav,
            "mixed_phase": mixed_phase,
        }

    return eval_step


def make_ema_update(decay: float):
    """Polyak/EMA parameter average ``ema ← d·ema + (1−d)·p`` over dicts of
    tensors keyed alike (e.g. ``dict(model.named_parameters())``); returns
    the new average.  Start the average at the current parameters."""

    @torch.no_grad()
    def ema_update(
        ema_params: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor]
    ) -> Dict[str, torch.Tensor]:
        return {k: decay * e + (1.0 - decay) * params[k] for k, e in ema_params.items()}

    return ema_update
