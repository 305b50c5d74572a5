"""Sequence-parallel long-form separation, exact and offline (counterpart of
`voicesplit_tpu/parallel/sequence.py`).

The time axis of one long utterance is cut into K equal shards, one per rank
of `torch.distributed`'s default group (the ``seq`` axis: NCCL on the card,
gloo on the CPU, started by `parallel/mesh.py::initialize_distributed`), and
the mask network runs on each shard with output that equals the pass over the
whole utterance on one device:

- **Conv stack.**  Each shard runs `MaskNet.conv_features` on its frames
  plus ``conv_context_left`` / ``conv_context_right`` halo frames of its
  neighbours, sent point to point (`torch.distributed.batch_isend_irecv`, as
  the JAX package's ``ppermute``).  Terminal shards take zeros; halo and
  alignment-padding frames outside ``[0, t_valid)`` are zeroed by the edge
  mask at every layer, where they act exactly as the "same" convs' zero
  padding.
- **BiLSTM.**  The input projections, fc1 and fc2 are shard-local.  The
  recurrence is made exact by K-1 carry-relay rounds and one output scan:
  in each, every shard runs `lstm_fwd` from its incoming carry (the reverse
  direction on time-flipped input) and sends its final ``(h, c)``, fp32 as
  the kernel returns it, to the next shard in chain order; after round r
  every shard d <= r holds the true carry.  The kernel takes no frame mask:
  the alignment padding is a contiguous tail (`pad_frames`), so each shard
  runs the recurrence over its valid prefix only, and a shard with no valid
  frame passes its incoming carry on unchanged.
- STFT and iSTFT run unsharded: every rank computes the whole spectrogram,
  runs its own shard, and the masks are gathered for one iSTFT, so every
  rank returns the same waveform.

The exchange between shards is an argument (`GroupExchange`, the process
group's, by default); `InProcessExchange` runs all K shards in one process,
which the tests and `chip_smoke.py` use to hold the relay to the one-device
pass.  A world of one (no process group) is the whole utterance on one
device: no halo, two `lstm_fwd` launches, `separate_batch`'s operations.

One device's conv activation ``[B, C, T_window, F]`` may hold at most
``MAX_CONV_ELEMENTS`` elements, what a 32-bit index addresses: at the full
width (64 channels, 601 bins, B=1) 55,831 frames, 558.3 s at a 160-sample
hop.  The engine is checked up to there, not past it: the port's conv
kernels index in 64 bits, but the library convs and elementwise ops of a
longer window are not held to a shorter pass.  A longer shard raises; more
ranks take a longer utterance.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as tnf

from voicesplit_tpu_torch.ops import lstm_cuda
from voicesplit_tpu_torch.parallel.mesh import rank, world_size

if TYPE_CHECKING:  # the model imports the ops, which import this package
    from voicesplit_tpu_torch.config import Config
    from voicesplit_tpu_torch.models.masknet import MaskNet

# elements one conv activation may hold: what a 32-bit index addresses, as far
# as the engine is checked (module docstring)
MAX_CONV_ELEMENTS = 2 ** 31 - 1


class GroupExchange:
    """The ranks of the default process group as the shards, one a rank (a
    world of one without a group)."""

    def __init__(self):
        self.n_shards = world_size()
        self.shards = (rank(),)

    def shift(self, tensors: Sequence[torch.Tensor], step: int) -> List[torch.Tensor]:
        """Each shard's tensor sent `step` shards on: shard d gets shard
        ``d - step``'s, zeros where there is none."""
        (t,) = tensors
        me, n = self.shards[0], self.n_shards
        out = torch.zeros_like(t)
        ops = []
        if 0 <= me + step < n:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), me + step))
        if 0 <= me - step < n:
            ops.append(dist.P2POp(dist.irecv, out, me - step))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [out]

    def gather(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's ``[B, Tc, ...]`` in shard order along time."""
        (t,) = tensors
        if self.n_shards == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(self.n_shards)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts, dim=1)


class InProcessExchange:
    """All `n_shards` shards in this process, in order: the relay and the
    halos of K devices, run on one (for checks of the sharded pass)."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self.shards = tuple(range(n_shards))

    def shift(self, tensors: Sequence[torch.Tensor], step: int) -> List[torch.Tensor]:
        n = self.n_shards
        return [tensors[d - step] if 0 <= d - step < n else torch.zeros_like(tensors[d])
                for d in range(n)]

    def gather(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(tensors), dim=1)


def make_seq_mesh(n_shards: Optional[int] = None) -> GroupExchange:
    """The ``seq`` axis over the process group's ranks; `n_shards`, if
    given, must be the world size (one device a rank)."""
    ex = GroupExchange()
    if n_shards is not None and n_shards != ex.n_shards:
        raise ValueError(f"{n_shards} shards asked for, the process group has {ex.n_shards} ranks")
    return ex


def _relay_scan(xps: Sequence[torch.Tensor], w_hh: torch.Tensor, reverse: bool,
                n_valid: Sequence[int], exchange) -> List[torch.Tensor]:
    """Exact LSTM outputs of each local shard of a sequence-sharded scan.

    `xps`: each local shard's pre-projected gates ``[B, Tc, 4H]``; `n_valid`:
    its valid frames, a prefix.  K-1 relay rounds, each a `lstm_fwd` a shard
    from its incoming carry, the final fp32 ``(h, c)`` shifted one shard on
    in chain order (left to right, or right to left with `reverse`), then
    the output scan.  Returns each shard's ``hs [Tc, B, H]`` fp32,
    time-major; frames past the valid prefix hold zeros."""
    B, Tc, G = xps[0].shape
    H = G // 4
    step = -1 if reverse else 1
    # time-major; the reverse direction on time-flipped input, as BiLSTM
    seqs = []
    for xp, n in zip(xps, n_valid):
        v = xp[:, :n]
        seqs.append((v.flip(1) if reverse else v).transpose(0, 1).contiguous())

    def scan(seq, carry):
        if seq.shape[0] == 0:  # no valid frame: the carry passes through
            return None, carry
        hs, cs, _ = lstm_cuda.lstm_fwd(seq, w_hh, carry[0], carry[1])
        return hs, torch.stack([hs[-1], cs[-1]])

    zero = torch.zeros(2, B, H, dtype=torch.float32, device=xps[0].device)
    carries = [zero] * len(seqs)
    for _ in range(exchange.n_shards - 1):
        carries = exchange.shift([scan(s, c)[1] for s, c in zip(seqs, carries)], step)
    outs = []
    for seq, carry, n in zip(seqs, carries, n_valid):
        hs, _ = scan(seq, carry)
        if hs is not None and reverse:
            hs = hs.flip(0)
        if n < Tc:
            full = torch.zeros(Tc, B, H, dtype=torch.float32, device=zero.device)
            if hs is not None:
                full[:n] = hs
            hs = full
        outs.append(hs)
    return outs


def _check_window(model: MaskNet, B: int, frames: int, F: int) -> None:
    n = B * frames * F * max(model.conv_channels, 1)
    if n > MAX_CONV_ELEMENTS:
        limit = MAX_CONV_ELEMENTS // (B * F * model.conv_channels)
        raise ValueError(
            f"a shard of {frames} frames (halos included) at batch {B} gives conv activations "
            f"of {n} elements, over the {MAX_CONV_ELEMENTS} (32-bit indexing) up to which the "
            f"engine is checked; at most {limit} frames a device: shard the utterance over "
            f"more ranks")


def make_sp_mask_fn(model: MaskNet, exchange=None):
    """``fn(spec [B, T, F], emb [B, E], t_valid) -> mask [B, T, F]`` (fp32)
    with T sharded over `exchange`'s shards (the process group's by default).

    `spec` is the whole normalized magnitude spectrogram, every rank's the
    same; each process runs its own shards and the masks are gathered.  T
    must be divisible by the number of shards, and with more than one shard
    each must cover the conv halo (``T / K >= conv_context_left``):
    `pad_frames` gives both.  Frames ``[0, t_valid)`` are real; the
    alignment padding after them is edge-masked at every conv layer and left
    out of the recurrence, so the mask on real frames is the unpadded
    one-device pass's."""
    ex = exchange if exchange is not None else GroupExchange()
    K = ex.n_shards
    # a world of one has no halo: the convs pad the utterance's ends themselves
    ctx_l = model.conv_context_left if K > 1 else 0
    ctx_r = model.conv_context_right if K > 1 else 0
    cd = model.compute_dtype
    lstm = model.lstm

    def fn(spec: torch.Tensor, emb: torch.Tensor, t_valid: int) -> torch.Tensor:
        B, T, F = spec.shape
        t_valid = int(t_valid)
        if T % K:
            raise ValueError(f"{T} frames do not split into {K} shards (see pad_frames)")
        Tc = T // K
        if K > 1 and Tc < max(model.conv_context_left, model.conv_context_right):
            raise ValueError(f"shards of {Tc} frames do not cover the conv halo "
                             f"{model.conv_context_left} (see pad_frames)")
        _check_window(model, B, ctx_l + Tc + ctx_r, F)
        shards = [spec[:, d * Tc:(d + 1) * Tc] for d in ex.shards]
        # --- conv halo exchange --------------------------------------------
        lefts = ex.shift([s[:, Tc - ctx_l:] for s in shards], 1) if ctx_l else [None] * len(shards)
        rights = ex.shift([s[:, :ctx_r] for s in shards], -1) if ctx_r else [None] * len(shards)
        feats = []
        for d, s, lo, hi in zip(ex.shards, shards, lefts, rights):
            window = torch.cat([p for p in (lo, s, hi) if p is not None], dim=1)
            # the global frame index of every window position → validity
            g = torch.arange(d * Tc - ctx_l, (d + 1) * Tc + ctx_r, device=spec.device)
            valid = ((g >= 0) & (g < t_valid))[None]
            edge = None if bool(valid.all()) else valid
            feats.append(model.conv_features(window, edge_mask=edge)[:, ctx_l:ctx_l + Tc])
        n_valid = [min(max(t_valid - d * Tc, 0), Tc) for d in ex.shards]

        # --- mask head: MaskNet.mask_head's operations, the BiLSTM's two
        # scans replaced by relayed ones -------------------------------------
        xps_f, xps_b = [], []
        for f in feats:
            emb_t = emb.to(cd)[:, None, :].expand(B, Tc, model.emb_dim)
            xc = torch.cat([f, emb_t], dim=-1).to(cd)
            xps_f.append(xc @ lstm.fwd_w_ih.to(cd) + lstm.fwd_b.to(cd))
            xps_b.append(xc @ lstm.bwd_w_ih.to(cd) + lstm.bwd_b.to(cd))
        outs_f = _relay_scan(xps_f, lstm.fwd_w_hh.to(cd), False, n_valid, ex)
        outs_b = _relay_scan(xps_b, lstm.bwd_w_hh.to(cd), True, n_valid, ex)
        masks = []
        for out_f, out_b in zip(outs_f, outs_b):
            x = torch.relu(torch.cat([out_f, out_b], dim=-1).transpose(0, 1).to(cd))
            x = torch.relu(model._dense(model.fc1, x))
            masks.append(torch.sigmoid(model._dense(model.fc2, x).float()))
        return ex.gather(masks)

    return fn


def pad_frames(T: int, n_shards: int, min_shard: int) -> int:
    """Padded frame count: divisible by `n_shards`, each shard >= `min_shard`."""
    per = max((T + n_shards - 1) // n_shards, min_shard)
    return per * n_shards


def separate_long(
    config: Config,
    model: MaskNet,
    mixed_wav,  # [L] or [B, L]
    emb,  # [E] or [B, E]
    mesh=None,
    synthesis_window: str = "hann",
) -> np.ndarray:
    """Separate an arbitrarily long mixture with `model` (eval mode, on its
    device), time-sharded over `mesh` (an exchange; the process group's
    ranks by default, a world of one without a group).

    STFT and iSTFT run unsharded; the zero frames of shard alignment are
    dropped before the inversion, and cannot reach real frames (edge-masked
    at every conv layer, outside the recurrence).  Returns the separated
    waveform as the input's shape, float32, the same on every rank."""
    from voicesplit_tpu_torch.dsp.processor import AudioProcessor

    ex = mesh if mesh is not None else make_seq_mesh()
    dev = next(model.parameters()).device
    ap = AudioProcessor(config.audio, synthesis_window, dev)
    wav = np.atleast_2d(np.asarray(mixed_wav, np.float32))
    e = np.atleast_2d(np.asarray(emb, np.float32))
    with torch.inference_mode():
        w = torch.as_tensor(wav, device=dev)
        spec, phase = ap.wav2spec_batch(w)
        T = spec.shape[1]
        Tp = pad_frames(T, ex.n_shards, model.conv_context_left if ex.n_shards > 1 else 1)
        spec_p = spec if Tp == T else tnf.pad(spec, (0, 0, 0, Tp - T))
        mask = make_sp_mask_fn(model, ex)(spec_p, torch.as_tensor(e, device=dev), T)[:, :T]
        out = ap.spec2wav_batch(mask * spec, phase, length=wav.shape[-1]).cpu().numpy()
    return out[0] if np.ndim(mixed_wav) == 1 else out
