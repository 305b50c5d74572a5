"""GE2E speaker-encoder training and utterance embedding (counterpart of
`voicesplit_tpu/train/encoder.py`).

`cli/train_encoder.py` is the command line over `train_ge2e`.  A step embeds
N speakers x M random 80-frame mel crops in one forward pass of
`SpeakerEncoder` (N·M rows: one `lstm_fwd` a layer, and one `lstm_bwd` a
layer in its backward), takes the GE2E softmax loss with its learnable
``(w, b)``, scales the gradients of ``(w, b)`` by 0.01, clips all gradients
by their global norm at 3.0 and takes an Adam step: optax's
``chain(clip_by_global_norm(3.0), adam(lr))`` as the JAX package runs it.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from voicesplit_tpu_torch.device import DeviceLike, resolve_device
from voicesplit_tpu_torch.losses.ge2e import ge2e_softmax_loss
from voicesplit_tpu_torch.models.speaker_encoder import SpeakerEncoder, load_torch_state_dict
from voicesplit_tpu_torch.train.state import clip_by_global_norm_, global_norm, make_adam
from voicesplit_tpu_torch.weights import init_encoder_for_training_

MAX_GRAD_NORM = 3.0
WB_GRAD_SCALE = 0.01  # the paper's smaller gradient scale on (w, b)


class MelSampler:
    """Host-side batch sampler: N speakers x M random `window`-frame mel crops.

    Makes the same ``rng`` draws in the same order as the JAX package's
    sampler, so one seed gives the same batches in both.  Mels are computed
    once per file and cached (40 mels x ~300 frames a 3 s utterance)."""

    def __init__(self, ap, speakers: Dict[str, List[str]], window: int, rng: np.random.Generator):
        self.ap = ap
        self.speakers = speakers
        self.names = sorted(speakers)
        self.window = window
        self.rng = rng
        self._cache: Dict[str, np.ndarray] = {}

    def _mel(self, path: str) -> np.ndarray:
        m = self._cache.get(path)
        if m is None:
            m = np.asarray(self.ap.get_mel_bucketed(self.ap.load_wav(path)), np.float32)
            self._cache[path] = m
        return m

    def crop(self, path: str) -> np.ndarray:
        m = self._mel(path)
        T = m.shape[1]
        if T < self.window:
            m = np.pad(m, ((0, 0), (0, self.window - T)), mode="wrap")
            return m[:, : self.window]
        s = int(self.rng.integers(0, T - self.window + 1))
        return m[:, s : s + self.window]

    def batch(self, n_speakers: int, m_utts: int, names: Optional[List[str]] = None):
        """``[N·M, n_mels, window]`` crops, speaker-major, and their speakers."""
        pool = names if names is not None else self.names
        chosen = self.rng.choice(len(pool), size=n_speakers, replace=False)
        mels, ids = [], []
        for ci in chosen:
            name = pool[int(ci)]
            wavs = self.speakers[name]
            picks = self.rng.choice(len(wavs), size=m_utts, replace=len(wavs) < m_utts)
            for pi in picks:
                mels.append(self.crop(wavs[int(pi)]))
                ids.append(name)
        return np.stack(mels), ids


class GE2E(nn.Module):
    """What GE2E training updates: the encoder ``enc`` and the loss's
    similarity scale ``w`` and bias ``b`` (the paper's init, 10 and -5)."""

    def __init__(self, encoder: SpeakerEncoder):
        super().__init__()
        self.enc = encoder
        dev = next(encoder.parameters()).device
        self.w = nn.Parameter(torch.tensor(10.0, device=dev))
        self.b = nn.Parameter(torch.tensor(-5.0, device=dev))

    def loss(self, mels: torch.Tensor, n_speakers: int, m_utts: int) -> torch.Tensor:
        emb = self.enc(mels)  # [N·M, D]
        return ge2e_softmax_loss(emb.reshape(n_speakers, m_utts, -1), self.w, self.b)


def make_ge2e_step(model: GE2E, optimizer: torch.optim.Optimizer, n_speakers: int, m_utts: int):
    """One training step on a ``[N·M, n_mels, W]`` batch on the model's
    device; returns the loss (a device scalar, not synchronized)."""
    params = list(model.parameters())

    def step(mels: torch.Tensor) -> torch.Tensor:
        loss = model.loss(mels, n_speakers, m_utts)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            # scaled before the clip, as the JAX step scales them before
            # `tx.update`
            model.w.grad.mul_(WB_GRAD_SCALE)
            model.b.grad.mul_(WB_GRAD_SCALE)
            grads = [p.grad for p in params]
            clip_by_global_norm_(grads, global_norm(grads), MAX_GRAD_NORM)
        optimizer.step()
        return loss.detach()

    return step


def train_ge2e(
    ap,
    speakers: Dict[str, List[str]],
    *,
    n_speakers: int = 16,
    m_utts: int = 6,
    steps: int = 2000,
    lr: float = 1e-4,
    lstm_hidden: int = 768,
    lstm_layers: int = 3,
    emb_dim: int = 256,
    seed: int = 0,
    window: int = 80,
    log_interval: int = 50,
    log: Callable[[str], None] = print,
    params: Union[None, GE2E, Mapping[str, torch.Tensor]] = None,
    opt_state: Optional[dict] = None,
    step0: int = 0,
    device: DeviceLike = None,
) -> Tuple[SpeakerEncoder, GE2E, dict, List[float]]:
    """Train the GE2E encoder on a speaker → wavs dict, on `device` (the
    CUDA card by default).

    Returns ``(encoder, params, opt_state, losses)`` as the JAX function:
    `params` is the `GE2E` module (``params.enc`` is `encoder`), `opt_state`
    the optimizer's ``state_dict``; pass them and `step0` back in to go on
    training.  `params` may also be a `GE2E` state dict, e.g.
    `weights.encoder_params_from_jax` of a JAX tree.  A fresh model is drawn
    from `seed` (`weights.init_encoder_for_training_`).  `losses` holds the
    losses of the first step and of every `log_interval`-th."""
    dev = resolve_device(device)
    N, M = n_speakers, m_utts
    if len(speakers) < N:
        raise ValueError(f"need >= {N} speakers, got {len(speakers)}")
    rng = np.random.default_rng(seed)
    sampler = MelSampler(ap, speakers, window=window, rng=rng)
    # the JAX function takes n_mels from a crop, which draws from rng
    n_mels = int(sampler.crop(next(iter(speakers.values()))[0]).shape[0])

    if isinstance(params, GE2E):
        model = params
    else:
        encoder = SpeakerEncoder(num_mels=n_mels, lstm_hidden=lstm_hidden,
                                 lstm_layers=lstm_layers, emb_dim=emb_dim)
        model = GE2E(init_encoder_for_training_(encoder, seed)).to(dev)
        if params is not None:
            model.load_state_dict(params)
    optimizer = make_adam(model.parameters(), lr)
    if opt_state is not None:
        optimizer.load_state_dict(opt_state)
        for group in optimizer.param_groups:  # the state's moments, this call's rate
            group["lr"] = lr
    train_step = make_ge2e_step(model, optimizer, N, M)

    losses: List[float] = []
    t0 = time.time()
    for step in range(step0 + 1, step0 + steps + 1):
        mels, _ = sampler.batch(N, M)
        loss = train_step(torch.as_tensor(mels, device=dev))
        if step % log_interval == 0 or step == step0 + 1:
            losses.append(float(loss))
            log(f"ge2e step {step}  loss {losses[-1]:.4f}  "
                f"({(time.time() - t0) / max(1, step - step0):.2f} s/step)")
    return model.enc, model, optimizer.state_dict(), losses


def window_count(frames: int, window: int, stride: int) -> int:
    """How many `window`-frame windows at `stride` fit in `frames` frames."""
    return (frames - window) // stride + 1


def utterance_windows(mel: np.ndarray, window: int, stride: int) -> np.ndarray:
    """The windows ``[n, n_mels, window]`` of a mel ``[n_mels, T]`` (T at
    least `window`), one every `stride` frames."""
    n = window_count(mel.shape[1], window, stride)
    return np.stack([mel[:, s * stride : s * stride + window] for s in range(n)])


@torch.inference_mode()
def embed_windows(encoder: SpeakerEncoder, wins: np.ndarray, batch_windows: int = 32) -> np.ndarray:
    """d-vectors ``[n, D]`` of ``n`` windows ``[n, n_mels, W]`` (W the
    encoder's window), in fixed batches of `batch_windows`, the last padded
    with zero windows: one shape for the encoder whatever n is."""
    dev = next(encoder.parameters()).device
    parts = []
    for i in range(0, len(wins), batch_windows):
        chunk = wins[i : i + batch_windows]
        valid = len(chunk)
        if valid < batch_windows:
            chunk = np.concatenate(
                [chunk, np.zeros((batch_windows - valid, *chunk.shape[1:]), np.float32)]
            )
        out = encoder(torch.as_tensor(chunk, dtype=torch.float32, device=dev))
        parts.append(out.float().cpu().numpy()[:valid])
    return np.concatenate(parts)


def embed_utterance_windows(encoder: SpeakerEncoder, ap, wav: np.ndarray,
                            batch_windows: int = 32, stride: Optional[int] = None) -> np.ndarray:
    """Per-window d-vectors ``[n_win, D]`` of one waveform, each row
    L2-normalized (the encoder's window; its stride unless `stride` is
    given: EER trials pass ``stride=encoder.window`` so that windows do not
    overlap); a clip shorter than a window is wrapped to one."""
    mel = np.asarray(ap.get_mel_bucketed(wav), np.float32)
    W = encoder.window
    S = encoder.stride if stride is None else int(stride)
    T = mel.shape[1]
    if T < W:
        mel = np.pad(mel, ((0, 0), (0, W - T)), mode="wrap")
    embs = embed_windows(encoder, utterance_windows(mel, W, S), batch_windows)
    norms = np.linalg.norm(embs, axis=-1, keepdims=True)
    return (embs / (norms + 1e-8)).astype(np.float32)


def embed_utterance(encoder: SpeakerEncoder, ap, wav: np.ndarray,
                    batch_windows: int = 32) -> np.ndarray:
    """Mean-pooled, renormalized d-vector of one waveform."""
    emb = embed_utterance_windows(encoder, ap, wav, batch_windows=batch_windows).mean(axis=0)
    return (emb / (np.linalg.norm(emb) + 1e-8)).astype(np.float32)


def embed_reference(encoder: SpeakerEncoder, ap, wav: np.ndarray,
                    batch_windows: int = 32) -> np.ndarray:
    """The d-vector of a reference clip as the JAX serving CLI takes it
    (``encoder.apply(vars, ap.get_mel(wav)[None])``): the encoder's windows of
    the clip's log-mel, each L2-normalized, then their plain mean (no wrap of
    a short clip, no renormalization), embedded in fixed batches of
    `batch_windows`."""
    mel = np.asarray(ap.get_mel(wav), np.float32)
    if mel.shape[1] < encoder.window:
        raise ValueError(f"reference of {mel.shape[1]} mel frames; the encoder needs "
                         f"at least {encoder.window}")
    wins = utterance_windows(mel, encoder.window, encoder.stride)
    return embed_windows(encoder, wins, batch_windows).mean(axis=0).astype(np.float32)


def load_ge2e_encoder(path: Optional[str], num_mels: int, device) -> SpeakerEncoder:
    """The GE2E `SpeakerEncoder` of a checkpoint on `device`: the port's
    ``encoder_<step>.pt``, the JAX CLI's ``encoder_<step>.msgpack`` (each
    carries its topology) or the reference's ``embedder.pt`` state dict;
    with no path, random weights from seed 0 (pipeline smoke runs)."""
    if path is None:
        print(" > No encoder checkpoint given — using random init (smoke mode)")
        return init_encoder_for_training_(SpeakerEncoder(num_mels=num_mels), 0).to(device)
    if path.endswith(".msgpack"):
        ckpt = load_encoder_checkpoint(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if "encoder" not in ckpt:  # the reference's embedder.pt: a bare state dict
            encoder = SpeakerEncoder(num_mels=num_mels)
            encoder.load_state_dict(load_torch_state_dict(ckpt))
            return encoder.to(device)
    encoder = SpeakerEncoder(**ckpt["encoder"])
    encoder.load_state_dict({k[4:]: v for k, v in ckpt["params"].items() if k.startswith("enc.")})
    return encoder.to(device)


def save_encoder_checkpoint(path: str, model: GE2E, opt_state: dict, step: int) -> None:
    """Write ``{params, opt_state, step, encoder}`` (every tensor on the CPU;
    ``encoder`` the topology, as the JAX CLI records it) as a ``torch.save``
    file: the port's ``encoder_<step>.pt``."""
    from voicesplit_tpu_torch.train.checkpoint import _to_cpu

    enc = model.enc
    topology = {"num_mels": enc.num_mels, "lstm_hidden": enc.lstm_hidden,
                "lstm_layers": enc.lstm_layers, "emb_dim": enc.emb_dim}
    torch.save({"params": _to_cpu(model.state_dict()), "opt_state": _to_cpu(opt_state),
                "step": int(step), "encoder": topology}, path)


def load_encoder_checkpoint(path: str) -> dict:
    """A GE2E checkpoint: the port's ``encoder_<step>.pt`` or the JAX CLI's
    ``encoder_<step>.msgpack`` (read without flax, `train.checkpoint.read_msgpack`)
    → ``{params, opt_state, step, encoder}``: a `GE2E` state dict, the
    optimizer's ``state_dict`` (a JAX optax state carried by
    `weights.encoder_optimizer_state_from_jax`), the step and the encoder's
    topology."""
    if not path.endswith(".msgpack"):
        return torch.load(path, map_location="cpu", weights_only=True)
    from voicesplit_tpu_torch.train.checkpoint import read_msgpack
    from voicesplit_tpu_torch.weights import encoder_optimizer_state_from_jax, encoder_params_from_jax

    blob = read_msgpack(path)
    params = encoder_params_from_jax(blob["params"])
    topo = {k: int(v) for k, v in blob["encoder"].items()}
    model = GE2E(SpeakerEncoder(**topo))
    model.load_state_dict(params)
    optimizer = make_adam(model.parameters(), 0.0)  # the learning rate is the caller's
    encoder_optimizer_state_from_jax(blob["opt_state"], model, optimizer)
    return {"params": params, "opt_state": optimizer.state_dict(), "step": int(blob["step"]),
            "encoder": topo}
