"""The plain reference of the mask network, its DSP, losses and Adam.

Plain PyTorch, written from the published description (VoiceFilter,
arXiv:1810.04826, Table 1; VoiceSplit's `config.json` and its Mish / SI-SNR
choices) and not from the program: it imports nothing of the program and
nothing of JAX, and it takes only what the benchmark made (the weights from
the seed, the inputs) and works everything else out itself.

- DSP: `torch.stft` / `torch.istft` (periodic Hann window of
  ``win_length`` centred in ``n_fft``, reflect padding), magnitudes in dB
  against ``ref_level_db``, normalized by ``min_level_db`` into [0, 1]; the
  estimate is inverted with the mixture's phase.
- Mask network: "same" convs (1,7), (7,1), (5,5) at time dilation 1..16,
  the 1x1 projection, each followed by BatchNorm and the activation (Mish
  for VoiceSplit, ReLU for VoiceFilter); the conv features flattened
  frequency-major, the d-vector appended to every frame, a BiLSTM, ReLU,
  fc1, ReLU, fc2, sigmoid.  Train mode normalizes with the batch's biased
  statistics and moves the running ones by 0.9 / 0.1.
- Precision: float32 throughout, TF32 off (`fp32_matmuls`), the
  reference that the program's bf16 compute is held to.  ``precision=
  "bf16"`` holds the operands and the activations between layers in the
  configurations' bf16 (BatchNorm, the activations, the LSTM's gates and
  state and the DSP stay fp32).  ``precision="fp8"`` is the control, the nearest precision below the
  configurations' bf16: every conv and matmul operand (the activations
  entering each layer, the weights, the LSTM's hidden state) rounded to
  float8 e4m3 with a per-tensor scale, their gradients to e5m2, products
  accumulated in fp32.
- Parameters by the names of the state the benchmark hands to both sides
  (``conv{i}.conv.weight`` OIHW, ``conv{i}.bn.{scale,bias,mean,var}``,
  ``lstm.{fwd,bwd}_{w_ih [in, 4H], w_hh [H, 4H], b [4H]}`` with gates
  i, f, g, o, ``fc{1,2}.{weight [out, in], bias}``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from costs import conv_layers

Tensors = Dict[str, torch.Tensor]

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
_FP8 = {"fwd": (torch.float8_e4m3fn, 448.0), "bwd": (torch.float8_e5m2, 57344.0)}


def _round_fp8(x: torch.Tensor, which: str) -> torch.Tensor:
    dtype, top = _FP8[which]
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((x.float() / scale).to(dtype).float() * scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round_fp8(x, "fwd")

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, "bwd")


class Precision:
    """Where the operands of a conv or a matmul are rounded and in what
    dtype (``cd``) activations are held between layers: fp32 for the
    reference; bf16 operands and activations for the configurations'
    stated compute dtype; fp8-rounded operands for the control."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.cd = torch.bfloat16 if name == "bf16" else torch.float32

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.cd)
        return _Fp8.apply(x) if self.name == "fp8" else x


# --- DSP ----------------------------------------------------------------------

def _window(audio: dict, device) -> torch.Tensor:
    return torch.hann_window(audio["win_length"], periodic=True, dtype=torch.float32,
                             device=device)


def spectrogram(wav: torch.Tensor, audio: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[B, L]`` → normalized magnitude and phase, each ``[B, T, F]`` fp32."""
    X = torch.stft(wav.float(), audio["n_fft"], audio["hop_length"], audio["win_length"],
                   window=_window(audio, wav.device), center=True, pad_mode="reflect",
                   return_complex=True).transpose(1, 2)
    db = 20.0 * torch.log10(torch.clamp(X.abs(), min=1e-5)) - audio["ref_level_db"]
    spec = torch.clamp(db / -audio["min_level_db"], -1.0, 0.0) + 1.0
    return spec, torch.angle(X)


def waveform(spec: torch.Tensor, phase: torch.Tensor, audio: dict,
             length: Optional[int] = None) -> torch.Tensor:
    """Normalized magnitude ``[B, T, F]`` with `phase` → ``[B, L]``."""
    db = (torch.clamp(spec, 0.0, 1.0) - 1.0) * -audio["min_level_db"] + audio["ref_level_db"]
    mag = torch.pow(10.0, db / 20.0)
    X = torch.polar(mag, phase).transpose(1, 2)
    return torch.istft(X, audio["n_fft"], audio["hop_length"], audio["win_length"],
                       window=_window(audio, spec.device), center=True, length=length)


# --- mask network ----------------------------------------------------------------

def _activation(z: torch.Tensor, name: str) -> torch.Tensor:
    if name == "relu":
        return torch.relu(z)
    return z * torch.tanh(F.softplus(z))  # mish


def _lstm_walks(xp: torch.Tensor, w_hh: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Both directions at once.  `xp` ``[2, B, T, 4H]`` (the second
    direction already time-reversed), `w_hh` ``[2, H, 4H]`` → ``[2, B, T,
    H]`` fp32."""
    D, B, T, H4 = xp.shape
    H = H4 // 4
    w = prec.operand(w_hh).float()
    h = torch.zeros(D, B, H, device=xp.device)
    c = torch.zeros(D, B, H, device=xp.device)
    hs = []
    for t in range(T):
        gates = xp[:, :, t].float() + torch.bmm(prec.operand(h).float(), w)
        i, f, g, o = gates.split(H, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=2)


def mask_net(p: Tensors, spec: torch.Tensor, emb: torch.Tensor, model: dict, activation: str,
             train: bool, prec: Precision) -> Tuple[torch.Tensor, List[Tuple[torch.Tensor, ...]]]:
    """``spec [B, T, F]`` fp32 and ``emb [B, E]`` → the mask ``[B, T, F]``
    fp32, and in train mode each block's fp32 biased batch (mean, var)."""
    B, T, Fq = spec.shape
    cd = prec.cd
    x = spec.to(cd)[:, None]
    stats = []
    for i, layer in enumerate(conv_layers(model)):
        kt, kf, dt = layer["kt"], layer["kf"], layer["dt"]
        n = f"conv{i + 1}"
        y = F.conv2d(prec.operand(x), prec.operand(p[f"{n}.conv.weight"]),
                     p[f"{n}.conv.bias"].to(cd), padding=((kt - 1) * dt // 2, (kf - 1) // 2),
                     dilation=(dt, 1)).float()
        if train:
            var, mean = torch.var_mean(y, dim=(0, 2, 3), unbiased=False)
            stats.append((mean.detach(), var.detach()))
        else:
            mean, var = p[f"{n}.bn.mean"], p[f"{n}.bn.var"]
        z = (y - mean[:, None, None]) * torch.rsqrt(var + BN_EPS)[:, None, None]
        z = z * p[f"{n}.bn.scale"][:, None, None] + p[f"{n}.bn.bias"][:, None, None]
        x = _activation(z, activation).to(cd)
    feats = x.permute(0, 2, 3, 1).reshape(B, T, -1)
    feats = torch.cat([feats, emb.to(cd)[:, None, :].expand(B, T, emb.shape[-1])], dim=-1)
    xq = prec.operand(feats)
    xp = torch.stack([
        (xq @ prec.operand(p[f"lstm.{d}_w_ih"]) + p[f"lstm.{d}_b"].to(cd)) for d in ("fwd", "bwd")
    ])
    xp = torch.stack([xp[0], xp[1].flip(1)])
    hs = _lstm_walks(xp, torch.stack([p["lstm.fwd_w_hh"], p["lstm.bwd_w_hh"]]), prec)
    h = torch.relu(torch.cat([hs[0], hs[1].flip(1)], dim=-1).to(cd))
    h = torch.relu(prec.operand(h) @ prec.operand(p["fc1.weight"]).t() + p["fc1.bias"].to(cd))
    logits = prec.operand(h) @ prec.operand(p["fc2.weight"]).t() + p["fc2.bias"].to(cd)
    return torch.sigmoid(logits.float()), stats


# --- losses ------------------------------------------------------------------

def si_snr_loss(est: torch.Tensor, tgt: torch.Tensor, eps: float = 1e-16) -> torch.Tensor:
    """20 − mean SI-SNR (dB) over the batch, one source each."""
    s = tgt - tgt.mean(dim=-1, keepdim=True)
    e = est - est.mean(dim=-1, keepdim=True)
    proj = (e * s).sum(-1, keepdim=True) / ((s * s).sum(-1, keepdim=True) + eps) * s
    noise = e - proj
    snr = 10.0 * torch.log10((proj * proj).sum(-1) / ((noise * noise).sum(-1) + eps) + eps)
    return 20.0 - snr.mean()


def power_law_loss(pred: torch.Tensor, tgt: torch.Tensor, power: float, ratio: float,
                   eps: float = 1e-16) -> torch.Tensor:
    """MSE(|t|^p, |p|^p) + ratio · MSE(t^p, p^p), compressed as
    sign(x)·(|x| + eps)^p."""
    pc = torch.sign(pred) * torch.pow(pred.abs() + eps, power)
    tc = torch.sign(tgt) * torch.pow(tgt.abs() + eps, power)
    return ((tc.abs() - pc.abs()) ** 2).mean() + ratio * ((tc - pc) ** 2).mean()


def _activation_name(config: dict) -> str:
    return "relu" if config["model_name"] == "voicefilter" else "mish"


def loss_of(p: Tensors, batch: Tensors, config: dict, prec: Precision):
    """The train-mode loss of `batch` and each block's batch statistics."""
    audio = config["audio"]["voicefilter"]
    spec_m, phase = spectrogram(batch["mixed_wav"], audio)
    spec_t, _ = spectrogram(batch["target_wav"], audio)
    mask, stats = mask_net(p, spec_m, batch["emb"], config["model"], _activation_name(config),
                           True, prec)
    est = mask * spec_m
    loss_cfg = config["loss"]
    if loss_cfg["loss_name"] == "si_snr":
        loss = si_snr_loss(waveform(est, phase, audio), waveform(spec_t, phase, audio))
    elif loss_cfg["loss_name"] == "power_law_compression":
        loss = power_law_loss(est, spec_t, loss_cfg["power"], loss_cfg["complex_loss_ratio"])
    else:
        raise ValueError(f"unknown loss {loss_cfg['loss_name']!r}")
    return loss, stats


# --- training ----------------------------------------------------------------

def is_buffer(name: str) -> bool:
    return name.endswith(".bn.mean") or name.endswith(".bn.var")


def train(state: Tensors, batches: List[Tensors], config: dict,
          precision: str = "fp32") -> dict:
    """Train-mode steps with Adam at the configured learning rate from
    `state` (not modified), one for each of `batches`.  Returns each step's
    ``losses``, the ``first_grad`` of every parameter (fp32) and the
    ``final`` state after the last step."""
    prec = Precision(precision)
    lr = float(config["train_config"]["learning_rate"])
    b1, b2 = BETAS
    cur = {k: v.detach().clone().float() for k, v in state.items()}
    names = [k for k in cur if not is_buffer(k)]
    m = {k: torch.zeros_like(cur[k]) for k in names}
    v = {k: torch.zeros_like(cur[k]) for k in names}
    losses, first_grad = [], None
    for t, batch in enumerate(batches, start=1):
        params = {k: cur[k].requires_grad_(True) if k in names else cur[k] for k in cur}
        loss, stats = loss_of(params, batch, config, prec)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in zip(names, grads)}
        with torch.no_grad():
            new = {}
            for i, (mean, var) in enumerate(stats):
                n = f"conv{i + 1}.bn"
                new[f"{n}.mean"] = BN_MOMENTUM * cur[f"{n}.mean"] + (1 - BN_MOMENTUM) * mean
                new[f"{n}.var"] = BN_MOMENTUM * cur[f"{n}.var"] + (1 - BN_MOMENTUM) * var
            for k, g in zip(names, grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                new[k] = cur[k].detach() - lr * (m[k] / (1 - b1 ** t)) / denom
        cur = new
    return {"losses": losses, "first_grad": first_grad, "final": cur}


# --- serving -----------------------------------------------------------------

@torch.no_grad()
def separate(state: Tensors, mixed: torch.Tensor, emb: torch.Tensor, config: dict,
             precision: str = "fp32", rows: int = 8) -> torch.Tensor:
    """Eval-mode separation of ``mixed [N, L]`` with ``emb [N, E]`` →
    ``[N, L]`` fp32, `rows` at a time."""
    prec = Precision(precision)
    audio = config["audio"]["voicefilter"]
    out = []
    for i in range(0, mixed.shape[0], rows):
        spec, phase = spectrogram(mixed[i:i + rows], audio)
        mask, _ = mask_net(state, spec, emb[i:i + rows], config["model"],
                           _activation_name(config), False, prec)
        out.append(waveform(mask * spec, phase, audio, length=mixed.shape[-1]))
    return torch.cat(out)


def fp32_matmuls() -> None:
    """Full fp32 products and convs (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


