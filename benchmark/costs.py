"""Operations and bytes of the mask network's work, counted from shapes.

Frozen copies, so that a later change to the program cannot move the
yardstick:

- `lstm_bound`, `lstm_bwd_bound` and `conv_bound` are `chip_smoke.py`'s
  functions of the same names (each input byte read once, each output byte
  written once, the products at the operand type's published peak; the
  least time is the larger of the two), with the peaks passed in from here.
- `step_flops` is `voicesplit_tpu_torch/utils/profiling.py::
  masknet_train_step_cost`'s FLOP count with three gaps closed: a serving
  variant (forward only), the STFT / iSTFT terms that the path really runs
  (the power-law loss inverts nothing), and the extra dilated blocks.  Its
  "3x forward" rule is spelled out layer by layer: a layer's forward, its
  data gradient where its input needs one (not ``conv1``, whose input is the
  spectrogram), and its weight gradient.  A conv counts only the taps that
  fall inside the tensor, as `conv_bound` does.

Peaks: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": FP32_FLOPS}


def _bound(bytes_: float, flops: float, dtype: str) -> dict:
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": bytes_, "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def lstm_bound(directions: int, batch: int, dtype: str, H: int, T: int) -> dict:
    """Least time for the recurrence (`chip_smoke.py::lstm_bound`)."""
    R = directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        T * R * 4 * H * op_bytes  # xp
        + directions * H * 4 * H * op_bytes  # W_hh
        + (2 * R * H * 4 if directions == 1 else 0)  # h0, c0
        + 2 * T * R * H * 4  # hs, cs
        + T * R * 4 * H * 4  # gates
    )
    return _bound(bytes_, 2 * T * R * H * 4 * H, dtype)


def lstm_bwd_bound(directions: int, batch: int, dtype: str, H: int, T: int) -> dict:
    """Least time for the recurrence's backward, dW_hh included
    (`chip_smoke.py::lstm_bwd_bound`)."""
    R = directions * batch
    op_bytes = 2 if dtype == "bfloat16" else 4
    bytes_ = (
        directions * H * 4 * H * op_bytes  # W_hh
        + T * R * 4 * H * 4  # gates
        + 3 * T * R * H * 4  # cs, hs, dhs
        + (6 * R * H * 4 if directions == 1 else 0)  # h0, c0, dhf, dcf, dh0, dc0
        + T * R * 4 * H * op_bytes  # dxp
        + directions * H * 4 * H * 4  # dW_hh
    )
    return _bound(bytes_, 2 * 2 * T * R * H * 4 * H, dtype)


def conv_taps(T: int, F: int, kt: int, kf: int, dt: int) -> Tuple[int, int]:
    """(rows, cols): output positions summed over the taps that fall inside
    the tensor, along time and along frequency ("same" zero padding)."""
    pad_t, pad_f = (kt - 1) * dt // 2, (kf - 1) // 2
    rows = sum(max(0, T - abs(i * dt - pad_t)) for i in range(kt))
    cols = sum(max(0, F - abs(j - pad_f)) for j in range(kf))
    return rows, cols


def conv_bound(kind: str, shape, kt: int, kf: int, dt: int, dtype: str,
               cout: int = None) -> dict:
    """Least time for one conv kernel (`chip_smoke.py::conv_bound`).  `shape`
    is the input's ``[B, T, F, Cin]``; the output (or, for a weight
    gradient, the cotangent) has `cout` channels, by default Cin."""
    B, T, F, cin = shape
    cout = cin if cout is None else cout
    op = 2 if dtype == "bfloat16" else 4
    in_bytes, out_bytes = B * T * F * cin * op, B * T * F * cout * op
    w_elems = kt * kf * cin * cout
    if kind == "conv_wgrad":
        bytes_ = in_bytes + out_bytes + w_elems * 4 + 2 * cin * 4  # x, d_raw; dW; inv, shift
    elif kind == "conv_dilated_wgrad":
        bytes_ = in_bytes + out_bytes + w_elems * 4  # x, dy; dW
    elif kind == "conv_dilated_fwd":
        bytes_ = in_bytes + out_bytes + w_elems * op  # x, out; W
    elif kind == "conv_dgrad":
        bytes_ = in_bytes + out_bytes + w_elems * op + cin * 4  # d_raw, dx; W; dbias
    else:  # x, raw; W; inv, shift; bias, stats
        bytes_ = in_bytes + out_bytes + w_elems * op + (2 * cin + 3 * cout) * 4
    rows, cols = conv_taps(T, F, kt, kf, dt)
    return _bound(bytes_, 2 * cin * cout * B * rows * cols, dtype)


# --- the model's layers, from the configuration ------------------------------

def conv_layers(model: dict, in_channels: int = 1) -> List[dict]:
    """The conv stack of `MaskNet` (VoiceFilter, arXiv:1810.04826, Table 1):
    (1,7), (7,1), five (5,5) at time dilation 1..16, one (5,5) at 32·2^i for
    each extra dilated block, then the 1x1 projection."""
    C = model["conv_channels"]
    specs = [((1, 7), 1), ((7, 1), 1)] + [((5, 5), 2 ** i) for i in range(5)]
    specs += [((5, 5), 32 * 2 ** i) for i in range(model.get("num_extra_dilated_blocks", 0))]
    layers = []
    for i, ((kt, kf), dt) in enumerate(specs):
        layers.append({"kt": kt, "kf": kf, "dt": dt, "cin": in_channels if i == 0 else C,
                       "cout": C})
    layers.append({"kt": 1, "kf": 1, "dt": 1, "cin": C, "cout": model["conv_out_channels"]})
    return layers


def conv_work(model: dict, batch: int, frames: int, num_freq: int, train: bool,
              fused_chain: bool) -> List[Tuple[str, dict]]:
    """Every conv kernel's work in one step or call, as ``(kind, layer)``:
    the forward of each layer and, in training, the data gradient of each
    layer but the first and the weight gradient of each.  The kinds name
    `conv_bound`'s byte counts: the fused chain's for the layers between the
    first and the projection when `fused_chain`, the plain conv's
    otherwise."""
    layers = conv_layers(model)
    out = []
    for i, layer in enumerate(layers):
        chain = fused_chain and train and 0 < i < len(layers) - 1
        out.append(("conv_bn_act_fwd" if chain else "conv_dilated_fwd", layer))
        if train:
            if i > 0:
                out.append(("conv_dgrad" if chain else "conv_dilated_fwd",
                            {**layer, "cin": layer["cout"], "cout": layer["cin"]}))
            out.append(("conv_wgrad" if chain else "conv_dilated_wgrad", layer))
    return out


def conv_bound_ms(model: dict, batch: int, frames: int, num_freq: int, train: bool,
                  fused_chain: bool, dtype: str = "bfloat16") -> float:
    """Σ `conv_bound` over `conv_work`: the least conv time of a step or call."""
    return sum(
        conv_bound(kind, (batch, frames, num_freq, l["cin"]), l["kt"], l["kf"], l["dt"],
                   dtype, cout=l["cout"])["bound_ms"]
        for kind, l in conv_work(model, batch, frames, num_freq, train, fused_chain)
    )


def lstm_bound_ms(model: dict, batch: int, frames: int, train: bool,
                  dtype: str = "bfloat16") -> float:
    """The BiLSTM's least time a step or call: one two-direction walk where
    the batch is a multiple of 8 (`models/lstm.py::BiLSTM`), two
    one-direction walks otherwise; in training the backward besides."""
    H = model["lstm_dim"]
    if batch % 8 == 0:
        ms = lstm_bound(2, batch, dtype, H, frames)["bound_ms"]
        if train:
            ms += lstm_bwd_bound(2, batch, dtype, H, frames)["bound_ms"]
        return ms
    ms = 2 * lstm_bound(1, batch, dtype, H, frames)["bound_ms"]
    if train:
        ms += 2 * lstm_bwd_bound(1, batch, dtype, H, frames)["bound_ms"]
    return ms


def step_flops(model: dict, audio: dict, loss_name: str, batch: int, frames: int,
               train: bool) -> Dict[str, float]:
    """FLOPs of one train step (`train`) or one serving call, by part:
    ``conv``, ``lstm`` (input projection and recurrence), ``fc``, ``dsp``
    (STFT / iSTFT basis products) and ``total``.

    Training: each layer's forward, data gradient and weight gradient (the
    first conv has no data gradient); the recurrence's backward is two
    products (dh and dW_hh).  The DSP: the STFT of the mixture and of the
    target, forward only; with ``si_snr`` the iSTFT of the estimate
    (forward and data gradient) and of the target (forward).  Serving: every
    layer's forward, the mixture's STFT and the estimate's iSTFT."""
    B, T = batch, frames
    F = audio["num_freq"]
    n_fft = audio["n_fft"]
    H, E = model["lstm_dim"], model["emb_dim"]
    fc1 = model["fc1_dim"]
    conv = 0.0
    for i, l in enumerate(conv_layers(model)):
        rows, cols = conv_taps(T, F, l["kt"], l["kf"], l["dt"])
        fwd = 2.0 * l["cin"] * l["cout"] * B * rows * cols
        conv += fwd * ((3 if i > 0 else 2) if train else 1)
    lstm_in = model["conv_out_channels"] * F + E
    proj = 2 * (2.0 * B * T * lstm_in * 4 * H)  # two directions
    rec = 2 * (2.0 * B * T * H * 4 * H)
    fc = 2.0 * B * T * 2 * H * fc1 + 2.0 * B * T * fc1 * model["fc2_dim"]
    mult = 3 if train else 1
    transform = 2 * (2.0 * B * T * n_fft * F)  # the cos and the sin product of one signal
    if train:
        dsp = 2 * transform  # STFT of the mixture and of the target
        if loss_name == "si_snr":
            dsp += 2 * transform + transform  # iSTFT of the estimate (+ gradient), of the target
    else:
        dsp = 2 * transform  # STFT of the mixture, iSTFT of the estimate
    parts = {"conv": conv, "lstm": (proj + rec) * mult, "fc": fc * mult, "dsp": dsp}
    parts["total"] = sum(parts.values())
    return parts
