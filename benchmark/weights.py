"""The mask network's state, made from the seed.

`layout` names every leaf of the state that the benchmark hands to the
program (through ``load_state_dict``) and to the reference: the program's
state-dict names and shapes, which are its interface.  `make` draws all of
them in one call on the device from the seed and scales each leaf by its
kind, so that a forward pass keeps its activations at about unit size:
He-normal conv and fc1 weights, 1/sqrt(fan-in) for the LSTM's and fc2's,
small biases, BatchNorm affines near (1, 0) and running statistics near
(0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from costs import conv_layers

Leaf = Tuple[str, Tuple[int, ...], float, float]  # name, shape, offset, scale


def layout(config: dict) -> List[Leaf]:
    model = config["model"]
    num_freq = config["audio"]["voicefilter"]["num_freq"]
    out: List[Leaf] = []
    for i, l in enumerate(conv_layers(model)):
        n = f"conv{i + 1}"
        fan_in = l["cin"] * l["kt"] * l["kf"]
        out.append((f"{n}.conv.weight", (l["cout"], l["cin"], l["kt"], l["kf"]), 0.0,
                    math.sqrt(2.0 / fan_in)))
        out.append((f"{n}.conv.bias", (l["cout"],), 0.0, 0.02))
        out.append((f"{n}.bn.scale", (l["cout"],), 1.0, 0.1))
        out.append((f"{n}.bn.bias", (l["cout"],), 0.0, 0.1))
        out.append((f"{n}.bn.mean", (l["cout"],), 0.0, 0.1))
        out.append((f"{n}.bn.var", (l["cout"],), 0.0, 0.2))  # exp() of this, below
    H = model["lstm_dim"]
    lstm_in = model["conv_out_channels"] * num_freq + model["emb_dim"]
    for d in ("fwd", "bwd"):
        out.append((f"lstm.{d}_w_ih", (lstm_in, 4 * H), 0.0, 1.0 / math.sqrt(lstm_in)))
        out.append((f"lstm.{d}_w_hh", (H, 4 * H), 0.0, 1.0 / math.sqrt(H)))
        out.append((f"lstm.{d}_b", (4 * H,), 0.0, 0.1))
    fc1, fc2 = model["fc1_dim"], model["fc2_dim"]
    out.append(("fc1.weight", (fc1, 2 * H), 0.0, math.sqrt(2.0 / (2 * H))))
    out.append(("fc1.bias", (fc1,), 0.0, 0.02))
    out.append(("fc2.weight", (fc2, fc1), 0.0, 1.0 / math.sqrt(fc1)))
    out.append(("fc2.bias", (fc2,), 0.0, 0.02))
    return out


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of `layout`, fp32 on `device`, from one draw of a
    generator on that device seeded with `seed`."""
    leaves = layout(config)
    total = sum(math.prod(shape) for _, shape, _, _ in leaves)
    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, offset, scale in leaves:
        n = math.prod(shape)
        v = flat[at:at + n].view(shape) * scale + offset
        out[name] = torch.exp(v) if name.endswith(".bn.var") else v
        at += n
    return out
