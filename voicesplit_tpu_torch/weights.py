"""Weights: JAX variable trees → the port's ``state_dict``, random weights
from a seed, and save/load of the port's own weight files.

JAX names (flax variables of `voicesplit_tpu.models.masknet.MaskNet`):

    params/conv{i}/Conv_0/{kernel [kt, kf, Cin, Cout] HWIO, bias}
    params/conv{i}/BatchNorm_0/{scale, bias}
    batch_stats/conv{i}/BatchNorm_0/{mean, var}
    params/lstm/{fwd,bwd}_{w_ih [in, 4H], w_hh [H, 4H], b [4H]}
    params/fc{1,2}/{kernel [in, out], bias}

Conv kernels go from HWIO to OIHW and Dense kernels are transposed; the
LSTM keeps its JAX layout.  The trees are nested dicts of numpy arrays, so
this module needs neither JAX nor flax.  Loading a JAX ``.msgpack``
checkpoint is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from voicesplit_tpu_torch.models.masknet import MaskNet

Tree = Mapping[str, object]


def state_dict_from_jax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The port's `MaskNet` state_dict from JAX ``params`` / ``batch_stats``."""

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd: Dict[str, torch.Tensor] = {}
    conv_names = sorted((k for k in params if k.startswith("conv")), key=lambda k: int(k[4:]))
    for name in conv_names:
        conv, bn = params[name]["Conv_0"], params[name]["BatchNorm_0"]
        stats = batch_stats[name]["BatchNorm_0"]
        sd[f"{name}.conv.weight"] = t(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        sd[f"{name}.conv.bias"] = t(conv["bias"])
        sd[f"{name}.bn.scale"] = t(bn["scale"])
        sd[f"{name}.bn.bias"] = t(bn["bias"])
        sd[f"{name}.bn.mean"] = t(stats["mean"])
        sd[f"{name}.bn.var"] = t(stats["var"])
    for k, v in params["lstm"].items():
        sd[f"lstm.{k}"] = t(v)
    for fc in ("fc1", "fc2"):
        sd[f"{fc}.weight"] = t(np.asarray(params[fc]["kernel"]).T)
        sd[f"{fc}.bias"] = t(params[fc]["bias"])
    return sd


def random_jax_variables(model: MaskNet, seed: int = 0) -> Tuple[dict, dict]:
    """Random ``(params, batch_stats)`` in the JAX layout for `model`'s widths,
    made with numpy from `seed`.

    Kernels are LeCun-normal and the LSTM uniform(±1/sqrt(H)), as the JAX
    initializers draw them; biases, BatchNorm affines and running
    statistics are random too (not 0/1), so a mapping bug cannot hide.
    """
    rng = np.random.default_rng(seed)

    def normal(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    def uniform(shape, lo, hi):
        return rng.uniform(lo, hi, shape).astype(np.float32)

    params: dict = {}
    stats: dict = {}
    for name in model.block_names:
        w = getattr(model, name).conv.weight  # [Cout, Cin, kt, kf]
        cout, cin, kt, kf = w.shape
        params[name] = {
            "Conv_0": {
                "kernel": normal((kt, kf, cin, cout), kt * kf * cin),
                "bias": uniform((cout,), -0.1, 0.1),
            },
            "BatchNorm_0": {
                "scale": uniform((cout,), 0.5, 1.5),
                "bias": uniform((cout,), -0.1, 0.1),
            },
        }
        stats[name] = {
            "BatchNorm_0": {
                "mean": uniform((cout,), -0.2, 0.2),
                "var": uniform((cout,), 0.5, 2.0),
            }
        }
    lstm = model.lstm
    s = lstm.hidden ** -0.5
    params["lstm"] = {
        k: uniform(tuple(p.shape), -s, s) for k, p in lstm.named_parameters()
    }
    for fc in ("fc1", "fc2"):
        out_f, in_f = getattr(model, fc).weight.shape
        params[fc] = {"kernel": normal((in_f, out_f), in_f), "bias": uniform((out_f,), -0.1, 0.1)}
    return params, stats


def init_random_(model: MaskNet, seed: int = 0) -> MaskNet:
    """Load random weights from `seed` (see `random_jax_variables`) in place."""
    sd = state_dict_from_jax(*random_jax_variables(model, seed))
    model.load_state_dict(sd)
    return model


def save(model: MaskNet, path: str) -> None:
    """Write the port's weights as a ``torch.save`` file."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load(model: MaskNet, path: str) -> MaskNet:
    """Load weights written by `save` into `model` (on its device)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model
