"""Weights: JAX variable trees → the port's ``state_dict``, optax's Adam
moments → the port's optimizer, random weights from a seed, and save/load
of the port's own weight files.

JAX names (flax variables of `voicesplit_tpu.models.masknet.MaskNet`):

    params/conv{i}/Conv_0/{kernel [kt, kf, Cin, Cout] HWIO, bias}
    params/conv{i}/BatchNorm_0/{scale, bias}
    batch_stats/conv{i}/BatchNorm_0/{mean, var}
    params/lstm/{fwd,bwd}_{w_ih [in, 4H], w_hh [H, 4H], b [4H]}
    params/fc{1,2}/{kernel [in, out], bias}

The streaming model's tree (`make_masknet(config, streaming=True)`) has
``lstm/fwd_*`` only and an ``fc1`` kernel of ``[H, fc1]``; every function
here takes either tree, its LSTM entries by name.

Conv kernels go from HWIO to OIHW and Dense kernels are transposed; the
LSTM keeps its JAX layout.  The same mapping carries any tree shaped like
``params``, such as Adam's first and second moments.  The trees are nested
dicts of numpy arrays (optax states as their namedtuples), so this module
needs neither JAX nor flax nor optax.  `train.checkpoint.load_jax_checkpoint`
reads such trees from a JAX ``.msgpack`` checkpoint.

The speaker encoder (`voicesplit_tpu.models.speaker_encoder.SpeakerEncoder`)
has ``lstm{i}/fwd_{w_ih, w_hh, b}`` and ``proj/{kernel, bias}``; GE2E
training's tree wraps it as ``{enc, w, b}`` and its optax state is
``chain(clip_by_global_norm, adam)``: `encoder_params_from_jax` and
`encoder_optimizer_state_from_jax` carry those.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from voicesplit_tpu_torch.models.masknet import MaskNet

Tree = Mapping[str, object]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_names(params: Tree):
    return sorted((k for k in params if k.startswith("conv")), key=lambda k: int(k[4:]))


def params_from_jax(tree: Tree) -> Dict[str, torch.Tensor]:
    """``{port parameter name: tensor}`` from any tree shaped like the JAX
    ``params`` (the parameters, their gradients, Adam's moments)."""
    out: Dict[str, torch.Tensor] = {}
    for name in _conv_names(tree):
        conv, bn = tree[name]["Conv_0"], tree[name]["BatchNorm_0"]
        out[f"{name}.conv.weight"] = _t(np.transpose(np.asarray(conv["kernel"]), (3, 2, 0, 1)))
        out[f"{name}.conv.bias"] = _t(conv["bias"])
        out[f"{name}.bn.scale"] = _t(bn["scale"])
        out[f"{name}.bn.bias"] = _t(bn["bias"])
    for k, v in tree["lstm"].items():
        out[f"lstm.{k}"] = _t(v)
    for fc in ("fc1", "fc2"):
        out[f"{fc}.weight"] = _t(np.asarray(tree[fc]["kernel"]).T)
        out[f"{fc}.bias"] = _t(tree[fc]["bias"])
    return out


def state_dict_from_jax(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The port's `MaskNet` state_dict from JAX ``params`` / ``batch_stats``."""
    sd = params_from_jax(params)
    for name in _conv_names(batch_stats):
        stats = batch_stats[name]["BatchNorm_0"]
        sd[f"{name}.bn.mean"] = _t(stats["mean"])
        sd[f"{name}.bn.var"] = _t(stats["var"])
    return sd


def _adam_state(opt_state):
    """The ``ScaleByAdamState`` (count, mu, nu) inside an optax chain state,
    given as optax's namedtuples or as the nested dicts a JAX checkpoint
    holds (`train.checkpoint.load_jax_checkpoint`)."""
    keys = ("count", "mu", "nu")
    if all(hasattr(opt_state, k) for k in keys):
        return opt_state
    if isinstance(opt_state, Mapping):
        if all(k in opt_state for k in keys):
            return SimpleNamespace(**{k: opt_state[k] for k in keys})
        subs = list(opt_state.values())
    elif isinstance(opt_state, (tuple, list)):
        subs = opt_state
    else:
        return None
    for sub in subs:
        found = _adam_state(sub)
        if found is not None:
            return found
    return None


def _load_adam(opt_state, model: nn.Module, optimizer: torch.optim.Optimizer, mapping) -> int:
    """Adam's update count and moments of an optax state into `optimizer`
    (over `model`'s parameters), the moments' trees carried by `mapping`."""
    adam = _adam_state(opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in the optimizer state")
    count = int(np.asarray(adam.count))
    mu, nu = mapping(adam.mu), mapping(adam.nu)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": mu[name].to(p.device, p.dtype),
            "exp_avg_sq": nu[name].to(p.device, p.dtype),
        }
    return count


def optimizer_state_from_jax(
    opt_state, model: MaskNet, optimizer: torch.optim.Optimizer
) -> int:
    """Load Adam's update count and moments from a JAX optax state (a tree of
    numpy arrays, e.g. ``jax.device_get(state.opt_state)`` or a JAX
    checkpoint's ``opt_state``) into
    `optimizer`, whose parameters are `model`'s.  Returns the update
    count, which the port's `TrainState.step` must carry for the
    learning-rate schedule."""
    return _load_adam(opt_state, model, optimizer, params_from_jax)


def encoder_params_from_jax(tree: Tree) -> Dict[str, torch.Tensor]:
    """The state dict of a `SpeakerEncoder` from the JAX encoder's params
    (``lstm{i}/fwd_*`` keep their layout, ``proj/kernel`` is transposed), or
    of a `train.encoder.GE2E` (``enc.*``, ``w``, ``b``) from GE2E training's
    ``{enc, w, b}``; any tree shaped like them (gradients, Adam's moments)."""
    if "enc" in tree:
        sd = {f"enc.{k}": v for k, v in encoder_params_from_jax(tree["enc"]).items()}
        sd["w"], sd["b"] = _t(tree["w"]).reshape(()), _t(tree["b"]).reshape(())
        return sd
    sd = {}
    for layer in sorted((k for k in tree if k.startswith("lstm")), key=lambda k: int(k[4:])):
        for k, v in tree[layer].items():
            sd[f"{layer}.{k}"] = _t(v)
    sd["proj.weight"] = _t(np.asarray(tree["proj"]["kernel"]).T)
    sd["proj.bias"] = _t(tree["proj"]["bias"])
    return sd


def encoder_optimizer_state_from_jax(
    opt_state, model: nn.Module, optimizer: torch.optim.Optimizer
) -> int:
    """Load the update count and Adam's moments of GE2E training's optax
    state (``chain(clip_by_global_norm(3.0), adam(lr))``: the clip keeps no
    state, Adam's ``(count, mu, nu)`` sits in the chain's second part, its
    moments shaped like ``{enc, w, b}``) into `optimizer` over `model` (a
    `train.encoder.GE2E`).  Returns the update count."""
    return _load_adam(opt_state, model, optimizer, encoder_params_from_jax)


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


_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated at ±2


def lecun_normal_(w: torch.Tensor, fan_in: int, g: torch.Generator) -> None:
    """flax's default kernel init in place: LeCun normal as a normal
    truncated at ±2σ with its variance corrected."""
    std = fan_in ** -0.5 / _TRUNC_STD
    fresh = torch.empty(w.shape)
    torch.nn.init.trunc_normal_(fresh, 0.0, std, -2 * std, 2 * std, generator=g)
    w.copy_(fresh)


def init_for_training_(model: MaskNet, seed: int = 0) -> MaskNet:
    """A fresh model as the JAX package initializes it, in place, drawn from
    a ``torch.Generator`` seeded with `seed` (the same distributions, not
    the same numbers as ``model.init`` there): conv and dense kernels LeCun
    normal (flax's truncated normal at ±2σ with its variance correction),
    their biases 0, BatchNorm scale 1, bias 0, running mean 0 and variance
    1, the LSTM uniform(±1/sqrt(H))."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name in model.block_names:
            block = getattr(model, name)
            w = block.conv.weight  # [Cout, Cin, kt, kf]
            lecun_normal_(w, w.shape[1] * w.shape[2] * w.shape[3], g)
            block.conv.bias.zero_()
            block.bn.scale.fill_(1.0)
            block.bn.bias.zero_()
            block.bn.mean.zero_()
            block.bn.var.fill_(1.0)
        s = model.lstm.hidden ** -0.5
        for p in model.lstm.parameters():
            p.copy_(torch.empty(p.shape).uniform_(-s, s, generator=g))
        for fc in (model.fc1, model.fc2):
            lecun_normal_(fc.weight, fc.weight.shape[1], g)
            fc.bias.zero_()
    return model


def init_encoder_for_training_(encoder: nn.Module, seed: int = 0) -> nn.Module:
    """A fresh `SpeakerEncoder` as the JAX package initializes it, in place,
    from a ``torch.Generator`` seeded with `seed` (the same distributions,
    not the same numbers): every LSTM parameter uniform(±1/sqrt(H)), the
    projection's kernel LeCun normal and its bias 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        s = encoder.lstm_hidden ** -0.5
        for i in range(encoder.lstm_layers):
            for p in getattr(encoder, f"lstm{i}").parameters():
                p.copy_(torch.empty(p.shape).uniform_(-s, s, generator=g))
        lecun_normal_(encoder.proj.weight, encoder.proj.weight.shape[1], g)
        encoder.proj.bias.zero_()
    return encoder


def save(model: MaskNet, path: str) -> None:
    """Write the port's weights as a ``torch.save`` file."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load(model: MaskNet, path: str) -> MaskNet:
    """Load weights written by `save` into `model` (on its device)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(sd)
    return model
