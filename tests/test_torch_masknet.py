"""Eval-mode mask network: the port against the JAX `MaskNet`.

Narrow widths (F=33, 8 conv channels, LSTM 16, T=32).  The JAX-layout
variables come from `voicesplit_tpu_torch.weights.random_jax_variables`
(random running statistics, not 0/1), go to the JAX model as they are and
to the port through `state_dict_from_jax`.  On the CPU the JAX BiLSTM runs
its `lax.scan` path.
"""

import importlib
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.ops.bn_act import folded_bn_act_eval
from voicesplit_tpu.ops.conv_fold import fold_input, unfold_output
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops.bn_act import bn_act_eval

REPO = pathlib.Path(__file__).resolve().parents[1]
B, T = 2, 32
DIMS = dict(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33, conv_channels=8)
# fp32: reassociated conv / matmul sums only.  bf16: both sides round every
# conv, BN and matmul output to bf16 (at different points), and the JAX
# CPU scan also carries h and c in bf16 where the port's kernel semantics
# carry them in fp32 — a few bf16 ulps of the sigmoid's input (about 1e-3
# of mask at these widths; 1e-2 keeps a 10x margin).
MASK_ATOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (B, T, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((B, DIMS["emb_dim"])).astype(np.float32)
    return spec, emb


def _models(activation, dtype, seed=0):
    port = MaskNet(activation=activation, compute_dtype=getattr(torch, dtype), **DIMS).eval()
    params, stats = weights.random_jax_variables(port, seed)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    jax_model = JaxMaskNet(activation=activation, compute_dtype=jnp.dtype(dtype), **DIMS)
    return port, jax_model, {"params": params, "batch_stats": stats}


def test_random_variables_have_the_jax_tree():
    port = MaskNet(**DIMS)
    params, stats = weights.random_jax_variables(port, 0)
    spec, emb = _inputs()
    v = JaxMaskNet(**DIMS).init(jax.random.PRNGKey(0), jnp.asarray(spec), jnp.asarray(emb))
    shapes = lambda tree: jax.tree_util.tree_map(lambda a: tuple(np.shape(a)), tree)
    assert shapes(params) == shapes(v["params"])
    assert shapes(stats) == shapes(v["batch_stats"])
    assert set(weights.state_dict_from_jax(params, stats)) == set(port.state_dict())


@pytest.mark.parametrize("activation", ["relu", "mish"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masknet_eval_matches_jax(activation, dtype):
    port, jax_model, variables = _models(activation, dtype, seed=1)
    spec, emb = _inputs(2)
    want = jax_model.apply(variables, jnp.asarray(spec), jnp.asarray(emb), train=False)
    with torch.inference_mode():
        got = port(torch.from_numpy(spec), torch.from_numpy(emb))
    assert got.dtype == torch.float32 and got.shape == (B, T, DIMS["num_freq"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=MASK_ATOL[dtype])


@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_conv_features_flatten_frequency_major(activation):
    """[B, T, F, 8] flattened as f·C + c, as the JAX model does, so a JAX
    checkpoint's LSTM w_ih rows line up unpermuted (fp32)."""
    port, jax_model, variables = _models(activation, "float32", seed=3)
    spec, _ = _inputs(4)
    want = jax_model.apply(
        variables, jnp.asarray(spec), method=lambda m, s: m.conv_features(s, False)
    )
    with torch.inference_mode():
        got = port.conv_features(torch.from_numpy(spec))
    assert got.shape == (B, T, 8 * DIMS["num_freq"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("act", ["relu", "mish"])
def test_bn_act_eval_matches_folded_op(act):
    rng = np.random.default_rng(5)
    C, F = 4, 7
    x = rng.standard_normal((B, T, F, C)).astype(np.float32)  # NHWC
    scale, bias = rng.uniform(0.5, 1.5, C), rng.uniform(-0.2, 0.2, C)
    mean, var = rng.uniform(-0.3, 0.3, C), rng.uniform(0.5, 2.0, C)
    stats = [a.astype(np.float32) for a in (scale, bias, mean, var)]
    want = unfold_output(
        folded_bn_act_eval(fold_input(jnp.asarray(x)), *map(jnp.asarray, stats), F, act), F
    )
    got = bn_act_eval(
        torch.from_numpy(x).permute(0, 3, 1, 2), *map(torch.from_numpy, stats), act
    ).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_weights_save_load_roundtrip(tmp_path):
    port, _, _ = _models("mish", "float32", seed=6)
    path = tmp_path / "w.pt"
    weights.save(port, str(path))
    other = weights.load(MaskNet(activation="mish", **DIMS).eval(), str(path))
    spec, emb = _inputs(7)
    with torch.inference_mode():
        a = port(torch.from_numpy(spec), torch.from_numpy(emb))
        b = other(torch.from_numpy(spec), torch.from_numpy(emb))
    assert torch.equal(a, b)


def test_make_masknet_reads_config():
    cfg = load_config_from_str((REPO / "configs" / "voicesplit.json").read_text())
    cfg.model.lstm_dim, cfg.model.fc1_dim = 8, 12
    model = make_masknet(cfg, device="cpu")
    assert model.compute_dtype == torch.bfloat16
    assert model.conv1.activation == "mish"
    assert model.lstm.fwd_w_ih.shape == (8 * 601 + 256, 32)
    cfg.model.causal = True
    causal = make_masknet(cfg, device="cpu")
    assert causal.causal and causal.conv_context_right == 0
    assert causal.lstm.fwd_w_ih.shape == (8 * 601 + 256, 32)


def test_port_imports_nothing_of_jax():
    """Static check: no module of the port names JAX, flax or the JAX package."""
    pkg = pathlib.Path(importlib.import_module("voicesplit_tpu_torch").__file__).parent
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                mod = words[1].split(".")[0]
                assert mod not in ("jax", "jaxlib", "flax", "optax", "voicesplit_tpu"), (
                    f"{path}: {line}"
                )
