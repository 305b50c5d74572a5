"""The port's fused conv chain at the level of the chain and the model,
against the JAX package's (`voicesplit_tpu/ops/conv_fused.py::make_chain`,
its `MaskNet` and one train step with the chain on), and the port's model
with the chain on against itself with the chain off.

The slowest of the port's comparisons with JAX; they share the kernel-level
file's geometry and helpers (`tests/test_torch_conv_fused.py`) and run in a
file of their own, so that test workers that take whole files share them
out.  On the CPU the port runs its plain versions and the JAX side its
Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voicesplit_tpu.ops.conv_fused as jcf
from test_torch_conv_fused import (
    B, C, CHAIN_SPECS, DIMS, EPS, LR, PEAK_TOL, T, F, _assert_grads_close, _assert_peak_close, _batch,
    _chain_params, _config_text, _model_inputs, _np, _port_grads, _port_on,
)
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.ops.conv_fold import fold_input, unfold_output
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops import conv_fused as cf
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("act", ["mish", "relu"])
def test_chain_matches_jax_make_chain(act):
    """Value, statistics and all five gradients (fp32).  The inner layers'
    conv-bias gradients are analytically zero (a train-mode BatchNorm
    cancels a constant shift), so both sides hold summation noise there and
    an absolute floor is the comparison, as in `tests/test_conv_fused.py`."""
    rng = np.random.default_rng(8)
    specs = CHAIN_SPECS
    params = _chain_params(rng)
    y1 = rng.standard_normal((B, T, F, C)).astype(np.float32)
    cot = rng.standard_normal((B, T, F, C)).astype(np.float32)
    cot_j = fold_input(jnp.asarray(cot))  # zero pad column, as bn_act's backward emits

    jchain = jcf.make_chain(specs, T, F, act, EPS)

    def loss(y1f, ws, cbs, scales, biases):
        raw, means, vars_ = jchain(y1f, ws, cbs, scales, biases)
        return jnp.sum(raw * cot_j), (raw, means, vars_)

    jparams = [tuple(jnp.asarray(a) for a in group) for group in params]
    (_, (raw_j, means_j, vars_j)), grads_j = jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3, 4), has_aux=True
    )(fold_input(jnp.asarray(y1)), *jparams)

    y1_t = torch.from_numpy(y1).requires_grad_()
    tparams = [tuple(torch.from_numpy(a).requires_grad_() for a in group) for group in params]
    raw, means, vars_ = cf.make_chain(specs, act, EPS)(y1_t, *tparams)
    assert not means[0].requires_grad and not vars_[-1].requires_grad
    (raw * torch.from_numpy(cot)).sum().backward()

    _assert_peak_close(raw.detach().numpy(), _np(unfold_output(raw_j, F)), PEAK_TOL, "raw")
    for a, b in zip(means + vars_, tuple(means_j) + tuple(vars_j)):
        np.testing.assert_allclose(a.numpy(), _np(b), rtol=1e-4, atol=1e-4)

    _assert_peak_close(y1_t.grad.numpy(), _np(unfold_output(grads_j[0], F)), 5e-4, "d_y1")
    names = ["d_W", "d_conv_bias", "d_scale", "d_bias"]
    for name, got_group, want_group in zip(names, tparams, grads_j[1:]):
        for idx, (p, want) in enumerate(zip(got_group, want_group)):
            if name == "d_conv_bias":
                np.testing.assert_allclose(
                    p.grad.numpy(), _np(want), rtol=5e-3, atol=2e-3, err_msg=f"{name}[{idx}]"
                )
            else:
                _assert_peak_close(p.grad.numpy(), _np(want), 5e-4, f"{name}[{idx}]")


@pytest.mark.parametrize("activation", ["mish", "relu"])
def test_masknet_chain_matches_jax_chain(activation, monkeypatch):
    """Train-mode `MaskNet`, chain on in both packages (the JAX switch is
    TPU-only, so its function is patched as `tests/test_conv_fused.py`
    does): mask, every running statistic and every gradient (fp32).  The
    inputs' seed keeps every pre-activation at least 1e-5 away from relu's
    kink, where round-off alone would decide a gate."""
    port = MaskNet(activation=activation, **DIMS).train()
    params, stats = weights.random_jax_variables(port, seed=1)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    spec, emb, cot = _model_inputs(5)
    jm = JaxMaskNet(activation=activation, **DIMS)
    monkeypatch.setattr(jcf, "fused_chain_enabled", lambda: True)

    def loss(p):
        mask, upd = jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb),
            train=True, mutable=["batch_stats"],
        )
        return jnp.sum(mask * cot), (mask, upd["batch_stats"])

    (_, (mask_j, new_stats)), grads = jax.value_and_grad(loss, has_aux=True)(params)

    _port_on(monkeypatch)
    assert port._use_fused_chain()
    with torch.no_grad():
        before = {k: v.clone() for k, v in port.state_dict().items()}
        mask = port(torch.from_numpy(spec), torch.from_numpy(emb))
        port.load_state_dict(before)
    np.testing.assert_allclose(mask.numpy(), _np(mask_j), atol=2e-5)
    got = _port_grads(port, spec, emb, cot)
    want = {k: v.numpy() for k, v in weights.params_from_jax(jax.device_get(grads)).items()}
    _assert_grads_close(got, want, 1e-4)
    want_sd = weights.state_dict_from_jax(params, jax.device_get(new_stats))
    for k, v in port.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-5, err_msg=k)
            assert not torch.equal(v, before[k]), k


@pytest.mark.parametrize(
    "activation,dtype", [("mish", "float32"), ("relu", "float32"), ("mish", "bfloat16")]
)
def test_masknet_chain_on_matches_chain_off(activation, dtype, monkeypatch):
    """The port with the chain on against itself with the chain off: mask,
    gradients, running statistics.  fp32: sums in another order.  bf16: the
    chain normalizes in fp32 before one rounding where the unfused op
    rounds the scale, the shift and every step of the activation, and the
    gradients pass back through six such layers: by size and direction.
    (relu in bf16 is left out: the two roundings of z also decide gates
    differently, which no elementwise tolerance describes.)"""
    torch.manual_seed(0)
    port = MaskNet(activation=activation, compute_dtype=getattr(torch, dtype), **DIMS).train()
    weights.init_random_(port, seed=3)
    spec, emb, cot = _model_inputs(4)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    out = {}
    for on in (False, True):
        port.load_state_dict(before)
        _port_on(monkeypatch, on)
        assert port._use_fused_chain() == on
        grads = _port_grads(port, spec, emb, cot)
        with torch.no_grad():
            port.load_state_dict(before)
            mask = port(torch.from_numpy(spec), torch.from_numpy(emb)).numpy()
        out[on] = (mask, grads, {k: v.numpy().copy() for k, v in port.state_dict().items()})
    fp32 = dtype == "float32"
    np.testing.assert_allclose(out[True][0], out[False][0], atol=2e-5 if fp32 else 2e-2)
    for k, v in out[False][2].items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(out[True][2][k], v, atol=1e-5 if fp32 else 2e-2, err_msg=k)
    if fp32:
        _assert_grads_close(out[True][1], out[False][1], 1e-4)
    else:
        signal = {k: v for k, v in out[False][1].items() if not k.endswith("conv.bias")}
        _assert_grads_close(out[True][1], signal, 0.2)
        for k, want in signal.items():
            got = out[True][1][k].ravel()
            cos = got @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want))
            assert cos >= (0.6 if k.startswith("conv") else 0.98), (k, cos)


def test_train_step_with_the_chain_matches_jax(monkeypatch):
    """One `make_train_step` step of each package with the chain on, from
    the same weights and batch (fp32, si_snr, Adam), as
    `tests/test_torch_train.py` compares them with the chain off: loss and
    grad_norm to summation order, running statistics to 1e-5, the gradients
    (read from Adam's first moment, 0.1·g) within 5e-3 of the model's
    largest, every weight within 2·lr."""
    text = _config_text()
    jc, tc = jax_config(text), load_config_from_str(text)
    model = make_masknet(tc, device="cpu")
    params, stats = weights.random_jax_variables(model, 0)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    ap = make_audio_processor(tc, device="cpu")
    optimizer = make_optimizer(tc, model)
    state = create_train_state(model, optimizer)
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats, opt_state=tx.init(params)
    )
    batch = _batch(2, seed=1)

    monkeypatch.setattr(jcf, "fused_chain_enabled", lambda: True)
    jstep = jax_steps.make_train_step(jc, jax_make_masknet(jc), jax_audio_processor(jc), tx, donate=False)
    jstate, jm = jstep(jstate, batch)

    _port_on(monkeypatch)
    calls = []
    chain_apply = cf._Chain.apply
    monkeypatch.setattr(cf._Chain, "apply", lambda *a: calls.append(1) or chain_apply(*a))
    m = make_train_step(tc, model, ap, optimizer)(state, batch)
    assert calls == [1]  # the step went through the chain

    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    want_sd = weights.state_dict_from_jax(
        jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
    )
    got_sd = model.state_dict()
    for k, want in want_sd.items():
        tol = 1e-5 if k.endswith((".mean", ".var")) else 2 * LR + 1e-7
        np.testing.assert_allclose(got_sd[k].numpy(), want.numpy(), atol=tol, rtol=0, err_msg=k)
    mu = weights.params_from_jax(weights._adam_state(jax.device_get(jstate.opt_state)).mu)
    exp_avg = {k: optimizer.state[p]["exp_avg"].numpy() for k, p in model.named_parameters()}
    _assert_grads_close(exp_avg, {k: v.numpy() for k, v in mu.items()}, 5e-3)
