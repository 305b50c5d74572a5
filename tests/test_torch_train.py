"""Training: the port's train-mode BatchNorm op, train-mode `MaskNet`, train
and eval steps, multi-step loop and EMA against the JAX package's.

Small config in the style of `tests/test_train.py` (short clips, LSTM 16,
8 conv channels, and a 128-point FFT so both packages run fast on the
CPU).  Weights and batches are numpy arrays from a seed; the JAX tree of
weights goes to the JAX step as it is and to the port through
`state_dict_from_jax`.  On the CPU the JAX BiLSTM runs its `lax.scan` path
and the port the kernels' plain versions.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.masknet import make_masknet as jax_make_masknet
from voicesplit_tpu.ops.bn_act import folded_bn_act_train
from voicesplit_tpu.ops.conv_fold import fold_input, unfold_output
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import MaskNet, make_masknet
from voicesplit_tpu_torch.ops.bn_act import bn_act_train
from voicesplit_tpu_torch.train import (
    create_train_state,
    learning_rate,
    make_ema_update,
    make_eval_step,
    make_multi_train_step,
    make_optimizer,
    make_train_step,
    param_count,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 40
L = HOP * FRAMES
LR = 1e-3


# ---------------------------------------------------------------------------
# BatchNorm + activation, train mode
# ---------------------------------------------------------------------------

# fp32: summation order of the statistics and sums.  bf16: both sides
# normalize and activate in bf16; softplus is computed differently inside
# mish, which moves a bf16 rounding of z (up to one ulp of |y| ~ 4 is 2e-2)
BN_ATOL = {"float32": 1e-5, "bfloat16": 3e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["relu", "mish"])
def test_bn_act_train_matches_folded_op(act, dtype):
    rng = np.random.default_rng(0)
    B, T, F, C = 2, 9, 7, 4  # odd F: the JAX op's folded pad column is in play
    x = (2.0 * rng.standard_normal((B, T, F, C)) + 0.3).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, C).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, C).astype(np.float32)
    dy = rng.standard_normal((B, T, F, C)).astype(np.float32)
    x_j, dy_j = jnp.asarray(x).astype(dtype), jnp.asarray(dy).astype(dtype)

    def jfn(xx, s, b):
        y, m, v = folded_bn_act_train(fold_input(xx), s, b, F, act)
        return unfold_output(y, F), m, v

    (y, mean, var), vjp = jax.vjp(jfn, x_j, jnp.asarray(scale), jnp.asarray(bias))
    dx, dscale, dbias = vjp((dy_j, jnp.zeros_like(mean), jnp.zeros_like(var)))

    nchw = lambda a: torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    x_t = nchw(x_j).contiguous().requires_grad_()
    s_t, b_t = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y_t, mean_t, var_t = bn_act_train(x_t, s_t, b_t, act)
    y_t.backward(nchw(dy_j))
    assert y_t.dtype == x_t.dtype and mean_t.dtype == torch.float32
    assert s_t.grad.dtype == torch.float32 and not mean_t.requires_grad
    f32 = lambda a: np.array(jnp.asarray(a).astype(jnp.float32))
    tol = BN_ATOL[dtype]
    np.testing.assert_allclose(y_t.detach().float().permute(0, 2, 3, 1).numpy(), f32(y), atol=tol)
    np.testing.assert_allclose(mean_t.numpy(), f32(mean), atol=1e-6)
    np.testing.assert_allclose(var_t.numpy(), f32(var), atol=1e-5)
    np.testing.assert_allclose(x_t.grad.float().permute(0, 2, 3, 1).numpy(), f32(dx), atol=tol)
    # dscale / dbias sum the bf16 dz over all 126 positions
    np.testing.assert_allclose(s_t.grad.numpy(), f32(dscale), atol=tol * 4)
    np.testing.assert_allclose(b_t.grad.numpy(), f32(dbias), atol=tol * 4)


# ---------------------------------------------------------------------------
# Train-mode MaskNet
# ---------------------------------------------------------------------------

DIMS = dict(num_freq=33, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=33, conv_channels=8)


def _assert_grads_close(got: dict, want: dict, rel: float) -> None:
    """Per parameter, within `rel` of the largest gradient of the model.
    The conv biases feed a train-mode BatchNorm, so their exact gradient is
    zero and both sides hold round-off there; the global scale covers it."""
    scale = max(np.abs(v).max() for v in want.values())
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=rel * scale, rtol=0, err_msg=k)


@pytest.mark.parametrize("batch", [2, 8])
@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_masknet_train_mode_grads_and_running_stats_match_jax(activation, batch):
    """Gradients of every parameter and the new running statistics after one
    train-mode forward (fp32; B=8 takes the two-direction LSTM path)."""
    port = MaskNet(activation=activation, **DIMS).train()
    params, stats = weights.random_jax_variables(port, seed=1)
    port.load_state_dict(weights.state_dict_from_jax(params, stats))
    rng = np.random.default_rng(2)
    spec = rng.uniform(0, 1, (batch, 32, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((batch, DIMS["emb_dim"])).astype(np.float32)
    cot = rng.standard_normal((batch, 32, DIMS["num_freq"])).astype(np.float32)
    jm = JaxMaskNet(activation=activation, **DIMS)

    def loss(p):
        mask, upd = jm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb),
            train=True, mutable=["batch_stats"],
        )
        return jnp.sum(mask * cot), upd["batch_stats"]

    grads, new_stats = jax.grad(loss, has_aux=True)(params)
    (port(torch.from_numpy(spec), torch.from_numpy(emb)) * torch.from_numpy(cot)).sum().backward()
    want_g = {k: v.numpy() for k, v in weights.params_from_jax(jax.device_get(grads)).items()}
    _assert_grads_close({k: p.grad.numpy() for k, p in port.named_parameters()}, want_g, 1e-5)
    want_sd = weights.state_dict_from_jax(params, jax.device_get(new_stats))
    for k, v in port.state_dict().items():
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-6, err_msg=k)


def test_dropout_config_serves_in_eval_mode():
    """A model trained with dropout is served as the JAX package serves it
    (dropout off in eval mode): `separate_batch` against the JAX model's
    mask applied the same way, fp32 to the STFTs' round-off."""
    from voicesplit_tpu_torch.cli.separate import separate_batch

    text = json.loads(_config_text("float32", "si_snr", "voicesplit"))
    text["model"]["dropout"] = 0.1
    pair = Pair(json.dumps(text))
    assert pair.jmodel.dropout == 0.1
    batch = _batch(2, seed=8)
    got = separate_batch(pair.model, pair.ap, batch["mixed_wav"], batch["emb"])
    spec, phase = pair.jap.wav2spec_batch(jnp.asarray(batch["mixed_wav"]))
    mask = pair.jmodel.apply(
        {"params": pair.params, "batch_stats": pair.stats}, spec, jnp.asarray(batch["emb"]),
        train=False,
    )
    want = pair.jap.spec2wav_batch(mask * spec, phase, length=L)
    assert got.shape == (2, L)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------------------
# Train / eval steps against the JAX package
# ---------------------------------------------------------------------------


def _config_text(dtype, loss, model_name, weight_decay=0.0, decay_steps=None, clip=None):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = L / 16000
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
    d["model_name"] = model_name
    d["loss"]["loss_name"] = loss
    d["train_config"].update(
        compute_dtype=dtype, learning_rate=LR, weight_decay=weight_decay,
        lr_decay_steps=decay_steps, grad_clip_norm=clip,
    )
    return json.dumps(d)


def _batch(B, seed):
    """A tone in noise under a tone, one item shorter than the clip."""
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    target = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (B, 1)) * t)
    mixed = target + 0.2 * np.sin(2 * np.pi * rng.uniform(400, 900, (B, 1)) * t)
    mixed += 0.02 * rng.standard_normal((B, L))
    wav_len = np.full((B,), L, np.int32)
    wav_len[-1] = L - 200
    return {
        "mixed_wav": mixed.astype(np.float32),
        "target_wav": target.astype(np.float32),
        "emb": rng.standard_normal((B, 16)).astype(np.float32),
        "wav_len": wav_len,
    }


class Pair:
    """The same config, weights and optimizer state in both packages."""

    def __init__(self, text, seed=0):
        self.jc, self.tc = jax_config(text), load_config_from_str(text)
        self.model = make_masknet(self.tc, device="cpu")
        self.params, self.stats = weights.random_jax_variables(self.model, seed)
        self.model.load_state_dict(weights.state_dict_from_jax(self.params, self.stats))
        self.ap = make_audio_processor(self.tc, device="cpu")
        self.optimizer = make_optimizer(self.tc, self.model)
        self.state = create_train_state(self.model, self.optimizer)
        self.jmodel = jax_make_masknet(self.jc)
        self.jap = jax_audio_processor(self.jc)
        self.tx = jax_state.make_optimizer(self.jc)
        self.jstate = jax_state.TrainState(
            step=jnp.zeros((), jnp.int32), params=self.params, batch_stats=self.stats,
            opt_state=self.tx.init(self.params),
        )

    def jax_step(self):
        return jax_steps.make_train_step(self.jc, self.jmodel, self.jap, self.tx, donate=False)

    def port_step(self):
        return make_train_step(self.tc, self.model, self.ap, self.optimizer)

    def jax_state_dict(self, jstate):
        return weights.state_dict_from_jax(
            jax.device_get(jstate.params), jax.device_get(jstate.batch_stats)
        )

    def adam_moments(self, jstate):
        adam = weights._adam_state(jax.device_get(jstate.opt_state))
        return weights.params_from_jax(adam.mu)


def _random_adam_state(pair, count, seed):
    """A mid-training JAX Adam state with random moments, in both packages."""
    rng = np.random.default_rng(seed)
    opt_state = pair.tx.init(pair.params)

    def moments(fill):
        return jax.tree_util.tree_map(lambda p: fill(np.shape(p)).astype(np.float32), pair.params)

    mu = moments(lambda s: 1e-3 * rng.standard_normal(s))
    nu = moments(lambda s: rng.uniform(1e-6, 1e-4, s))

    def replace(st):
        fields = getattr(st, "_fields", None)
        if fields is None:  # a chain: a plain tuple of states
            return tuple(replace(s) for s in st)
        if "mu" in fields:
            return st._replace(count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu)
        if "count" in fields:  # the schedule's own update count
            return st._replace(count=jnp.asarray(count, jnp.int32))
        if "inner_state" in fields:
            return st._replace(inner_state=replace(st.inner_state))
        return st

    opt_state = replace(opt_state)
    pair.jstate = pair.jstate.replace(step=jnp.asarray(count, jnp.int32), opt_state=opt_state)
    pair.state.step = weights.optimizer_state_from_jax(
        jax.device_get(opt_state), pair.model, pair.optimizer
    )
    assert pair.state.step == count


GRAD_REL = 5e-3
BF16_GRAD_REL = 0.2

# (dtype, loss, model, weight decay, cosine decay steps, clip norm, batch)
STEP_CASES = {
    "fp32-si_snr-adam-B2": ("float32", "si_snr", "voicesplit", 0.0, None, None, 2),
    "fp32-power_law-adamw-cosine-clip-B8": (
        "float32", "power_law_compression", "voicefilter", 0.01, 5, 1e-2, 8),
    "bf16-si_snr-adamw-cosine-clip-B2": ("bfloat16", "si_snr", "voicesplit", 0.01, 5, 1.0, 2),
    "bf16-power_law-adam-B8": ("bfloat16", "power_law_compression", "voicefilter", 0.0, None, None, 8),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(case):
    """One step from the same weights, fresh Adam state and batch.

    fp32 (tight): loss and grad_norm to summation order; the gradients,
    read from Adam's first moment (0.1·g), within 5e-3 of the model's
    largest (the first convs' gradients pass back through up to seven
    BatchNorms whose sums cancel, over 20800 positions summed in another
    order; the worst seen is 2e-3); the
    running statistics to 1e-5.  Adam's first step moves each weight by
    about lr·sign(g), so a weight whose gradient is within that error of
    zero (e.g. the conv biases, whose exact gradient is zero under
    train-mode BatchNorm) may move either way: weights are compared to
    1e-7 where |g| is ten times the error bound, and to 2·lr everywhere.

    bf16 (loose): the JAX CPU path rounds its LSTM state and conv outputs
    to bf16 at other points than the port, which moves the gradients by
    up to ~20% of their largest element: loss within 5e-3, grad_norm
    within 5e-2, running statistics within 5e-3, weights within 2·lr.
    The gradients are held by direction as well as size, so a wrong sign
    or a wrong gradient fails: every leaf's first moment within 20% of the
    model's largest (worst seen 12%), and its cosine with JAX's at least
    0.98 for the LSTM and dense leaves (worst seen 0.993) and 0.6 for the
    conv chain, whose gradients pass back through up to seven bf16
    BatchNorms (worst seen 0.73).  Conv biases are left out: their exact
    gradient is zero, so both sides hold only bf16 noise there.
    """
    dtype, loss, model_name, wd, decay, clip, B = STEP_CASES[case]
    pair = Pair(_config_text(dtype, loss, model_name, wd, decay, clip))
    batch = _batch(B, seed=1)
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    jstate, jm = pair.jax_step()(pair.jstate, batch)
    m = pair.port_step()(pair.state, batch)
    assert_step_matches_jax(pair, before, jstate, jm, m, dtype == "float32")


def assert_step_matches_jax(pair, before, jstate, jm, m, fp32):
    """One step of each package from the same state, held at the
    tolerances that `test_train_step_matches_jax` states."""
    assert pair.state.step == 1 and int(jstate.step) == 1
    assert not bool(m["loss_exploded"])
    want_sd, got_sd = pair.jax_state_dict(jstate), pair.model.state_dict()
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5 if fp32 else 5e-3)
    np.testing.assert_allclose(
        float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4 if fp32 else 5e-2
    )
    for k in want_sd:
        if k.endswith((".mean", ".var")):
            np.testing.assert_allclose(
                got_sd[k].numpy(), want_sd[k].numpy(), atol=1e-5 if fp32 else 5e-3, err_msg=k
            )
            assert not torch.equal(got_sd[k], before[k]), k
    mu = pair.adam_moments(jstate)
    params = dict(pair.model.named_parameters())
    for k, p in params.items():
        got, want = got_sd[k].numpy(), want_sd[k].numpy()
        np.testing.assert_allclose(got, want, atol=2 * LR + 1e-7, rtol=0, err_msg=k)
        assert not torch.equal(got_sd[k], before[k]), k
    exp_avg = {k: pair.optimizer.state[p]["exp_avg"].numpy() for k, p in params.items()}
    if fp32:
        _assert_grads_close(exp_avg, {k: v.numpy() for k, v in mu.items()}, GRAD_REL)
        floor = 10 * GRAD_REL * max(np.abs(v.numpy()).max() for v in mu.values())
        for k in params:
            sure = np.abs(mu[k].numpy()) > floor
            np.testing.assert_allclose(
                got_sd[k].numpy()[sure], want_sd[k].numpy()[sure], atol=1e-7, rtol=0, err_msg=k
            )
    else:
        signal = {k: v.numpy() for k, v in mu.items() if not k.endswith("conv.bias")}
        _assert_grads_close(exp_avg, signal, BF16_GRAD_REL)
        for k, want in signal.items():
            got = exp_avg[k].ravel()
            cos = got @ want.ravel() / (np.linalg.norm(got) * np.linalg.norm(want))
            assert cos >= (0.6 if k.startswith("conv") else 0.98), (k, cos)


def test_three_steps_from_a_jax_adam_state_match_jax():
    """Three steps from a mid-training Adam state (random moments, update
    count 4, carried by `optimizer_state_from_jax`) with AdamW, the cosine
    schedule crossing its end (decay over 5 updates) and clipping active
    (si_snr grad norms ~47 against a clip of 1): the moments make every
    update proportional to the gradient, so all weights compare tightly
    (fp32, 1e-6 = 1e-3·lr)."""
    pair = Pair(_config_text("float32", "si_snr", "voicesplit", 0.01, 5, 1.0))
    _random_adam_state(pair, count=4, seed=3)
    jstep, pstep = pair.jax_step(), pair.port_step()
    jstate = pair.jstate
    for i in range(3):
        batch = _batch(2, seed=10 + i)
        jstate, jm = jstep(jstate, batch)
        m = pstep(pair.state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        assert float(m["grad_norm"]) > 1.0  # the clip is active
    assert pair.state.step == int(jstate.step) == 7
    want_sd = pair.jax_state_dict(jstate)
    for k, v in pair.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_sd[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
    mu = pair.adam_moments(jstate)
    for k, p in pair.model.named_parameters():
        np.testing.assert_allclose(
            pair.optimizer.state[p]["exp_avg"].numpy(), mu[k].numpy(), atol=1e-6, err_msg=k
        )


def test_cosine_schedule_matches_optax():
    import optax

    cfg = load_config_from_str(_config_text("float32", "si_snr", "voicesplit", decay_steps=7))
    cfg.train_config.lr_decay_alpha = 0.1
    sched = optax.cosine_decay_schedule(LR, 7, alpha=0.1)
    for n in range(10):
        np.testing.assert_allclose(learning_rate(cfg, n), float(sched(n)), rtol=1e-6)
    cfg.train_config.lr_decay_steps = None
    assert learning_rate(cfg, 5) == LR


def test_eval_step_matches_jax():
    pair = Pair(_config_text("float32", "si_snr", "voicesplit"))
    batch = _batch(2, seed=4)
    want = jax_steps.make_eval_step(pair.jc, pair.jmodel, pair.jap)(
        pair.params, pair.stats, batch
    )
    pair.model.train()
    got = make_eval_step(pair.tc, pair.model, pair.ap)(batch)
    assert pair.model.training  # the mode is restored
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["si_snr"].numpy(), np.asarray(want["si_snr"]), atol=1e-3)
    # the specs: fp32 STFTs by different matmuls, then 20·log10, which
    # magnifies the round-off of the weakest bins (tests/test_torch_dsp.py);
    # the target is a pure tone, whose off-peak bins sit near the floor:
    # 5e-4 is 0.05 dB
    for k in ("mask", "est_spec", "mixed_spec", "target_spec"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=5e-4, err_msg=k)
    np.testing.assert_allclose(got["est_wav"].numpy(), np.asarray(want["est_wav"]), atol=1e-5)


def test_ema_update_matches_jax():
    pair = Pair(_config_text("float32", "si_snr", "voicesplit"))
    other, _ = weights.random_jax_variables(pair.model, seed=5)
    want = jax_steps.make_ema_update(0.9)(pair.params, other)
    ema = {k: p.detach().clone() for k, p in pair.model.named_parameters()}
    got = make_ema_update(0.9)(ema, weights.params_from_jax(other))
    for k, v in weights.params_from_jax(jax.device_get(want)).items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-7, err_msg=k)


def test_multi_step_equals_single_steps():
    """K steps over a stacked window equal K single steps from the same
    state (same ops, so exactly), with the window's metrics."""
    text = _config_text("float32", "power_law_compression", "voicefilter", 0.01, 5, 1e-2)
    batches = [_batch(2, seed=20 + i) for i in range(3)]
    stacked = {k: np.stack([b[k] for b in batches]) for k in batches[0]}

    single, multi = Pair(text), Pair(text)
    step = single.port_step()
    losses = [float(step(single.state, b)["loss"]) for b in batches]
    m = make_multi_train_step(multi.tc, multi.model, multi.ap, multi.optimizer, 3)(
        multi.state, stacked
    )
    assert multi.state.step == single.state.step == 3
    assert float(m["loss"]) == losses[-1]
    np.testing.assert_allclose(float(m["loss_mean"]), np.mean(losses), rtol=1e-6)
    assert not bool(m["loss_exploded"])
    for (k, a), b in zip(single.model.state_dict().items(), multi.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_train_step_after_serving_under_inference_mode():
    """The STFT bases are cached per device; when serving under
    `torch.inference_mode` makes them first, a later train step must still
    be able to differentiate through them."""
    from voicesplit_tpu_torch.dsp import stft

    for cached in (stft._stft_basis, stft._istft_basis, stft._inverse_envelope):
        cached.cache_clear()
    pair = Pair(_config_text("float32", "si_snr", "voicesplit"))
    batch = _batch(2, seed=7)
    with torch.inference_mode():
        spec, phase = pair.ap.wav2spec_batch(torch.from_numpy(batch["mixed_wav"]))
        pair.ap.spec2wav_batch(spec, phase)
    m = pair.port_step()(pair.state, batch)
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0


def test_explosion_guard_and_param_count():
    pair = Pair(_config_text("float32", "power_law_compression", "voicefilter"))
    assert param_count(pair.model) == sum(np.size(a) for a in jax.tree_util.tree_leaves(pair.params))
    batch = _batch(2, seed=6)
    batch["mixed_wav"] = np.full_like(batch["mixed_wav"], np.nan)
    assert bool(pair.port_step()(pair.state, batch)["loss_exploded"])
