"""GE2E: the port's loss, EER and training against the JAX package's.

The loss and its gradient take one numpy batch of unit embeddings in both
packages (`jax.grad` against autograd).  Training: a tree of synthetic
harmonic voices, the same JAX-initialized parameters (flax's init, carried
by `weights.encoder_params_from_jax`) and the same seed, so that both
samplers draw the same crops; two `train_ge2e` steps in each package (JAX's
`lax.scan` LSTM on the CPU, the port's plain versions), then a third from
the JAX step's parameters and optax state (carried by
`weights.encoder_optimizer_state_from_jax`).

Tolerances (fp32): the loss 1e-6 relative, its gradients in emb and w 1e-5
of the largest one (one batch, order of summation), in b (0 but for
round-off: the softmax sums to 1) 1e-6 in both packages; a training step's losses 2e-5
relative (the mels differ by float32 round-off, see
`tests/test_torch_dsp.py`); parameters after Adam steps 2·lr (Adam's first
step moves each by about lr·sign(g), so a gradient near 0 can flip a
sign; b's gradient is 0 but for round-off, so Adam moves it by up to lr in
a direction round-off picks); w 1e-5 relative.  The step resumed from
optax's state: Adam's moments loaded bit for bit, and each leaf's update
within 1e-2 of that leaf's largest update (the first layer's input, the
mels, carries float32 round-off; a fresh Adam or misplaced moments move a
leaf by a sizeable share of lr), b's within 2·lr.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.config import Config as JaxConfig
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu.losses import ge2e as jax_ge2e
from voicesplit_tpu.models.speaker_encoder import SpeakerEncoder as JaxSpeakerEncoder
from voicesplit_tpu.train import encoder as jax_encoder
from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.dsp.audio_io import save_wav_float
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.losses.ge2e import (
    ge2e_softmax_loss,
    pairwise_eer,
    pairwise_eer_stats,
)
from voicesplit_tpu_torch.train import encoder as port_encoder
from voicesplit_tpu_torch.weights import encoder_optimizer_state_from_jax, encoder_params_from_jax

LOSS_RTOL, GRAD_TOL, B_GRAD_ATOL, STEP_LOSS_RTOL, WB_RTOL = 1e-6, 1e-5, 1e-6, 2e-5, 1e-5
UPDATE_RTOL = 1e-2
LR = 1e-3
N, M, HIDDEN, LAYERS, EMB = 4, 3, 24, 2, 12


@pytest.fixture(autouse=True)
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 2, 8), (4, 5, 16), (16, 6, 256)], ids=str)
@pytest.mark.parametrize("w", [10.0, -3.0], ids=["w10", "w-clamped"])
def test_loss_and_gradient_match_jax(shape, w):
    """Loss and d(loss)/d(emb, w, b); a negative w is clamped at 1e-4 and
    gets no gradient in either package."""
    rng = np.random.default_rng(sum(shape))
    emb = _unit(rng.standard_normal(shape))
    b = -5.0
    want, grads = jax.value_and_grad(jax_ge2e.ge2e_softmax_loss, argnums=(0, 1, 2))(
        jnp.asarray(emb), jnp.float32(w), jnp.float32(b))
    e, wt, bt = (torch.tensor(v, requires_grad=True) for v in (emb, np.float32(w), np.float32(b)))
    got = ge2e_softmax_loss(e, wt, bt)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    peak = max(float(np.abs(np.asarray(g)).max()) for g in grads[:2])
    for g_t, g_j in zip((e.grad, wt.grad), grads[:2]):
        np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=GRAD_TOL * peak)
    # b's gradient is the mean of (softmax sum - 1): 0 but for round-off
    assert abs(bt.grad.item()) <= B_GRAD_ATOL and abs(float(grads[2])) <= B_GRAD_ATOL
    if w < 0:
        assert wt.grad.item() == 0.0


def test_loss_needs_two_speakers_and_utterances():
    with pytest.raises(ValueError, match=">=2 speakers"):
        ge2e_softmax_loss(torch.ones(1, 3, 4), torch.tensor(1.0), torch.tensor(0.0))


@pytest.mark.parametrize("groups", [None, "recordings"])
def test_eer_and_its_statistics_match_jax(groups):
    rng = np.random.default_rng(4)
    centers = _unit(rng.standard_normal((5, 16)))
    emb = _unit(centers[:, None, :] + 0.4 * rng.standard_normal((5, 6, 16))).reshape(30, 16)
    ids = np.repeat(np.arange(5), 6)
    grp = None if groups is None else np.arange(30) // 3
    assert pairwise_eer(torch.from_numpy(emb), ids) == jax_ge2e.pairwise_eer(emb, ids)
    for exclude in (True, False):
        got = pairwise_eer_stats(emb, ids, n_boot=50, seed=1, groups=grp, exclude_within_group=exclude)
        want = jax_ge2e.pairwise_eer_stats(emb, ids, n_boot=50, seed=1, groups=grp,
                                           exclude_within_group=exclude)
        assert got == want
    assert np.isnan(pairwise_eer(emb[:6], ids[:6]))  # one speaker: no non-target pair


def _speaker_tree(root, n_speakers=5, n_utts=3, seconds=1.0, sr=16000, seed=0):
    """Harmonic voices, one fundamental and spectral tilt per speaker."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(sr * seconds)) / sr
    speakers = {}
    for s in range(n_speakers):
        d = root / f"spk{s}"
        d.mkdir()
        for u in range(n_utts):
            phase = rng.uniform(0, 2 * np.pi)
            wav = sum((0.4 + 0.1 * s) ** h * np.sin(2 * np.pi * (90 + 35 * s) * h * t + phase * h)
                      for h in range(1, 9))
            wav = 0.1 * wav * (1.0 + 0.2 * np.sin(2 * np.pi * (2 + u) * t))
            save_wav_float(wav.astype(np.float32), str(d / f"u{u}.wav"), sr)
        speakers[f"spk{s}"] = sorted(str(p) for p in d.glob("*.wav"))
    return speakers


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _speaker_tree(tmp_path_factory.mktemp("speakers"))


@pytest.fixture(scope="module")
def jax_start(corpus):
    """JAX parameters of the tiny topology (flax init from seed 0)."""
    enc = JaxSpeakerEncoder(num_mels=40, lstm_hidden=HIDDEN, lstm_layers=LAYERS, emb_dim=EMB)
    params = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 80)))["params"]
    return {"enc": params, "w": jnp.asarray(10.0, jnp.float32), "b": jnp.asarray(-5.0, jnp.float32)}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _kw(seed, steps=2, step0=0):
    return dict(n_speakers=N, m_utts=M, steps=steps, lr=LR, lstm_hidden=HIDDEN, lstm_layers=LAYERS,
                emb_dim=EMB, seed=seed, log_interval=1, log=lambda s: None, step0=step0)


def test_sampler_draws_the_jax_batches(corpus):
    """One seed, the same crops: the same files and offsets, mels equal to
    float32 round-off."""
    ap_j = jax_audio_processor(JaxConfig())
    ap_t = make_audio_processor(Config(), device="cpu")
    s_j = jax_encoder.MelSampler(ap_j, corpus, 80, np.random.default_rng(5))
    s_t = port_encoder.MelSampler(ap_t, corpus, 80, np.random.default_rng(5))
    for _ in range(3):
        (m_j, ids_j), (m_t, ids_t) = s_j.batch(N, M), s_t.batch(N, M)
        assert ids_j == ids_t and m_t.shape == (N * M, 40, 80)
        np.testing.assert_allclose(m_t, m_j, atol=1e-4)


def test_two_training_steps_match_jax_then_a_resumed_third(corpus, jax_start):
    ap_j = jax_audio_processor(JaxConfig())
    ap_t = make_audio_processor(Config(), device="cpu")
    _, p_j, o_j, losses_j = jax_encoder.train_ge2e(ap_j, corpus, params=jax_start, **_kw(7))
    start = encoder_params_from_jax(_np_tree(jax_start))
    enc, model, opt_state, losses_t = port_encoder.train_ge2e(
        ap_t, corpus, params=start, device="cpu", **_kw(7))
    assert enc is model.enc and len(losses_t) == len(losses_j) == 2
    np.testing.assert_allclose(losses_t, losses_j, rtol=STEP_LOSS_RTOL)
    _assert_params_close(model, p_j)
    assert opt_state["state"][0]["step"].item() == 2

    # a third step from JAX's parameters and optax state after two
    _, p3_j, _, l3_j = jax_encoder.train_ge2e(ap_j, corpus, params=p_j, opt_state=o_j,
                                              **_kw(8, steps=1, step0=2))
    model2 = port_encoder.GE2E(port_encoder.SpeakerEncoder(
        num_mels=40, lstm_hidden=HIDDEN, lstm_layers=LAYERS, emb_dim=EMB))
    model2.load_state_dict(encoder_params_from_jax(_np_tree(p_j)))
    adam = port_encoder.make_adam(model2.parameters(), LR)
    assert encoder_optimizer_state_from_jax(jax.device_get(o_j), model2, adam) == 2
    assert_moments_loaded(jax.device_get(o_j), {n: adam.state[p] for n, p in model2.named_parameters()})
    _, model3, _, l3_t = port_encoder.train_ge2e(
        ap_t, corpus, params=model2, opt_state=adam.state_dict(), device="cpu",
        **_kw(8, steps=1, step0=2))
    np.testing.assert_allclose(l3_t, l3_j, rtol=STEP_LOSS_RTOL)
    _assert_params_close(model3, p3_j)
    assert_updates_close(p_j, model3.state_dict(), p3_j)


def _assert_params_close(model, jax_params):
    want = encoder_params_from_jax(_np_tree(jax_params))
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "w":
            np.testing.assert_allclose(got[k].item(), v.item(), rtol=WB_RTOL, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2 * LR, err_msg=k)


def jax_leaves(tree):
    """GE2E training's JAX tree ``{enc: {lstm{i}, proj}, w, b}`` (params or
    any tree shaped like them) as ``{port parameter name: numpy array}``,
    mapped here by hand: the LSTM leaves keep their layout, ``proj/kernel``
    is transposed."""
    out = {"w": np.asarray(tree["w"], np.float32).reshape(()),
           "b": np.asarray(tree["b"], np.float32).reshape(())}
    for layer, leaves in tree["enc"].items():
        for k, v in leaves.items():
            v = np.asarray(v, np.float32)
            if layer == "proj":
                out[f"enc.proj.{'weight' if k == 'kernel' else k}"] = v.T if k == "kernel" else v
            else:
                out[f"enc.{layer}.{k}"] = v
    return out


def _adam_node(opt_state):
    """optax's (count, mu, nu) in a chain's state: namedtuples, or the
    nested dicts of a msgpack checkpoint."""
    if hasattr(opt_state, "mu"):
        return opt_state.count, opt_state.mu, opt_state.nu
    if isinstance(opt_state, dict):
        if "mu" in opt_state:
            return opt_state["count"], opt_state["mu"], opt_state["nu"]
        subs = list(opt_state.values())
    elif isinstance(opt_state, (tuple, list)):
        subs = opt_state
    else:
        return None
    for sub in subs:
        found = _adam_node(sub)
        if found is not None:
            return found
    return None


def assert_moments_loaded(jax_opt_state, states):
    """The torch Adam states (parameter name -> its ``optimizer.state``)
    hold optax's count and, bit for bit, its moments mu / nu leaf by leaf."""
    count, mu, nu = _adam_node(jax_opt_state)
    mu, nu = jax_leaves(mu), jax_leaves(nu)
    assert set(states) == set(mu)
    for name, st in states.items():
        assert st["step"].item() == int(np.asarray(count)), name
        assert torch.equal(st["exp_avg"], torch.tensor(mu[name])), name
        assert torch.equal(st["exp_avg_sq"], torch.tensor(nu[name])), name


def assert_updates_close(before, after, jax_after, lr=LR):
    """Each leaf's update (`after`, a port state dict, minus `before`, the
    JAX params it started from) against JAX's (`jax_after` minus `before`)
    within UPDATE_RTOL of the largest update of that leaf; b, whose gradient
    is round-off, within 2·lr."""
    start, want = jax_leaves(before), jax_leaves(jax_after)
    for name, v in want.items():
        got = after[name].detach().numpy() - start[name]
        ref = v - start[name]
        if name == "b":
            assert abs(float(got - ref)) <= 2 * lr
            continue
        np.testing.assert_allclose(got, ref, atol=UPDATE_RTOL * np.abs(ref).max(), err_msg=name)
