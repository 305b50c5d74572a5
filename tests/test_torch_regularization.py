"""Dropout and SpecAugment in the port's training path against the JAX
package's: dropout is flax's arithmetic at the JAX model's two sites, and
one train step with both regularizers, given JAX's own dropout masks and
SpecAugment bands, is JAX's step (JAX's masks are recorded by wrapping
`jax.random.bernoulli` while the step body runs under `jax.disable_jit()`).
"""

import json

import flax.linen as fnn
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_augment import jax_bands
from test_torch_train import DIMS, Pair, _batch, _config_text, assert_step_matches_jax
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.train import steps as jax_steps
from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.dsp import augment as taug
from voicesplit_tpu_torch.models.masknet import MaskNet
from voicesplit_tpu_torch.train import steps as tsteps

RATE = 0.3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads for this file's tests: several test processes
    share one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def recorded_masks(monkeypatch):
    """Every keep mask that `jax.random.bernoulli` (flax's Dropout) draws,
    in order, as numpy."""
    masks = []
    real = jax.random.bernoulli

    def record(*args, **kwargs):
        m = real(*args, **kwargs)
        masks.append(np.array(m))
        return m

    monkeypatch.setattr(jax.random, "bernoulli", record)
    return masks


def feed_masks(model: MaskNet, masks):
    """Make `model` use the given keep masks, one per dropout site, in order."""
    it = iter(masks)

    def draw(shape, keep_prob, generator):
        m = torch.from_numpy(np.array(next(it)))
        assert tuple(m.shape) == tuple(shape) and keep_prob == pytest.approx(1 - RATE)
        return m

    model.draw_dropout_keep = draw
    return it


def _model(dropout, seed=1):
    model = MaskNet(dropout=dropout, **DIMS)
    params, stats = weights.random_jax_variables(model, seed)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    return model, params, stats


def _inputs(B=2, T=12, seed=2):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (B, T, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((B, DIMS["emb_dim"])).astype(np.float32)
    return torch.from_numpy(spec), torch.from_numpy(emb)


def test_dropout_is_the_identity_in_eval_mode():
    """The same weights with and without dropout give the same bits in
    eval mode, with no generator."""
    spec, emb = _inputs()
    with_drop, _, _ = _model(RATE)
    without, _, _ = _model(0.0)
    with torch.no_grad():
        assert torch.equal(with_drop.eval()(spec, emb), without.eval()(spec, emb))


def test_dropout_is_stochastic_in_train_mode_and_needs_a_generator():
    spec, emb = _inputs()
    model, _, _ = _model(RATE)
    model.train()
    with torch.no_grad():
        a = model(spec, emb, dropout_generator=torch.Generator().manual_seed(0))
        b = model(spec, emb, dropout_generator=torch.Generator().manual_seed(0))
        c = model(spec, emb, dropout_generator=torch.Generator().manual_seed(1))
        assert torch.equal(a, b) and not torch.equal(a, c)
        with pytest.raises(ValueError, match="dropout_generator"):
            model(spec, emb)


def test_dropout_zero_needs_no_generator_in_train_mode():
    spec, emb = _inputs()
    model, _, _ = _model(0.0)
    with torch.no_grad():
        out = model.train()(spec, emb)
    assert out.shape == spec.shape and bool(torch.isfinite(out).all())


def test_keep_share_and_scale():
    """Over 2**20 draws the keep share is within 0.005 of 1 - rate (about
    ten standard deviations) and kept values are x / keep_prob."""
    model, _, _ = _model(RATE)
    model.train()
    x = torch.ones((1 << 20,))
    y = model._drop(x, torch.Generator().manual_seed(4))
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - RATE)) < 5e-3
    assert torch.equal(y[kept], torch.full_like(y[kept], 1.0 / (1 - RATE)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_is_flax_arithmetic_bit_for_bit(dtype, recorded_masks):
    """``where(keep, x / keep_prob, 0)`` in the compute dtype, with the keep
    probability rounded to it first as JAX's weak-typed scalar is: the same
    bits as flax's `Dropout` given its mask."""
    x = np.random.default_rng(0).standard_normal((3, 17, 41)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = fnn.Dropout(rate=RATE).apply({}, xj, deterministic=False,
                                         rngs={"dropout": jax.random.PRNGKey(3)})
    assert len(recorded_masks) == 1
    model, _, _ = _model(RATE)
    model.train()
    feed_masks(model, recorded_masks)
    got = model._drop(torch.from_numpy(x).to(getattr(torch, dtype)), torch.Generator())
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_mask_head_with_jax_masks_matches_jax(recorded_masks):
    """The JAX model's `mask_head` in train mode with dropout records its two
    masks (the BiLSTM input, then the ReLU of its output); the port's
    `mask_head` given them agrees (fp32, 1e-5)."""
    model, params, stats = _model(RATE)
    rng = np.random.default_rng(5)
    B, T = 2, 12
    feats = rng.standard_normal((B, T, DIMS["num_freq"] * 8)).astype(np.float32)
    emb = rng.standard_normal((B, DIMS["emb_dim"])).astype(np.float32)
    jm = JaxMaskNet(dropout=RATE, **DIMS)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(feats),
                    jnp.asarray(emb), train=True, method=JaxMaskNet.mask_head,
                    rngs={"dropout": jax.random.PRNGKey(9)})
    shapes = [m.shape for m in recorded_masks]
    assert shapes == [(B, T, DIMS["num_freq"] * 8 + DIMS["emb_dim"]), (B, T, 2 * DIMS["lstm_dim"])]
    model.train()
    left = feed_masks(model, recorded_masks)
    with torch.no_grad():
        got = model.mask_head(torch.from_numpy(feats), torch.from_numpy(emb), torch.Generator())
    assert next(left, None) is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _regularized_config(dtype):
    d = json.loads(_config_text(dtype, "si_snr", "voicesplit"))
    d["model"]["dropout"] = RATE
    d["train_config"].update(spec_aug_time=6, spec_aug_freq=10, spec_aug_n=2)
    return json.dumps(d)


def test_regularized_train_step_matches_jax_given_the_same_masks(recorded_masks, monkeypatch):
    """Dropout 0.3 and SpecAugment (6 frames, 10 bins, 2 bands an axis) at
    step 0: JAX's step body run op by op records its two dropout masks, which
    the compiled JAX step then replays; its SpecAugment bands are drawn from
    ``fold_in(PRNGKey(0x5A), 0)`` as it draws them.  The port's step given
    both is JAX's step at the fp32 tolerances of `test_train_step_matches_jax`.

    fp32 only: in bf16 the two CPU paths round the LSTM at other points, and
    with a masked input their LSTM gradients' cosines fall to about 0.96
    (SpecAugment alone, which only zeroes bands, gives 0.972), below the
    0.98 that test holds bf16 to; dropout's bf16 arithmetic is held bit for
    bit above."""
    pair = Pair(_regularized_config("float32"))
    batch = _batch(2, seed=1)
    before = {k: v.clone() for k, v in pair.model.state_dict().items()}
    body = jax_steps._train_step_body(pair.jc, pair.jmodel, pair.jap, pair.tx)
    with jax.disable_jit():
        body(pair.jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    assert len(recorded_masks) == 2
    # the compiled step, as `test_train_step_matches_jax` runs it, given the
    # recorded masks (op by op, bf16 rounds at other points than compiled)
    replay = iter(list(recorded_masks))
    monkeypatch.setattr(jax.random, "bernoulli", lambda *a, **k: jnp.asarray(next(replay)))
    jstate, jm = pair.jax_step()(pair.jstate, batch)
    assert next(replay, None) is None
    T = pair.ap.frames_for(batch["mixed_wav"].shape[-1])
    bands = jax_bands(jax.random.fold_in(jax.random.PRNGKey(0x5A), 0),
                      (2, T, pair.tc.audio.active.num_freq), 6, 10, 2)
    fed = []

    def spec_mask(spec, generator, max_time, max_freq, n_masks):
        assert (max_time, max_freq, n_masks) == (6, 10, 2)
        assert generator.initial_seed() == (tsteps.SPEC_AUG_SEED << 32)
        fed.append(spec)
        return taug.apply_spec_bands(spec, bands)

    monkeypatch.setattr(tsteps, "spec_time_freq_mask", spec_mask)
    left = feed_masks(pair.model, recorded_masks)
    m = pair.port_step()(pair.state, batch)
    assert next(left, None) is None and len(fed) == 1
    assert_step_matches_jax(pair, before, jstate, jm, m, fp32=True)


def test_regularized_step_generators_follow_the_step_counter():
    """The same state and batch at the same step give the same bits, at
    another step other bits; the step's generators are seeded from
    ``(0x5A, step)`` and ``(0xD0, step)``."""
    results = []
    for step in (3, 3, 4):
        pair = Pair(_regularized_config("float32"))
        pair.state.step = step
        m = pair.port_step()(pair.state, _batch(2, seed=1))
        results.append((float(m["loss"]), pair.model.state_dict()))
    (la, a), (lb, b), (lc, c) = results
    assert la == lb and all(torch.equal(a[k], b[k]) for k in a)
    assert la != lc
    g = tsteps.step_generator(tsteps.DROPOUT_SEED, 7, torch.device("cpu"))
    assert g.initial_seed() == (0xD0 << 32) + 7
