"""The fused chain's forward, `conv_bn_act_fwd`, layer by layer: its plain
version in bf16 against the JAX package's Pallas forward kernel
(`voicesplit_tpu/ops/conv_fused.py::_conv_fwd`, interpret mode on the CPU)
at every layer kind of conv2 … conv7 with and without the prologue, and the
decomposition the card takes (the prologue pass, then the forward without a
prologue) against the forward with its prologue, bit for bit.

Geometry, inputs and the conversions to the JAX kernels' folded frames come
from `tests/test_torch_conv_fused.py` (its fp32 comparisons of the same
kernel stay there).
"""

import jax.numpy as jnp
import pytest
import torch

import voicesplit_tpu.ops.conv_fused as jcf
from test_torch_conv_fused import (
    FOLD, GEOMS, PROLOGUES, SPECS, _assert_peak_close, _frame, _layer_inputs, _scal_pair,
    _unfold_channels, _unframe,
)
from voicesplit_tpu.ops.conv_fold import fold_kernel
from voicesplit_tpu_torch.ops import conv_fused as cf


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("prologue", sorted(PROLOGUES))
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_forward_plain_version_matches_pallas_kernel_bf16(spec, prologue):
    """bf16 operands: both sides round the prologue's output and the raw
    output to bf16; a sum taken in another order flips a rounding of raw
    (one bf16 ulp of the peak ~ 8 is 3e-2; 1e-2 of the peak holds it), and
    the statistics sum those rounded values."""
    (kt, kf), dt = SPECS[spec]
    act, on = PROLOGUES[prologue]
    x, w, bias, bn = _layer_inputs(2, kt, kf)
    scal_t, scal_j = _scal_pair(bn)
    wf = fold_kernel(jnp.asarray(w).astype(jnp.bfloat16))
    frame, stats = jcf._conv_fwd(
        _frame(x, GEOMS[spec], jnp.bfloat16), jcf._pack(wf), scal_j,
        jnp.tile(jnp.asarray(bias), FOLD)[None, :], GEOMS[spec], kt, wf.shape[1], dt, act, on,
    )
    raw, st = cf.conv_bn_act_fwd(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16(), torch.from_numpy(bias),
        scal_t, dt, act, on,
    )
    assert raw.dtype == torch.bfloat16 and st.dtype == torch.float32
    _assert_peak_close(raw.float().numpy(), _unframe(frame, GEOMS[spec]), 1e-2)
    _assert_peak_close(st[0].numpy(), _unfold_channels(stats[0]), 1e-2, "sum")
    _assert_peak_close(st[1].numpy(), _unfold_channels(stats[1]), 1e-2, "sum of squares")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["mish", "relu"])
@pytest.mark.parametrize("spec", sorted(k for k in SPECS if k != "7x1"))
def test_prologue_pass_then_forward_is_the_forward_with_its_prologue(spec, act, dtype):
    """On the card a layer with a prologue is the prologue pass
    (`conv_wgrad_prologue`) into a scratch tensor, then the forward kernel
    without a prologue.  The plain versions of that decomposition give the
    bits of the forward with its prologue, raw and statistics alike, and so
    do the wrappers."""
    (kt, kf), dt = SPECS[spec]
    x, w, bias, bn = _layer_inputs(11, kt, kf)
    scal, _ = _scal_pair(bn)
    td = getattr(torch, dtype)
    xt, wt, bt = torch.from_numpy(x).to(td), torch.from_numpy(w).to(td), torch.from_numpy(bias)
    whole = cf.conv_bn_act_fwd_ref(xt, wt, bt, scal, dt, act, True)
    y = cf.conv_wgrad_prologue_ref(xt, scal, act)
    split = cf.conv_bn_act_fwd_ref(y, wt, bt, scal, dt, None, False)
    wrappers = cf.conv_bn_act_fwd(cf.conv_wgrad_prologue(xt, scal, act), wt, bt, scal, dt, None, False)
    assert y.dtype == td and whole[0].dtype == td
    for got in (split, wrappers):
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
