"""The FLOP and bound counts against hand counts."""

from __future__ import annotations

import pytest

import costs

MODEL = {"conv_channels": 64, "conv_out_channels": 8, "emb_dim": 256, "fc1_dim": 600,
         "fc2_dim": 601, "lstm_dim": 400, "num_extra_dilated_blocks": 0}


def test_conv_taps():
    # time: pad 4, taps at -4, -2, 0, 2, 4 → 6 + 8 + 10 + 8 + 6 rows
    # freq: pad 2, taps at -2 … 2 → 4 + 5 + 6 + 5 + 4 cols
    assert costs.conv_taps(10, 6, 5, 5, 2) == (38, 24)
    assert costs.conv_taps(301, 601, 1, 1, 1) == (301, 601)


def test_conv_bound_by_hand():
    b = costs.conv_bound("conv_dilated_fwd", (2, 10, 6, 64), 5, 5, 2, "bfloat16")
    assert b["flops"] == 2 * 64 * 64 * 2 * 38 * 24
    assert b["bytes"] == 2 * (2 * 10 * 6 * 64 * 2) + 25 * 64 * 64 * 2
    assert b["bound_ms"] == pytest.approx(max(b["flops"] / 989e12, b["bytes"] / 3.35e12) * 1e3)
    w = costs.conv_bound("conv_wgrad", (2, 10, 6, 64), 5, 5, 2, "bfloat16")
    assert w["bytes"] == 2 * (2 * 10 * 6 * 64 * 2) + 25 * 64 * 64 * 4 + 2 * 64 * 4


def test_lstm_bounds_by_hand():
    f = costs.lstm_bound(2, 8, "bfloat16", 400, 301)
    assert f["bytes"] == 15_411_200 + 2_560_000 + 15_411_200 + 30_822_400
    assert f["flops"] == 6_164_480_000
    assert f["bound_by"] == "bytes"
    assert f["bound_ms"] == pytest.approx(64_204_800 / 3.35e12 * 1e3)
    b = costs.lstm_bwd_bound(1, 1, "bfloat16", 400, 301)
    # W_hh 1,280,000; gates 770,560·4; cs, hs, dhs 3·120,400·4; states 6·400·4;
    # dxp 481,600·2; dW_hh 640,000·4
    assert b["bytes"] == 1_280_000 + 1_926_400 + 1_444_800 + 9_600 + 963_200 + 2_560_000
    assert b["flops"] == 4 * 301 * 400 * 1600


def test_lstm_bound_ms_routes():
    one = costs.lstm_bound(1, 1, "bfloat16", 400, 301)["bound_ms"]
    assert costs.lstm_bound_ms(MODEL, 1, 301, False) == pytest.approx(2 * one)
    both = costs.lstm_bound(2, 8, "bfloat16", 400, 301)["bound_ms"]
    back = costs.lstm_bwd_bound(2, 8, "bfloat16", 400, 301)["bound_ms"]
    assert costs.lstm_bound_ms(MODEL, 8, 301, True) == pytest.approx(both + back)


def test_conv_work_counts():
    serve = costs.conv_work(MODEL, 8, 301, 601, train=False, fused_chain=False)
    assert [k for k, _ in serve] == ["conv_dilated_fwd"] * 8
    train = costs.conv_work(MODEL, 8, 301, 601, train=True, fused_chain=True)
    kinds = [k for k, _ in train]
    # conv1: fwd + wgrad; conv2..7 (the chain): fwd, dgrad, wgrad; conv8: three plain
    assert len(kinds) == 2 + 6 * 3 + 3
    assert kinds.count("conv_bn_act_fwd") == 6 and kinds.count("conv_wgrad") == 6


def _hand_flops(B, T, F, n_fft, train, si_snr):
    C, H, E, fc1, fc2 = 64, 400, 256, 600, 601
    taps = [(T, 7 * F - 12), (7 * T - 12, F)]  # (1,7) and (7,1): rows, cols
    cols5 = 5 * F - 6
    for d in (1, 2, 4, 8, 16):
        taps.append((5 * T - 6 * d, cols5))
    ch = [(1, C)] + [(C, C)] * 6
    conv = 0.0
    for i, ((r, c), (cin, cout)) in enumerate(zip(taps, ch)):
        conv += 2 * cin * cout * B * r * c * ((2 if i == 0 else 3) if train else 1)
    conv += 2 * C * 8 * B * T * F * (3 if train else 1)
    m = 3 if train else 1
    lstm = (2 * 2 * B * T * (8 * F + E) * 4 * H + 2 * 2 * B * T * H * 4 * H) * m
    fc = (2 * B * T * 2 * H * fc1 + 2 * B * T * fc1 * fc2) * m
    one = 4 * B * T * n_fft * F  # cos and sin products of one signal
    dsp = (2 * one + (3 * one if si_snr else 0)) if train else 2 * one
    return conv + lstm + fc + dsp


@pytest.mark.parametrize("train,loss", [(True, "si_snr"), (True, "power_law_compression"),
                                        (False, "si_snr")])
def test_step_flops_by_hand(train, loss):
    audio = {"num_freq": 601, "n_fft": 1200}
    got = costs.step_flops(MODEL, audio, loss, 8, 301, train)["total"]
    assert got == pytest.approx(_hand_flops(8, 301, 601, 1200, train, loss == "si_snr"))


def test_step_flops_size():
    """A voicesplit train step at B=8 is about 4.7 TFLOP (the issue's 5.0 by
    the full-tap 3x rule); serving at B=1 about 0.2."""
    audio = {"num_freq": 601, "n_fft": 1200}
    assert 4.0e12 < costs.step_flops(MODEL, audio, "si_snr", 8, 301, True)["total"] < 5.5e12
    assert 1.5e11 < costs.step_flops(MODEL, audio, "si_snr", 1, 301, False)["total"] < 2.5e11
