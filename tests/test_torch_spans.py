"""The port's spans (`utils/profiling.py::span`) at the layer boundaries of
the serving call and the train step, on the CPU at a small config: their
names and nesting under `torch.profiler`, one top span a call or step, no
range entered with the profiler off or under compile tracing, the same
waveforms either way, and the exporter's Chrome trace."""

import json
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voicesplit_tpu_torch import weights
from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.train import create_train_state, make_optimizer, make_train_step
from voicesplit_tpu_torch.utils import profiling

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 40
L = HOP * FRAMES
PREFIX = "voicesplit."

# span -> its parent span, per the layer table (`PERF.md` §3)
SERVE_TREE = {
    "voicesplit.separate_batch": None,
    "voicesplit.wav2spec": "voicesplit.separate_batch",
    "voicesplit.convs": "voicesplit.separate_batch",
    "voicesplit.head": "voicesplit.separate_batch",
    "voicesplit.lstm": "voicesplit.head",
    "voicesplit.spec2wav": "voicesplit.separate_batch",
}


def _config(name):
    d = json.loads((REPO / "configs" / f"{name}.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65)
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
    return load_config_from_str(json.dumps(d))


def _inputs(batch, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(L) / 16000.0
    target = 0.2 * np.sin(2 * np.pi * rng.uniform(100, 300, (batch, 1)) * t)
    mixed = target + 0.05 * rng.standard_normal((batch, L))
    emb = rng.standard_normal((batch, 16))
    return mixed.astype(np.float32), target.astype(np.float32), emb.astype(np.float32)


def _serving(name="voicesplit"):
    cfg = _config(name)
    model = weights.init_random_(make_masknet(cfg, device="cpu"), seed=1)
    ap = make_audio_processor(cfg, device="cpu")
    mixed, _, emb = _inputs(2)
    return lambda: separate_batch(model, ap, mixed, emb)


def _training(name):
    cfg = _config(name)
    model = weights.init_random_(make_masknet(cfg, device="cpu"), seed=1)
    ap = make_audio_processor(cfg, device="cpu")
    opt = make_optimizer(cfg, model)
    state = create_train_state(model, opt)
    step = make_train_step(cfg, model, ap, opt)
    mixed, target, emb = _inputs(2)
    batch = {"mixed_wav": mixed, "target_wav": target, "emb": emb,
             "wav_len": np.full((2,), L, np.int32)}
    return lambda: step(state, batch)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def _span_parents(prof):
    """(name, name of the nearest enclosing span or None) for each span."""
    out = []
    for e in prof.events():
        if not e.name.startswith(PREFIX):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PREFIX):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _tree_and_counts(pairs):
    tree, counts = {}, {}
    for name, parent in pairs:
        assert tree.setdefault(name, parent) == parent, (name, parent, tree[name])
        counts[name] = counts.get(name, 0) + 1
    return tree, counts


@pytest.mark.parametrize("route", ["library", "dilated"])
def test_serving_call_spans_nest_as_the_layers(route, monkeypatch):
    """Every conv route shows the same spans: one top span a call."""
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1" if route == "dilated" else "0")
    call = _serving()
    call()  # the DSP's cached bases, outside the profile
    prof, _ = _profiled(lambda: [call() for _ in range(2)])
    tree, counts = _tree_and_counts(_span_parents(prof))
    assert tree == SERVE_TREE
    assert counts == dict.fromkeys(SERVE_TREE, 2)


@pytest.mark.parametrize("config", ["voicesplit", "voicefilter"])
def test_train_step_spans_nest_as_the_layers(config):
    """SI-SNR (voicesplit) inverts both specs inside the loss; the power-law
    loss (voicefilter) does not."""
    step = _training(config)
    prof, _ = _profiled(step)
    tree, counts = _tree_and_counts(_span_parents(prof))
    want = {
        "voicesplit.train_step": None,
        "voicesplit.wav2spec": "voicesplit.train_step",
        "voicesplit.convs": "voicesplit.train_step",
        "voicesplit.head": "voicesplit.train_step",
        "voicesplit.lstm": "voicesplit.head",
        "voicesplit.loss": "voicesplit.train_step",
        "voicesplit.backward": "voicesplit.train_step",
        "voicesplit.optimizer": "voicesplit.train_step",
    }
    want_counts = {**dict.fromkeys(want, 1), "voicesplit.wav2spec": 2}
    if config == "voicesplit":
        want["voicesplit.spec2wav"] = "voicesplit.loss"
        want_counts["voicesplit.spec2wav"] = 2
    assert tree == want
    assert counts == want_counts


@pytest.mark.parametrize("path", ["serve", "train"])
def test_no_range_without_a_profiler(path, monkeypatch):
    fn = _serving() if path == "serve" else _training("voicesplit")

    real = torch.autograd.profiler.record_function

    def refuse(name, *args):
        # torch's own optimizer opens ranges of its own, unguarded
        if name.startswith(PREFIX):
            raise AssertionError(f"record_function({name!r}) entered with no profiler")
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    fn()
    assert profiling.span("voicesplit.a") is profiling.span("voicesplit.b")


def test_no_span_while_compiling(monkeypatch):
    """Under `torch.compile` / `torch.export` tracing the helper enters
    nothing, so no range enters a traced program."""
    call = _serving()
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    prof, _ = _profiled(call)
    assert not [e.name for e in prof.events() if e.name.startswith(PREFIX)]


def test_span_is_a_range_while_the_profiler_records():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("voicesplit.test"):
            torch.ones(4).sum()
    (e,) = [e for e in prof.events() if e.name == "voicesplit.test"]
    assert [c.name for c in e.cpu_children] == ["aten::ones", "aten::sum"]


@pytest.mark.parametrize("config", ["voicesplit", "voicefilter"])
def test_waveforms_same_bits_with_the_profiler_on_and_off(config):
    call = _serving(config)
    off = call()
    _, on = _profiled(call)
    assert torch.equal(on, off)


def test_trace_exporter_shows_the_spans(tmp_path):
    """The operator's use: one call under `trace(dir)` writes a Chrome trace
    whose ``user_annotation`` events are the spans, on the operators'
    timeline."""
    call = _serving()
    call()
    with profiling.trace(str(tmp_path)):
        call()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = {e["name"]: e for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX)}
    assert set(spans) == set(SERVE_TREE)
    top = spans["voicesplit.separate_batch"]
    ops = [e for e in events if e.get("cat") == "cpu_op" and e["name"].startswith("aten::")]
    assert ops and all(top["ts"] <= e["ts"] <= top["ts"] + top["dur"] for e in ops)
