"""Ahead-of-time export of the port (`voicesplit_tpu_torch/export.py`,
`cli/export.py`): `torch.export` programs of the separator and the streaming
chunk step, against the eager port and the JAX package's programs, their
saved files, the kernels' operators, and a cold load in a fresh interpreter.

Widths as `tests/test_export.py` (4 conv channels, LSTM 24, fp32, all 601
bins), 0.5 s clips; the programs are exported for the CPU, where the
operators run the kernels' plain versions.
"""

import json
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicesplit_tpu.config import load_config_from_str as jax_load_config_from_str
from voicesplit_tpu.export import export_streaming as jax_export_streaming
from voicesplit_tpu.export import make_e2e_separation_fn as jax_e2e
from voicesplit_tpu.streaming import StreamingSeparator as JaxStreamingSeparator
from voicesplit_tpu_torch import export, weights
from voicesplit_tpu_torch.cli.separate import separate_batch
from voicesplit_tpu_torch.config import Config, load_config_from_str
from voicesplit_tpu_torch.dsp.processor import make_audio_processor
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.ops import conv_cuda, lstm_cuda
from voicesplit_tpu_torch.streaming import StreamingSeparator

REPO = pathlib.Path(__file__).resolve().parents[1]
SR = 16000
SECONDS = 0.5
L = int(SR * SECONDS)
CHUNK = 20
# the port against the JAX package: fp32 sums in other orders, through the
# iSTFT (waveform peak ~0.3); `tests/test_export.py`'s tolerance
JAX_ATOL = 1e-5
# B=8: the eager model runs `bilstm_fwd`, the symbolic-batch program two
# `lstm_fwd`; the same fp32 recurrence with its products taken over other rows
B8_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text() -> str:
    c = Config()
    c.model_name = "voicesplit"
    c.model.lstm_dim = 24
    c.model.fc1_dim = 32
    c.model.conv_channels = 4
    c.model.conv_out_channels = 2
    c.train_config.compute_dtype = "float32"
    return c.to_json()


def _model(streaming=False, seed=0):
    model = make_masknet(load_config_from_str(_config_text()), streaming=streaming, device="cpu")
    params, stats = weights.random_jax_variables(model, seed)
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    return model, {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def separator():
    """The model, its JAX variables and its symbolic-batch program."""
    model, variables = _model(seed=1)
    config = load_config_from_str(_config_text())
    data = export.export_separator(config, model.state_dict(), seconds=SECONDS, platforms=["cpu"])
    return model, variables, data["cpu"]


@pytest.fixture(scope="module")
def streaming():
    model, variables = _model(streaming=True, seed=2)
    config = load_config_from_str(_config_text())
    data, manifest = export.export_streaming(config, model.state_dict(), chunk_frames=CHUNK,
                                             platforms=["cpu"])
    return model, variables, data["cpu"], manifest


def _clips(B, seed):
    rng = np.random.default_rng(seed)
    return ((0.1 * rng.standard_normal((B, L))).astype(np.float32),
            rng.standard_normal((B, 256)).astype(np.float32))


def _run(program, wav, emb):
    with torch.no_grad():
        return program(torch.from_numpy(wav), torch.from_numpy(emb))


@pytest.mark.parametrize("B", [2, 3])
def test_separator_program_matches_jax(separator, B):
    """The saved symbolic-batch program at two batches against the JAX
    package's `make_e2e_separation_fn` on the same weights."""
    _, variables, data = separator
    wav, emb = _clips(B, seed=B)
    got = _run(export.load_exported(data), wav, emb)
    want = jax_e2e(jax_load_config_from_str(_config_text()), variables)(
        jnp.asarray(wav), jnp.asarray(emb))
    assert got.shape == (B, L) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_ATOL)


@pytest.mark.parametrize("B", [1, 3, 8])
def test_separator_program_is_the_eager_path(separator, B):
    """Traced at B=2, run at 1, 3 and 8: `separate_batch`'s bits where both
    take the two `lstm_fwd` calls (B=1, 3); at B=8 the eager model takes
    `bilstm_fwd` (B8_ATOL)."""
    model, _, data = separator
    wav, emb = _clips(B, seed=10 + B)
    got = _run(export.load_exported(data), wav, emb)
    want = separate_batch(model, make_audio_processor(model_config(), device="cpu"), wav, emb)
    if B % 8:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=B8_ATOL)


def model_config():
    return load_config_from_str(_config_text())


def _ops_in(data: bytes) -> list:
    import io

    ep = torch.export.load(io.BytesIO(data))
    return sorted(str(n.target) for n in ep.graph.nodes
                  if n.op == "call_function" and str(n.target).startswith("voicesplit."))


@pytest.mark.parametrize("symbolic", [True, False], ids=["symbolic-batch", "batch-8"])
def test_traced_route_follows_the_batch(separator, symbolic):
    """A free batch traces the route that takes any batch (two `lstm_fwd`);
    a batch pinned to 8 keeps the model's `bilstm_fwd`, and runs at 8 with
    the eager path's bits."""
    if symbolic:
        data = separator[2]
        assert _ops_in(data) == ["voicesplit.lstm_fwd.default"] * 2
        return
    model = separator[0]
    data = export.export_separator(model_config(), model.state_dict(), seconds=SECONDS,
                                   platforms=["cpu"], symbolic_batch=False, batch_size=8)["cpu"]
    assert _ops_in(data) == ["voicesplit.bilstm_fwd.default"]
    wav, emb = _clips(8, seed=20)
    want = separate_batch(model, make_audio_processor(model_config(), device="cpu"), wav, emb)
    assert torch.equal(_run(export.load_exported(data), wav, emb), want)


def test_dilated_switch_exports_the_conv_operator(monkeypatch):
    """With ``VOICESPLIT_PALLAS_CONV=1`` at 64 channels the program calls
    ``conv_dilated_fwd`` for conv2 … conv7 and gives the eager bits."""
    monkeypatch.setenv("VOICESPLIT_PALLAS_CONV", "1")
    c = json.loads(_config_text())
    c["model"].update(conv_channels=64, conv_out_channels=2, fc2_dim=33)
    c["audio"]["voicefilter"].update(n_fft=64, hop_length=32, win_length=64, num_freq=33)
    config = load_config_from_str(json.dumps(c))
    model = weights.init_random_(make_masknet(config, device="cpu"), 3)
    data = export.export_separator(config, model.state_dict(), seconds=0.1, platforms=["cpu"])["cpu"]
    assert _ops_in(data).count("voicesplit.conv_dilated_fwd.default") == 6
    rng = np.random.default_rng(21)
    wav = (0.1 * rng.standard_normal((1, 1600))).astype(np.float32)
    emb = rng.standard_normal((1, 256)).astype(np.float32)
    want = separate_batch(model, make_audio_processor(config, device="cpu"), wav, emb)
    assert torch.equal(_run(export.load_exported(data), wav, emb), want)


def test_save_and_load_artifact_round_trip(separator, tmp_path):
    _, _, data = separator
    path = str(tmp_path / "sep.pt2")
    manifest = export.separator_manifest(SECONDS, SR, 256, None, ["cpu"])
    files = export.save_artifact(path, {"cpu": data}, manifest)
    assert files == {"cpu": path}
    written = json.loads((tmp_path / "sep.pt2.json").read_text())
    assert written["artifacts"] == {"cpu": "sep.pt2"} and written["batch"] == "symbolic"
    assert written["load_needs"] == "import voicesplit_tpu_torch.ops"
    wav, emb = _clips(2, seed=30)
    assert torch.equal(_run(export.load_artifact(path), wav, emb),
                       _run(export.load_exported(data), wav, emb))


def test_one_program_a_platform_listed_in_the_manifest(separator, tmp_path):
    """Two devices: one file each beside the named path, both in the
    manifest; `load_artifact` takes the one for the device asked for."""
    _, _, data = separator
    path = str(tmp_path / "sep.pt2")
    files = export.save_artifact(path, {"cuda": b"not loaded here", "cpu": data}, {"kind": "e2e"})
    assert files == {"cuda": str(tmp_path / "sep.cuda.pt2"), "cpu": str(tmp_path / "sep.cpu.pt2")}
    assert json.loads((tmp_path / "sep.pt2.json").read_text())["artifacts"] == {
        "cuda": "sep.cuda.pt2", "cpu": "sep.cpu.pt2"}
    wav, emb = _clips(1, seed=31)
    assert torch.equal(_run(export.load_artifact(path, device="cpu"), wav, emb),
                       _run(export.load_exported(data), wav, emb))
    with pytest.raises(ValueError, match="unknown platforms"):
        export.export_separator(model_config(), {}, platforms=["tpu"])


def test_default_platform_is_the_card_never_a_silent_cpu(separator):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default exports for it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_separator(model_config(), separator[0].state_dict(), seconds=SECONDS)


def test_streaming_step_threads_state_as_process_chunk(streaming):
    """Three chunks through the saved step: `process_chunk`'s output and
    state bit for bit, and the JAX `StreamingSeparator`'s within JAX_ATOL."""
    model, variables, data, _ = streaming
    step = export.load_exported(data)
    sep = StreamingSeparator(model_config(), model, chunk_frames=CHUNK, device="cpu")
    jsep = JaxStreamingSeparator(jax_load_config_from_str(_config_text()), variables,
                                 chunk_frames=CHUNK)
    state, jstate = sep.init_state(1), jsep.init_state(1)
    fields = export.state_fields(state)
    rng = np.random.default_rng(40)
    emb = rng.standard_normal((1, 256)).astype(np.float32)
    for i in range(3):
        samples = (0.1 * rng.standard_normal((1, sep.chunk_samples))).astype(np.float32)
        state, want = sep.process_chunk(state, samples, emb)
        jstate, jwant = jsep.process_chunk(jstate, samples, emb)
        with torch.no_grad():
            *fields, got = step(*fields, torch.from_numpy(samples), torch.from_numpy(emb))
        assert torch.equal(got, want), f"chunk {i}"
        assert all(torch.equal(a, b) for a, b in zip(fields, export.state_fields(state)))
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=JAX_ATOL,
                                   err_msg=f"chunk {i}")


def test_streaming_manifest_has_the_jax_values(streaming):
    _, variables, _, manifest = streaming
    _, want = jax_export_streaming(jax_load_config_from_str(_config_text()), variables,
                                   chunk_frames=CHUNK, platforms=["cpu"])
    for key, value in want.items():
        assert manifest[key] == value, key
    assert manifest["platforms"] == ["cpu"]


FAKE_CASES = {
    "lstm_fwd": lambda: (torch.randn(7, 3, 64), torch.randn(16, 64), torch.zeros(3, 16),
                         torch.zeros(3, 16)),
    "bilstm_fwd": lambda: (torch.randn(7, 4, 64), torch.randn(16, 64), torch.randn(16, 64)),
    "conv_dilated_fwd": lambda: (torch.randn(1, 9, 11, 64), 0.1 * torch.randn(5, 5, 64, 64), 2),
}


@pytest.mark.parametrize("name", sorted(FAKE_CASES))
def test_operator_fake_gives_the_real_shapes(name):
    """Each operator's fake implementation against its real outputs, and
    `torch.library.opcheck`'s schema, fake-tensor and dynamic-shape checks."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = getattr(torch.ops.voicesplit, name)
    args = FAKE_CASES[name]()
    real = op(*args)
    with FakeTensorMode() as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args))
    real, fake = (real, fake) if isinstance(real, tuple) else ((real,), (fake,))
    assert [(tuple(f.shape), f.dtype) for f in fake] == [(tuple(r.shape), r.dtype) for r in real]
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_faketensor",
                                                 "test_aot_dispatch_dynamic"))


def test_operators_are_the_wrappers_launch_path(monkeypatch):
    """`lstm_fwd`, `bilstm_fwd` and `conv_dilated_fwd`, with and without
    autograd, all go through the operators."""
    seen = []
    for name, impl in (("lstm_fwd", lstm_cuda.lstm_fwd_ref), ("bilstm_fwd", lstm_cuda.bilstm_fwd_ref),
                       ("conv_dilated_fwd", conv_cuda.conv_dilated_fwd_ref)):
        monkeypatch.setattr(lstm_cuda if "lstm" in name else conv_cuda, f"{name}_ref",
                            lambda *a, _n=name, _f=impl: seen.append(_n) or _f(*a))
    args = {k: f() for k, f in FAKE_CASES.items()}
    lstm_cuda.lstm_fwd(*args["lstm_fwd"])
    lstm_cuda.bilstm_fwd(*args["bilstm_fwd"])
    conv_cuda.conv_dilated_fwd(*args["conv_dilated_fwd"])
    xp = args["lstm_fwd"][0].requires_grad_()
    lstm_cuda.lstm_fwd(xp, *args["lstm_fwd"][1:])[0].sum().backward()
    assert seen == ["lstm_fwd", "bilstm_fwd", "conv_dilated_fwd", "lstm_fwd"]


def _checkpoint(tmp_path, streaming):
    from voicesplit_tpu_torch.train import create_train_state, make_optimizer
    from voicesplit_tpu_torch.train.checkpoint import (
        convert_bilstm_checkpoint_to_streaming, save_checkpoint,
    )

    config = model_config()
    model, _ = _model(seed=4)
    path = save_checkpoint(str(tmp_path / "offline"),
                           create_train_state(model, make_optimizer(config, model)), config)
    if streaming:
        path = convert_bilstm_checkpoint_to_streaming(path, str(tmp_path / "stream"), device="cpu")
    return path


@pytest.mark.parametrize("streaming", [False, True], ids=["separator", "streaming"])
def test_cli_writes_program_and_manifest(streaming, tmp_path, capsys):
    from voicesplit_tpu_torch.cli.export import main
    from voicesplit_tpu_torch.train.checkpoint import config_from_checkpoint, load_model_variables

    ckpt = _checkpoint(tmp_path, streaming)
    out = str(tmp_path / "prog.pt2")
    args = ["--checkpoint_path", ckpt, "--output", out, "--platforms", "cpu"]
    args += ["--streaming", "--chunk_frames", str(CHUNK)] if streaming else ["--seconds", str(SECONDS)]
    assert main(args) == {"cpu": out}
    assert "wrote" in capsys.readouterr().out
    manifest = json.loads(pathlib.Path(out + ".json").read_text())
    assert manifest["artifacts"] == {"cpu": "prog.pt2"}
    program = export.load_artifact(out)
    config = config_from_checkpoint(ckpt)  # the streaming conversion's is causal
    model = make_masknet(config, streaming=streaming, device="cpu")
    model.load_state_dict(load_model_variables(config, ckpt, streaming=streaming))
    rng = np.random.default_rng(50)
    emb = rng.standard_normal((1, 256)).astype(np.float32)
    if streaming:
        assert manifest["kind"] == "streaming_chunk_step" and manifest["chunk_frames"] == CHUNK
        sep = StreamingSeparator(config, model, chunk_frames=CHUNK, device="cpu")
        samples = (0.1 * rng.standard_normal((1, sep.chunk_samples))).astype(np.float32)
        _, want = sep.process_chunk(sep.init_state(1), samples, emb)
        with torch.no_grad():
            got = program(*export.state_fields(sep.init_state(1)), torch.from_numpy(samples),
                          torch.from_numpy(emb))[-1]
    else:
        assert manifest["kind"] == "e2e_separator" and manifest["samples"] == L
        wav = (0.1 * rng.standard_normal((1, L))).astype(np.float32)
        want = separate_batch(model, make_audio_processor(model_config(), device="cpu"), wav, emb)
        got = _run(program, wav, emb)
    assert torch.equal(got, want)


def test_cold_load_needs_no_model_code(separator, tmp_path):
    """A fresh interpreter loads the saved program through `load_artifact`
    and runs it: the output is this process's, and neither JAX, the JAX
    package nor any model, DSP or streaming module of the port is loaded."""
    _, _, data = separator
    path = tmp_path / "sep.pt2"
    path.write_bytes(data)
    wav, emb = _clips(3, seed=60)
    np.savez(tmp_path / "in.npz", wav=wav, emb=emb)
    code = textwrap.dedent(
        f"""
        import sys
        import numpy as np
        import torch
        torch.set_num_threads(2)  # this process's: the CPU's sums follow the threads
        from voicesplit_tpu_torch.export import load_artifact
        program = load_artifact({str(path)!r})
        d = np.load({str(tmp_path / "in.npz")!r})
        with torch.no_grad():
            out = program(torch.from_numpy(d["wav"]), torch.from_numpy(d["emb"]))
        np.save({str(tmp_path / "out.npy")!r}, out.numpy())
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")
               or m.startswith(("voicesplit_tpu_torch.models", "voicesplit_tpu_torch.dsp",
                                "voicesplit_tpu_torch.streaming"))]
        assert not bad, bad
        print("COLD_OK")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "COLD_OK" in proc.stdout
    assert np.array_equal(np.load(tmp_path / "out.npy"), _run(export.load_exported(data), wav, emb).numpy())
