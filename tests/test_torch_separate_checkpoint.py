"""The serving CLI on the JAX CLI's command line: `cli.separate
--checkpoint_path` with a JAX ``.msgpack`` or a port ``checkpoint_<step>.pt``,
the config from the checkpoint, ``.npy`` and ``.pt`` d-vectors, and the one
checkpoint loader under `cli.test` and `cli.export`.

Both CLIs run on the same files at a small fp32 config
(`test_torch_separate.py::_config_text`); the written wavs are compared in
int16 units.  Each CLI scales its output to its own peak, so one float32
round-off of the waveform is a fraction of an LSB there: the two files agree
to WAV_LSB.  The port reads a JAX checkpoint to the same state dict as its own
``.pt`` of the same weights, so those two outputs are the same bytes.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import scipy.io.wavfile
import torch

import jax
import jax.numpy as jnp

from voicesplit_tpu.cli import separate as jax_separate_cli
from voicesplit_tpu.config import load_config as jax_load_config
from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.streaming import StreamingSeparator as JaxStreamingSeparator
from voicesplit_tpu.train import checkpoint as jax_checkpoint
from voicesplit_tpu.train import state as jax_state
from voicesplit_tpu_torch import export, weights
from voicesplit_tpu_torch.cli import export as export_cli
from voicesplit_tpu_torch.cli import separate as separate_cli
from voicesplit_tpu_torch.cli import test as test_cli
from voicesplit_tpu_torch.config import load_config, load_config_from_str
from voicesplit_tpu_torch.dsp import griffin_lim as gl_module
from voicesplit_tpu_torch.models.masknet import make_masknet
from voicesplit_tpu_torch.streaming import StreamingSeparator
from voicesplit_tpu_torch.train import checkpoint as ckpt
from voicesplit_tpu_torch.train import create_train_state, make_optimizer

REPO = pathlib.Path(__file__).resolve().parents[1]
HOP, FRAMES = 32, 40
L = HOP * FRAMES
EMB = 16
CHUNK = 8
GL_ITERS = 4
WAV_LSB = 2  # int16 units, JAX CLI vs port CLI (fp32; 0 or 1 seen, Griffin-Lim included)
EXPORT_ATOL = 1e-5  # one streaming chunk, the exported program vs the JAX separator


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads each,
    and no persistent compile cache for the JAX CLI."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("VOICESPLIT_NO_COMPILE_CACHE", "1")
        yield
    torch.set_num_threads(before)


def _config_text(fc1_dim=24):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=HOP, win_length=64, num_freq=65,
                                     griffin_lim_iters=GL_ITERS)
    d["model"].update(conv_channels=8, lstm_dim=16, fc1_dim=fc1_dim, fc2_dim=65, emb_dim=EMB)
    d["train_config"]["compute_dtype"] = "float32"
    return json.dumps(d)


def _jax_checkpoint(out_dir, text, seed, step=5):
    """A JAX ``checkpoint_<step>.msgpack`` of random weights (JAX layout, from
    `weights.random_jax_variables`) and an Adam state, written by the JAX
    package's `save_checkpoint`; returns its path and the JAX trees."""
    jc = jax_config(text)
    template = make_masknet(load_config_from_str(text), device="cpu")
    params, stats = weights.random_jax_variables(template, seed)
    tx = jax_state.make_optimizer(jc)
    jstate = jax_state.TrainState(step=jnp.asarray(step, jnp.int32), params=params,
                                  batch_stats=stats, opt_state=tx.init(params))
    return jax_checkpoint.save_checkpoint(str(out_dir), jstate, jc), params, stats


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX BiLSTM checkpoint, the port's ``.pt`` of the same weights, the
    JAX conversion of it to the streaming model, the config beside them, a
    mixture and its d-vector as ``.npy`` and ``.pt``."""
    root = tmp_path_factory.mktemp("separate_checkpoint")
    text = _config_text()
    (root / "config.json").write_text(text)
    msgpack, params, stats = _jax_checkpoint(root / "jax", text, seed=3)
    tc = load_config_from_str(text)
    model = make_masknet(tc, device="cpu")
    model.load_state_dict(weights.state_dict_from_jax(params, stats))
    pt = ckpt.save_checkpoint(str(root / "port"), create_train_state(
        model, make_optimizer(tc, model)), tc)
    stream = jax_checkpoint.convert_bilstm_checkpoint_to_streaming(msgpack, str(root / "jax_stream"))
    rng = np.random.default_rng(4)
    t = np.arange(L) / 16000.0
    mixed = 0.2 * np.sin(2 * np.pi * 220.0 * t) + 0.05 * rng.standard_normal(L)
    scipy.io.wavfile.write(str(root / "mix.wav"), 16000, mixed.astype(np.float32))
    emb = rng.standard_normal(EMB).astype(np.float32)
    np.save(root / "emb.npy", emb)
    torch.save(torch.from_numpy(emb), str(root / "emb.pt"))
    return {"root": root, "text": text, "config": str(root / "config.json"), "msgpack": msgpack,
            "pt": pt, "stream": stream, "params": params, "stats": stats,
            "mix": str(root / "mix.wav"), "npy": str(root / "emb.npy"),
            "emb_pt": str(root / "emb.pt")}


def _args(files, checkpoint, out, emb="npy", extra=()):
    return ["--checkpoint_path", checkpoint, "--mixed_wav", files["mix"], "--emb", files[emb],
            "--output", str(out), *extra]


def _port(files, checkpoint, name, emb="npy", extra=()):
    """The port's CLI on the CPU; returns the written file's bytes."""
    out = files["root"] / name
    separate_cli.main(_args(files, checkpoint, out, emb, [*extra, "--device", "cpu"]))
    return out.read_bytes()


def _jax(files, checkpoint, name, emb="npy", extra=()):
    """The JAX CLI on the same files; returns the written file's bytes."""
    out = files["root"] / name
    jax_separate_cli.main(_args(files, checkpoint, out, emb, extra))
    return out.read_bytes()


def _samples(wav_bytes, tmp_name):
    path = pathlib.Path(tmp_name)
    path.write_bytes(wav_bytes)
    sr, data = scipy.io.wavfile.read(str(path))
    assert sr == 16000 and data.dtype == np.int16
    return data.astype(np.int64)


def _assert_wavs_close(files, got, want):
    a = _samples(got, files["root"] / "_got.wav")
    b = _samples(want, files["root"] / "_want.wav")
    assert a.shape == b.shape == (L,)
    assert np.abs(a).max() > 1000  # a real signal
    assert np.abs(a - b).max() <= WAV_LSB, np.abs(a - b).max()


@pytest.fixture(scope="module")
def jax_plain(files):
    """The JAX CLI's output for the JAX checkpoint, config from it."""
    return _jax(files, files["msgpack"], "jax_plain.wav")


# ---------------------------------------------------------------------------
# --checkpoint_path: a JAX .msgpack, a port .pt, with and without -c
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_c", [False, True], ids=["config_from_checkpoint", "with_c"])
def test_jax_msgpack_matches_the_jax_cli(with_c, files, jax_plain):
    extra = ["-c", files["config"]] if with_c else []
    got = _port(files, files["msgpack"], f"port_msgpack_{with_c}.wav", extra=extra)
    _assert_wavs_close(files, got, jax_plain)
    if with_c:  # the config from the checkpoint is the -c one: the same bytes
        assert got == (files["root"] / "port_msgpack_False.wav").read_bytes()


def test_port_checkpoint_without_c_is_the_msgpacks_bytes(files, jax_plain):
    """A port ``checkpoint_<step>.pt`` of the same weights: the same state
    dict and so the same file, byte for byte, as the JAX ``.msgpack``."""
    got = _port(files, files["pt"], "port_pt.wav")
    assert got == _port(files, files["msgpack"], "port_msgpack_again.wav")
    _assert_wavs_close(files, got, jax_plain)


@pytest.mark.parametrize("cli", ["jax", "port"])
def test_npy_and_pt_dvectors_give_the_same_output(cli, files):
    run = _jax if cli == "jax" else _port
    a = run(files, files["msgpack"], f"{cli}_npy.wav", emb="npy")
    b = run(files, files["msgpack"], f"{cli}_pt.wav", emb="emb_pt")
    assert a == b


@pytest.mark.parametrize("flag", ["--sequence_parallel", "--griffin_lim"])
def test_flags_through_checkpoint_path_match_the_jax_cli(flag, files, jax_plain, monkeypatch):
    """``--sequence_parallel`` (a world of one here, JAX's 8 CPU devices)
    and ``--griffin_lim`` (from JAX's initial angles, `PRNGKey(0)`)."""
    if flag == "--griffin_lim":
        monkeypatch.setattr(gl_module, "griffin_lim_angles", lambda shape, generator=None:
                            torch.from_numpy(np.array(2.0 * jnp.pi * jax.random.uniform(
                                jax.random.PRNGKey(0), tuple(shape), jnp.float32))))
    got = _port(files, files["msgpack"], f"port{flag}.wav", extra=[flag])
    want = _jax(files, files["msgpack"], f"jax{flag}.wav", extra=[flag])
    _assert_wavs_close(files, got, want)
    if flag == "--sequence_parallel":
        assert got == (files["root"] / "port_msgpack_False.wav").read_bytes()


def test_streaming_from_the_jax_conversion_matches_the_jax_cli(files):
    """``--streaming`` on the JAX `cli.convert_streaming` output (causal
    config from the checkpoint), chunk by chunk in both CLIs."""
    extra = ["--streaming", "--chunk_frames", str(CHUNK)]
    got = _port(files, files["stream"], "port_stream.wav", extra=extra)
    want = _jax(files, files["stream"], "jax_stream.wav", extra=extra)
    _assert_wavs_close(files, got, want)


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cli,which", [("jax", "msgpack"), ("port", "msgpack"), ("port", "pt")])
def test_bilstm_checkpoint_with_streaming_raises(cli, which, files):
    run = _jax if cli == "jax" else _port
    with pytest.raises(ValueError, match="does not fit the streaming model"):
        run(files, files[which], f"refused_{cli}_{which}.wav", extra=["--streaming"])


@pytest.mark.parametrize("case", ["both", "neither", "weights_file_without_c"])
def test_argument_errors(case, files, capsys):
    w = files["root"] / "w.pt"
    weights.save(make_masknet(load_config_from_str(files["text"]), device="cpu"), str(w))
    base = ["--mixed_wav", files["mix"], "--emb", files["npy"], "--output",
            str(files["root"] / "never.wav"), "--device", "cpu"]
    args = {"both": ["--checkpoint_path", files["msgpack"], "--weights", str(w)],
            "neither": [], "weights_file_without_c": ["--weights", str(w)]}[case]
    with pytest.raises(SystemExit) as e:
        separate_cli.main(args + base)
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert {"both": "not allowed with", "neither": "one of the arguments",
            "weights_file_without_c": "needs -c"}[case] in err
    assert not (files["root"] / "never.wav").exists()


def test_load_weights_refuses_a_misfit_msgpack_before_loading(files, monkeypatch):
    """`cli.test` on a JAX checkpoint that is not the ``-c`` config's model
    (fc1 24 against 20): the loader's shape check names it, and no
    ``load_state_dict`` is reached."""
    other = files["root"] / "fc1_20.json"
    other.write_text(_config_text(fc1_dim=20))
    monkeypatch.setattr(torch.nn.Module, "load_state_dict", lambda *a, **k: pytest.fail("loaded"))
    with pytest.raises(ValueError, match=r"does not fit the model: .*fc1\.weight: checkpoint"):
        test_cli.load_weights(files["msgpack"], str(other))
    with pytest.raises(ValueError, match="does not fit the model"):
        test_cli.main(["--checkpoint_path", files["msgpack"], "-c", str(other), "--device", "cpu"])


# ---------------------------------------------------------------------------
# The loader: configs, streaming trees, export
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["voicesplit", "voicefilter", "voicesplit_wide"])
def test_config_from_a_jax_checkpoint_is_the_c_config(name, tmp_path):
    """The ``config_str`` the JAX package writes into a checkpoint loads in the
    port to the config that ``-c`` gives from the same file."""
    path = str(REPO / "configs" / f"{name}.json")
    from_checkpoint = load_config_from_str(jax_load_config(path).to_json())
    assert from_checkpoint.to_dict() == load_config(path).to_dict()


def test_config_from_checkpoint_reads_both_formats(files):
    want = load_config_from_str(files["text"]).to_dict()
    assert ckpt.config_from_checkpoint(files["msgpack"]).to_dict() == want
    assert ckpt.config_from_checkpoint(files["pt"]).to_dict() == want
    assert ckpt.config_from_checkpoint(files["stream"]).model.causal is True


def test_state_dict_from_jax_maps_the_jax_streaming_tree(files):
    """A file of the JAX `cli.convert_streaming` (``lstm/fwd_*`` only, fc1
    ``[H, fc1]``) carries into the port's streaming model, to the weights of
    the port's own conversion of the same BiLSTM checkpoint."""
    payload = ckpt.load_jax_checkpoint(files["stream"])
    assert sorted(payload["params"]["lstm"]) == ["fwd_b", "fwd_w_hh", "fwd_w_ih"]
    assert payload["params"]["fc1"]["kernel"].shape == (16, 24)
    config = ckpt.config_from_checkpoint(files["stream"])
    got = ckpt.load_model_variables(config, files["stream"], streaming=True)
    want_sd = make_masknet(config, streaming=True, device="meta").state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want_sd.items()}
    port = ckpt.convert_bilstm_checkpoint_to_streaming(
        files["msgpack"], str(files["root"] / "port_stream"), device="cpu")
    mine = ckpt.load_model_variables(config, port, streaming=True)
    for k in want_sd:
        assert torch.equal(got[k], mine[k]), k


def test_export_streaming_reads_a_jax_streaming_msgpack(files):
    """`cli.export --streaming` on the JAX conversion: the program's chunk is
    `process_chunk`'s on the same weights, bit for bit, and the JAX
    `StreamingSeparator`'s within EXPORT_ATOL; the BiLSTM file is refused."""
    out = str(files["root"] / "stream.pt2")
    assert export_cli.main(["--checkpoint_path", files["stream"], "--output", out,
                            "--streaming", "--chunk_frames", str(CHUNK),
                            "--platforms", "cpu"]) == {"cpu": out}
    config = ckpt.config_from_checkpoint(files["stream"])
    model = make_masknet(config, streaming=True, device="cpu")
    model.load_state_dict(ckpt.load_model_variables(config, files["stream"], streaming=True))
    sep = StreamingSeparator(config, model, chunk_frames=CHUNK, device="cpu")
    jpayload = jax_checkpoint.load_checkpoint(files["stream"])
    jsep = JaxStreamingSeparator(jax_config(jpayload["config_str"]), {
        "params": jpayload["model"], "batch_stats": jpayload["batch_stats"]}, chunk_frames=CHUNK)
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((1, EMB)).astype(np.float32)
    samples = (0.1 * rng.standard_normal((1, sep.chunk_samples))).astype(np.float32)
    _, want = sep.process_chunk(sep.init_state(1), samples, emb)
    _, jwant = jsep.process_chunk(jsep.init_state(1), samples, emb)
    state = export.state_fields(sep.init_state(1))
    with torch.no_grad():
        *_, got = export.load_artifact(out)(*state, torch.from_numpy(samples), torch.from_numpy(emb))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=EXPORT_ATOL)
    with pytest.raises(ValueError, match="does not fit the streaming model"):
        export_cli.main(["--checkpoint_path", files["msgpack"], "--output",
                         str(files["root"] / "never.pt2"), "--streaming", "--platforms", "cpu"])


def test_cli_on_a_jax_checkpoint_runs_without_jax(files):
    """A fresh interpreter runs the JAX CLI's command line (a ``.msgpack``, no
    ``-c``, a ``.pt`` d-vector) through the port: JAX, flax and the JAX
    package never load, and the file is the in-process run's."""
    want = _port(files, files["msgpack"], "in_process.wav", emb="emb_pt")
    out = files["root"] / "fresh.wav"
    args = _args(files, files["msgpack"], out, "emb_pt", ["--device", "cpu"])
    code = textwrap.dedent(f"""
        import sys
        from voicesplit_tpu_torch.cli.separate import main
        main({args!r})
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
        """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=300, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    assert out.read_bytes() == want


def test_smoke_writes_the_bytes_flax_writes(files):
    """`chip_smoke.flax_msgpack` of a JAX checkpoint payload
    (`chip_smoke.jax_checkpoint_tree`: variables, Adam state with an int32
    count, config string, data position) is byte for byte
    ``flax.serialization.msgpack_serialize`` of the same tree, and the port
    reads it back to the same trees."""
    import importlib.util

    import flax.serialization

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    tree = chip_smoke.jax_checkpoint_tree(files["params"], files["stats"],
                                          load_config_from_str(files["text"]))
    blob = chip_smoke.flax_msgpack(tree)
    assert blob == flax.serialization.msgpack_serialize(tree)
    path = files["root"] / "smoke" / "checkpoint_0.msgpack"
    path.parent.mkdir()
    path.write_bytes(blob)
    payload = ckpt.load_jax_checkpoint(str(path))
    assert payload["step"] == 0 and payload["opt_state"]["0"]["count"] == 0
    got = weights.state_dict_from_jax(payload["params"], payload["batch_stats"])
    want = weights.state_dict_from_jax(files["params"], files["stats"])
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
