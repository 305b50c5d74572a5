"""The reference-checkpoint import (`voicesplit_tpu_torch/train/torch_import.py`,
`cli/import_torch.py`) against the JAX package's mapping and the reference
torch model (`voicesplit_tpu/models/torch_ref.py`), from a random reference
state dict (no checkpoint needed), at narrow widths on the CPU.
"""

import json
import pathlib

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax.numpy as jnp

from test_torch_parity import randomize_torch_model
from voicesplit_tpu.config import load_config_from_str as jax_config_from_str
from voicesplit_tpu.models.masknet import MaskNet as JaxMaskNet
from voicesplit_tpu.models.torch_ref import build_reference_torch_model
from voicesplit_tpu.train import torch_import as jax_import
from voicesplit_tpu_torch.cli import import_torch as import_cli
from voicesplit_tpu_torch.cli import separate as separate_cli
from voicesplit_tpu_torch.config import Config, load_config_from_str
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float
from voicesplit_tpu_torch.models.masknet import MaskNet
from voicesplit_tpu_torch.train import torch_import
from voicesplit_tpu_torch.train.checkpoint import load_checkpoint
from voicesplit_tpu_torch.train.trainer import Trainer

REPO = pathlib.Path(__file__).resolve().parents[1]
# the reference's conv stack is 64 channels into 8; the rest narrowed
DIMS = dict(num_freq=65, emb_dim=16, lstm_dim=16, fc1_dim=24, fc2_dim=65)
B, T = 2, 20
MASK_PEAK_REL = 1e-5  # fp32: the same function, sums in another order


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _reference(activation: str, seed: int) -> nn.Module:
    ref = build_reference_torch_model(activation, **DIMS)
    randomize_torch_model(ref, seed=seed)  # running statistics too
    return ref.eval()


def _inputs(seed: int = 1):
    rng = np.random.default_rng(seed)
    spec = rng.uniform(0, 1, (B, T, DIMS["num_freq"])).astype(np.float32)
    emb = rng.standard_normal((B, DIMS["emb_dim"])).astype(np.float32)
    return spec, emb


@pytest.mark.parametrize("channels", [2, 8])
@pytest.mark.parametrize("num_freq", [65, 601])
def test_flatten_permutation_equals_jax(num_freq, channels):
    got = torch_import.flatten_permutation(num_freq, channels)
    np.testing.assert_array_equal(got, jax_import.flatten_permutation(num_freq, channels))
    assert sorted(got.tolist()) == list(range(num_freq * channels))


@pytest.mark.parametrize("activation", ["relu", "mish"])
def test_imported_model_is_the_reference_and_jax_model(activation):
    """A random reference state dict imported into the port's `MaskNet` gives
    the reference torch model's mask and that of JAX's mapping into its
    `MaskNet` (eval mode, fp32, within 1e-5 of the peak)."""
    ref = _reference(activation, seed=3)
    spec, emb = _inputs()
    with torch.no_grad():
        want = ref(torch.from_numpy(spec), torch.from_numpy(emb)).numpy()
    sd = ref.state_dict()
    port = MaskNet(activation=activation, **DIMS).eval()
    port.load_state_dict(torch_import.convert_torch_state_dict(sd, num_freq=DIMS["num_freq"]))
    with torch.no_grad():
        got = port(torch.from_numpy(spec), torch.from_numpy(emb)).numpy()
    params, stats = jax_import.convert_torch_state_dict(sd, num_freq=DIMS["num_freq"])
    jmask = JaxMaskNet(activation=activation, compute_dtype=jnp.float32, **DIMS).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(spec), jnp.asarray(emb), train=False)
    peak = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=MASK_PEAK_REL * peak, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jmask), atol=MASK_PEAK_REL * peak, rtol=0)


def test_import_carries_jax_mapping_leaf_for_leaf():
    """The port's state dict is JAX's ``(params, batch_stats)`` under the
    port's names and layouts, bit for bit (`weights.state_dict_from_jax`)."""
    from voicesplit_tpu_torch.weights import state_dict_from_jax

    sd = _reference("relu", seed=5).state_dict()
    got = torch_import.convert_torch_state_dict(sd, num_freq=DIMS["num_freq"])
    want = state_dict_from_jax(*jax_import.convert_torch_state_dict(sd, num_freq=DIMS["num_freq"]))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_export_round_trips_bit_for_bit():
    """export ∘ import is the identity on the port's state dict, and the
    exported dict drives the reference model to the imported model's mask."""
    ref = _reference("relu", seed=7)
    port_sd = torch_import.convert_torch_state_dict(ref.state_dict(), num_freq=DIMS["num_freq"])
    exported = torch_import.export_torch_state_dict(port_sd, num_freq=DIMS["num_freq"])
    again = torch_import.convert_torch_state_dict(exported, num_freq=DIMS["num_freq"])
    for k, v in port_sd.items():
        assert torch.equal(again[k], v), k
    assert sorted(exported) == sorted(ref.state_dict())
    ref2 = build_reference_torch_model("relu", **DIMS).eval()
    ref2.load_state_dict(exported)
    spec, emb = _inputs(2)
    with torch.no_grad():
        a = ref(torch.from_numpy(spec), torch.from_numpy(emb))
        b = ref2(torch.from_numpy(spec), torch.from_numpy(emb))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("form", ["json", "dict_repr"])
def test_parse_reference_config_str_equals_jax(form, capsys):
    """Canonical JSON and the reference's ``str(AttrDict)`` (a Python dict
    repr, here with a key the config does not know) parse to JAX's config."""
    d = Config(model_name="voicefilter").to_dict()
    d["loss"]["loss_name"] = "power_law_compression"
    if form == "json":
        text = json.dumps(d)
    else:
        d["copied_by_copy_config_file"] = True
        text = str(d)
    got = torch_import.parse_reference_config_str(text)
    want = jax_import.parse_reference_config_str(text)
    assert got.to_dict() == want.to_dict()
    assert got.model_name == "voicefilter" and got.loss.loss_name == "power_law_compression"
    if form == "dict_repr":
        assert "dropping unknown config keys ['copied_by_copy_config_file']" in capsys.readouterr().out


def _small_config_dict(tmp_path) -> dict:
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=32, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = 0.25
    d["model"].update(conv_channels=64, lstm_dim=16, fc1_dim=24, fc2_dim=65, emb_dim=16)
    d["train_config"].update(compute_dtype="float32", batch_size=2)
    d["dataset"].update(train_dir=str(tmp_path / "data"), test_dir=str(tmp_path / "data"))
    return d


def test_cli_import_writes_a_checkpoint_that_serves_and_resumes(tmp_path, capsys):
    """A reference ``checkpoint_1234.pt`` (its payload keys, ``config_str`` a
    dict repr) through `cli.import_torch`: `cli.separate` serves the written
    checkpoint with the reference model's mask, and ``Trainer(checkpoint_path
    =...)`` resumes it at step 1234 with the imported weights."""
    d = _small_config_dict(tmp_path)
    ref = _reference("mish", seed=11)
    pt = tmp_path / "checkpoint_1234.pt"
    torch.save({"model": ref.state_dict(), "optimizer": {}, "step": 1234,
                "config_str": str(d)}, pt)
    path = import_cli.main(["--torch_checkpoint", str(pt), "--output_dir", str(tmp_path / "out")])
    assert pathlib.Path(path).name == "checkpoint_1234.pt"
    payload = load_checkpoint(path)
    assert payload["step"] == 1234 and payload["optimizer"]["state"] == {}
    config = load_config_from_str(payload["config_str"])
    assert config.to_dict() == jax_config_from_str(json.dumps(d)).to_dict()

    # serving: the CLI's output against the reference model's mask on the
    # same spectrogram, through the same inversion
    (tmp_path / "c.json").write_text(json.dumps(d))
    rng = np.random.default_rng(0)
    mixed = (0.2 * rng.standard_normal(4000)).astype(np.float32)
    emb = rng.standard_normal(16).astype(np.float32)
    save_wav_float(mixed, str(tmp_path / "mix.wav"), 16000)
    np.save(tmp_path / "emb.npy", emb)
    separate_cli.main(["-c", str(tmp_path / "c.json"), "--weights", path,
                       "--mixed_wav", str(tmp_path / "mix.wav"), "--emb", str(tmp_path / "emb.npy"),
                       "--output", str(tmp_path / "out.wav"), "--device", "cpu"])
    from voicesplit_tpu_torch.dsp.processor import make_audio_processor

    ap = make_audio_processor(config, device="cpu")
    spec, phase = ap.wav2spec(mixed)
    with torch.no_grad():
        mask = ref(torch.from_numpy(spec[None]), torch.from_numpy(emb[None])).numpy()[0]
    ap.save_wav(ap.spec2wav(mask * spec, phase), str(tmp_path / "want.wav"))
    got, want = load_wav(str(tmp_path / "out.wav")), load_wav(str(tmp_path / "want.wav"))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2 / 32768, rtol=0)  # int16 files: two steps

    # training: a full restore at the imported step
    build_synthetic_dataset(str(tmp_path / "data"), 2, audio_len=0.25, emb_dim=16, seed=0)
    capsys.readouterr()
    tr = Trainer(config, checkpoint_path=path, log_dir=str(tmp_path / "logs"),
                 enable_tb=False, device="cpu")
    tr.close()
    assert "Resumed checkpoint step 1234" in capsys.readouterr().out
    assert tr.state.step == 1234
    want_sd = torch_import.convert_torch_state_dict(ref.state_dict(), num_freq=65)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(v, want_sd[k]), k
