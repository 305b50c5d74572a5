"""The port's small host CLIs against the JAX package's: `cli.generate_csv`
(the same file, byte for byte), `cli.resample` (the same samples in both
modes) and `cli.convert` (the port's own Griffin-Lim; its initial phase is
the port's draw, held to JAX's with shared angles in
`tests/test_torch_griffin_lim.py`), on a synthetic speaker corpus.
"""

import pathlib

import numpy as np
import pytest
import torch

from voicesplit_tpu.cli import generate_csv as jax_generate_csv
from voicesplit_tpu.cli.resample import _process as jax_process
from voicesplit_tpu_torch.cli import convert as convert_cli
from voicesplit_tpu_torch.cli import generate_csv as generate_csv_cli
from voicesplit_tpu_torch.cli import resample as resample_cli
from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float
from voicesplit_tpu_torch.dsp.processor import make_audio_processor

SR = 16000
SPEAKERS = ("p225", "p226", "p227", "p228")
RESAMPLE_ATOL = 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Four speakers of six clips each at 22.05 kHz: parallel utterance ids
    across speakers, one clip a speaker shorter than the 1 s minimum."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for s, spk in enumerate(SPEAKERS):
        (root / spk).mkdir()
        for u in range(6):
            seconds = 0.6 if u == 2 else rng.uniform(1.1, 1.6)
            n = int(22050 * seconds)
            t = np.arange(n) / 22050
            wav = 0.3 * np.sin(2 * np.pi * (120 + 30 * s + 7 * u) * t) + 0.02 * rng.standard_normal(n)
            save_wav_float(wav.astype(np.float32), str(root / spk / f"{spk}_{u:03d}.wav"), 22050)
    (root / "notes.txt").write_text("not a speaker")
    return root


@pytest.mark.parametrize("extra", [["--seed", "0"], ["--seed", "5"], ["--seed", "1", "--max_pairs", "5"]])
def test_generate_csv_is_byte_equal_to_jax(extra, corpus, tmp_path):
    common = ["--dataset_dir", str(corpus), "--audio_len", "1.0", *extra]
    rows = generate_csv_cli.main([*common, "--output", str(tmp_path / "port" / "dev.csv")])
    jax_generate_csv.main([*common, "--output", str(tmp_path / "jax" / "dev.csv")])
    got = (tmp_path / "port" / "dev.csv").read_bytes()
    assert got == (tmp_path / "jax" / "dev.csv").read_bytes()
    assert len(rows) == (5 if "--max_pairs" in extra else 12)
    assert got.startswith(b"clean_utterance,embedding_utterance,interference_utterance\n")
    for clean, emb, intf in rows:
        assert clean != emb and clean.split("/")[0] == emb.split("/")[0] != intf.split("/")[0]
        assert not clean.endswith("_002.wav")  # the short clip is rejected


def test_generate_csv_takes_named_speakers(corpus, tmp_path):
    common = ["--dataset_dir", str(corpus), "--audio_len", "1.0", "--speakers", "p227", "p225"]
    generate_csv_cli.main([*common, "--output", str(tmp_path / "a.csv")])
    jax_generate_csv.main([*common, "--output", str(tmp_path / "b.csv")])
    assert (tmp_path / "a.csv").read_bytes() == (tmp_path / "b.csv").read_bytes()
    assert len((tmp_path / "a.csv").read_text().splitlines()) == 3


@pytest.mark.parametrize("mode", ["ebu", "peak"])
def test_resample_process_equals_jax(mode, corpus, tmp_path):
    """One file through each package's worker function: 22.05 → 16 kHz, then
    loudness or peak normalization."""
    src = corpus / "p226" / "p226_004.wav"
    outs = {}
    for name, fn in (("port", resample_cli._process), ("jax", jax_process)):
        copy = tmp_path / name / src.name
        copy.parent.mkdir()
        copy.write_bytes(src.read_bytes())
        assert fn(str(copy), SR, "-norm", mode, 0.95, -23.0)
        outs[name] = load_wav(str(copy.with_name("p226_004-norm.wav")))
    assert len(outs["port"]) == len(outs["jax"]) == int(np.ceil(len(load_wav(str(src))) * SR / 22050))
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=RESAMPLE_ATOL, rtol=0)
    if mode == "peak":
        assert np.isclose(np.abs(outs["port"]).max(), 0.95, atol=1e-6)


def test_resample_cli_walks_the_tree_in_a_spawned_pool(corpus, tmp_path):
    """The CLI over a copy of two speakers with two workers: every wav gets its
    ``-norm`` twin equal to JAX's worker's, and a second run skips the
    twins."""
    import shutil

    root = tmp_path / "tree"
    for spk in SPEAKERS[:2]:
        shutil.copytree(corpus / spk, root / spk)
    assert resample_cli.main(["--root", str(root), "--num_workers", "2"]) == (12, 12)
    for spk in SPEAKERS[:2]:
        for u in (0, 5):
            name = f"{spk}_{u:03d}"
            ref = tmp_path / "ref" / f"{name}.wav"
            ref.parent.mkdir(exist_ok=True)
            ref.write_bytes((root / spk / f"{name}.wav").read_bytes())
            jax_process(str(ref), SR, "-norm", "ebu", 0.95, -23.0)
            np.testing.assert_allclose(load_wav(str(root / spk / f"{name}-norm.wav")),
                                       load_wav(str(tmp_path / "ref" / f"{name}-norm.wav")),
                                       atol=RESAMPLE_ATOL, rtol=0)
    assert resample_cli.main(["--root", str(root), "--num_workers", "2"]) == (12, 12)


def test_convert_equals_the_ports_griffin_lim(tmp_path):
    """``*.npy`` and ``*.pt`` spectrograms through the CLI on the CPU: each
    wav is `AudioProcessor.spec2wav(spec, None)` written by `save_wav`."""
    config = Config()
    config.audio.voicefilter.griffin_lim_iters = 8  # the file's time; the CLI reads the config
    (tmp_path / "c.json").write_text(config.to_json())
    ap = make_audio_processor(config, device="cpu")
    rng = np.random.default_rng(3)
    t = np.arange(int(0.5 * SR)) / SR
    specs = {}
    for i, name in enumerate(("a.npy", "b.pt")):
        wav = (0.3 * np.sin(2 * np.pi * (200 + 150 * i) * t) + 0.01 * rng.standard_normal(len(t)))
        spec = ap.wav2spec(wav.astype(np.float32))[0]
        specs[name] = spec
        if name.endswith(".npy"):
            np.save(tmp_path / name, spec)
        else:
            torch.save(torch.from_numpy(spec), tmp_path / name)
    written = convert_cli.main(["--input_dir", str(tmp_path), "--output_dir", str(tmp_path / "wavs"),
                                "-c", str(tmp_path / "c.json"), "--device", "cpu"])
    assert [pathlib.Path(p).name for p in written] == ["a.wav", "b.wav"]
    for name, spec in specs.items():
        ap.save_wav(ap.spec2wav(spec, None), str(tmp_path / "want.wav"))
        out = tmp_path / "wavs" / (name.split(".")[0] + ".wav")
        assert out.read_bytes() == (tmp_path / "want.wav").read_bytes()
        assert len(load_wav(str(out))) == (spec.shape[0] - 1) * ap.hop_length
