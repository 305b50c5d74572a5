"""The port's offline preprocessing (`voicesplit_tpu_torch/data/preprocess.py`,
`cli/preprocess.py`) against the JAX package's: the same CSV rows give the
same wavs (1e-7); the saved spectrograms are the port's `wav2spec` of the
written wavs (1e-5) and, as magnitudes, JAX's to the STFT round-off that
`test_torch_dsp.py` holds (2e-4); CSV header detection and LibriSpeech
resolution as in JAX; the CLI on the CPU never loads JAX.
"""

import glob
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data import preprocess as jpre
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data import preprocess as tpre
from voicesplit_tpu_torch.data.synthetic import _speaker_wav
from voicesplit_tpu_torch.dsp.audio_io import load_wav, save_wav_float
from voicesplit_tpu_torch.dsp.normalize import db_to_amp, denormalize_db
from voicesplit_tpu_torch.dsp.processor import AudioProcessor

SR = 16000
REPO = Path(__file__).resolve().parents[1]
ROWS = ("s0/u0.wav,s0/u1.wav,s1/u0.wav\n"
        "s1/u2.wav,s1/u1.wav,s2/u0.wav\n"
        "s2/u1.wav,s2/u2.wav,s0/u2.wav\n"
        "s0/short.wav,s0/u0.wav,s1/u1.wav\n"  # too short to mix: skipped
        "s1/missing.wav,s1/u0.wav,s0/u1.wav\n")  # unreadable: skipped


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two PyTorch threads for this file's tests: several test processes
    share one machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 speakers × 3 utterances of 5 s, one short clip, a triplet CSV with a
    header, two noise files and their CSV."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    for s in range(3):
        (root / f"s{s}").mkdir()
        for k in range(3):
            save_wav_float(_speaker_wav(rng, s, 5 * SR, SR), str(root / f"s{s}" / f"u{k}.wav"), SR)
    save_wav_float(_speaker_wav(rng, 0, SR // 2, SR), str(root / "s0" / "short.wav"), SR)
    for i in range(2):
        noise = 0.01 * np.random.default_rng(i).standard_normal(SR * 12)
        save_wav_float(noise.astype(np.float32), str(root / f"noise{i}.wav"), SR)
    (root / "train.csv").write_text("clean_utterance,embedding_utterance,interference\n" + ROWS)
    (root / "noise.csv").write_text("noise\nnoise0.wav\nnoise1.wav\n")
    return root


def _config_text(audio_len=1.0):
    d = (REPO / "configs" / "voicesplit.json").read_text()
    c = load_config_from_str(d)
    c.audio.audio_len = audio_len
    return c.to_json()


def _magnitude(spec: np.ndarray, config) -> np.ndarray:
    """|STFT| of a normalized dB spectrogram."""
    p = config.audio.active
    s = denormalize_db(torch.from_numpy(spec), p.min_level_db) + p.ref_level_db
    return db_to_amp(s).numpy()


def _assert_same_dirs(got_dir, want_dir, config):
    """Wavs to 1e-7.  A spectrogram in normalized dB turns the STFT's
    absolute float32 round-off into large dB errors in the weakest bins
    (up to ~1e-3 here), so it is held to the port's own `wav2spec` of the
    written wav (1e-5) and, as a magnitude, to JAX's (2e-4)."""
    ap = AudioProcessor(config.audio, device="cpu")
    got = sorted(os.listdir(got_dir))
    assert got == sorted(os.listdir(want_dir)) and got
    for name in got:
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".wav"):
            np.testing.assert_allclose(load_wav(g), load_wav(w), atol=1e-7, rtol=0, err_msg=name)
            continue
        spec = np.load(g)
        own, _ = ap.wav2spec(load_wav(g[: -len(".npy")] + ".wav"))
        np.testing.assert_allclose(spec, own, atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(_magnitude(spec, config), _magnitude(np.load(w), config),
                                   atol=2e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("save_specs", [False, True])
def test_preprocess_csv_matches_jax(corpus, tmp_path, save_specs):
    text = _config_text()
    csv, root = str(corpus / "train.csv"), str(corpus)
    n_want = jpre.preprocess_csv(jax_config(text), csv, root, str(tmp_path / "jax"),
                                 num_workers=1, save_specs=save_specs)
    n_got = tpre.preprocess_csv(load_config_from_str(text), csv, root, str(tmp_path / "port"),
                                num_workers=1, save_specs=save_specs, device="cpu")
    assert n_got == n_want == 3
    _assert_same_dirs(tmp_path / "port", tmp_path / "jax", load_config_from_str(text))
    assert len(glob.glob(str(tmp_path / "port" / "*.npy"))) == (6 if save_specs else 0)


def test_preprocess_csv_sequential_matches_jax(corpus, tmp_path):
    text = _config_text()
    args = (str(corpus / "train.csv"), str(corpus / "noise.csv"), str(corpus))
    n_want = jpre.preprocess_csv_sequential(jax_config(text), *args, str(tmp_path / "jax"),
                                            num_workers=1, save_specs=True, seed=4)
    n_got = tpre.preprocess_csv_sequential(load_config_from_str(text), *args,
                                           str(tmp_path / "port"), num_workers=1,
                                           save_specs=True, seed=4, device="cpu")
    assert n_got == n_want >= 4
    _assert_same_dirs(tmp_path / "port", tmp_path / "jax", load_config_from_str(text))


def test_spawned_pool_writes_what_one_process_writes(corpus, tmp_path):
    """Two spawned workers and `limit`: the same files as one process."""
    config = load_config_from_str(_config_text())
    csv, root = str(corpus / "train.csv"), str(corpus)
    a = tpre.preprocess_csv(config, csv, root, str(tmp_path / "one"), num_workers=1, limit=3)
    b = tpre.preprocess_csv(config, csv, root, str(tmp_path / "two"), num_workers=2, limit=3)
    assert a == b == 3
    _assert_same_dirs(tmp_path / "two", tmp_path / "one", config)


@pytest.mark.parametrize("text", [
    "clean,embedding,interference\na.wav,b.wav,c.wav\n\nd.wav,e.wav,f.wav\n",
    "a.wav,b.wav,c.wav\nd.wav,e.wav,f.wav\n",
    "File,Path,Noise\n a.wav ,b.wav,c.wav\n",
    '"a,1.wav",b.wav,c.wav,extra\n',
])
def test_read_triplet_csv_matches_jax(tmp_path, text):
    """Header detection, blank lines, spaces and quoting as pandas reads
    them in the JAX package."""
    path = tmp_path / "rows.csv"
    path.write_text(text)
    assert tpre.read_triplet_csv(str(path)) == jpre.read_triplet_csv(str(path))


def test_librispeech_resolution_matches_jax():
    rows = [("1234-5678-0001", "1234-5678-0002", "42-7-0003")]
    assert tpre.resolve_librispeech("1234-5678-0001", "/data") == \
        "/data/1234/5678/1234-5678-0001-norm.wav"
    for libri in (False, True):
        assert tpre.resolve_triplets(rows, "/data", libri) == \
            jpre.resolve_triplets(rows, "/data", libri)


def test_noise_csv_needs_two_files(corpus, tmp_path):
    one = tmp_path / "one.csv"
    one.write_text("noise0.wav\n")
    with pytest.raises(ValueError, match="at least 2"):
        tpre.preprocess_csv_sequential(load_config_from_str(_config_text()),
                                       str(corpus / "train.csv"), str(one), str(corpus),
                                       str(tmp_path / "out"), num_workers=1)


def test_cli_on_the_cpu_never_loads_jax(corpus, tmp_path):
    """A fresh interpreter runs the CLI with ``--save_specs --device cpu``
    over both splits; JAX never loads."""
    config_path = tmp_path / "c.json"
    config_path.write_text(_config_text())
    out = tmp_path / "out"
    code = textwrap.dedent(
        f"""
        import sys
        from voicesplit_tpu_torch.cli.preprocess import main
        written = main(["-c", {str(config_path)!r}, "-r", {str(corpus)!r},
                        "-d", {str(corpus / "train.csv")!r}, "-t", {str(corpus / "train.csv")!r},
                        "-o", {str(out)!r}, "--save_specs", "--num_workers", "2",
                        "--device", "cpu"])
        assert written == {{"train": 3, "test": 3}}, written
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "flax", "voicesplit_tpu")]
        assert not bad, bad
        print("NO_JAX_OK")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                          text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    for split in ("train", "test"):
        assert len(glob.glob(str(out / split / "*-mixed.npy"))) == 3
        assert len(glob.glob(str(out / split / "*-ref_emb.wav"))) == 3


def test_cli_without_a_card_raises_unless_the_cpu_is_named(corpus, tmp_path):
    from voicesplit_tpu_torch.cli.preprocess import main

    config_path = tmp_path / "c.json"
    config_path.write_text(_config_text())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["-c", str(config_path), "-r", str(corpus), "-d", str(corpus / "train.csv"),
                  "-o", str(tmp_path / "out")])
        assert not (tmp_path / "out").exists()
