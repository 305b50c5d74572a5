"""The port's native C++ loader (`voicesplit_tpu_torch/data/native_loader.py`,
`native/loader.cc`): its batches against the port's Python iterator and the
JAX package's Python `BatchIterator` (the JAX package's own tests hold that
one to its native loader), resume, sharding, loud data errors, a race-free
build into ``build/`` and no silent fallback.  The JAX package's native
loader is never called here.
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from voicesplit_tpu.config import Config as JaxConfig
from voicesplit_tpu.data.dataset import BatchIterator as JaxBatchIterator
from voicesplit_tpu.data.dataset import SeparationDataset as JaxDataset
from voicesplit_tpu.data.dataset import discover_samples as jax_discover
from voicesplit_tpu.dsp.processor import AudioProcessor as JaxAudioProcessor
from voicesplit_tpu_torch.config import Config
from voicesplit_tpu_torch.data import native_loader
from voicesplit_tpu_torch.data.dataset import BatchIterator, SeparationDataset, discover_samples
from voicesplit_tpu_torch.data.native_loader import NativeBatchIterator, make_train_iterator
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset
from voicesplit_tpu_torch.dsp.audio_io import save_wav
from voicesplit_tpu_torch.dsp.processor import AudioProcessor

SR = 16000
REPO = Path(__file__).resolve().parents[1]


def _dataset(d: str) -> SeparationDataset:
    c = Config()
    return SeparationDataset(discover_samples(d, c.dataset.format),
                             AudioProcessor(c.audio, device="cpu"), 1.0)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("native"))
    build_synthetic_dataset(d, 10, SR, 1.0, seed=3)
    return d


@pytest.fixture(scope="module")
def ds(data_dir):
    return _dataset(data_dir)


def _copy(ds, tmp_path, name):
    d = str(tmp_path / name)
    shutil.copytree(os.path.dirname(ds.samples[0].target_wav), d)
    return d


def _assert_batches_equal(got, want):
    """The tolerances of the JAX package's native-vs-Python test."""
    np.testing.assert_allclose(got["emb"], want["emb"], atol=1e-6)
    np.testing.assert_allclose(got["mixed_wav"], want["mixed_wav"], atol=2e-7)
    np.testing.assert_allclose(got["target_wav"], want["target_wav"], atol=2e-7)
    np.testing.assert_array_equal(got["wav_len"], want["wav_len"])
    np.testing.assert_array_equal(got["seq_len"], want["seq_len"])


@pytest.mark.parametrize("seed,batch", [(11, 2), (0, 3)])
def test_native_matches_both_python_iterators(ds, data_dir, seed, batch):
    """Across two epoch boundaries: the same batches as the port's Python
    iterator and the JAX package's."""
    jc = JaxConfig()
    jds = JaxDataset(jax_discover(data_dir, jc.dataset.format), JaxAudioProcessor(jc.audio), 1.0)
    nat, py, jpy = (NativeBatchIterator(ds, batch, seed=seed), BatchIterator(ds, batch, seed=seed),
                    JaxBatchIterator(jds, batch, seed=seed))
    assert nat.batches_per_epoch() == py.batches_per_epoch() == jpy.batches_per_epoch()
    for _ in range(2 * nat.batches_per_epoch() + 1):
        got = next(nat)
        _assert_batches_equal(got, next(py))
        _assert_batches_equal(got, next(jpy))
        assert nat.state == py.state
    assert nat.state.epoch == 2
    nat.close()


def test_native_resume_state(ds):
    it = NativeBatchIterator(ds, 2, seed=5)
    next(it)
    next(it)
    saved = it.state
    expected = [next(it)["mixed_wav"], next(it)["mixed_wav"], next(it)["mixed_wav"]]
    it2 = NativeBatchIterator(ds, 2, seed=5)
    it2.load_state(saved)
    for want in expected:  # the third crosses into the next epoch
        np.testing.assert_array_equal(next(it2)["mixed_wav"], want)


def test_native_sharded(ds):
    """Two shards: disjoint items, each the Python iterator's shard."""
    got = []
    for shard in (0, 1):
        nat = NativeBatchIterator(ds, 1, seed=2, shard_id=shard, num_shards=2)
        py = BatchIterator(ds, 1, seed=2, shard_id=shard, num_shards=2)
        wavs = []
        for _ in range(nat.batches_per_epoch()):
            b = next(nat)
            _assert_batches_equal(b, next(py))
            wavs.append(b["mixed_wav"][0])
        got.append(np.stack(wavs))
    assert not any((a == b).all() for a in got[0] for b in got[1])


def test_factory_gives_native_or_python_by_name(ds):
    assert isinstance(make_train_iterator(ds, 2, n_threads=2), NativeBatchIterator)
    py = make_train_iterator(ds, 2, prefer_native=False, n_threads=2, seed=1)
    assert type(py) is BatchIterator
    with pytest.raises(ValueError, match="drop_last"):
        NativeBatchIterator(ds, 2, drop_last=False)


def test_wrong_sample_rate_raises(ds, tmp_path):
    """The loader does not resample: a wav at another rate raises."""
    bad = _dataset(_copy(ds, tmp_path, "bad"))
    save_wav(np.zeros(22050, np.float32), bad.samples[0].mixed_wav, 22050)
    it = NativeBatchIterator(bad, 2, shuffle=False, seed=0)
    with pytest.raises(RuntimeError, match="sample rate"):
        for _ in range(it.batches_per_epoch()):
            next(it)


@pytest.mark.parametrize("content", [b"not an npy file", b""])
def test_corrupt_embedding_raises(ds, tmp_path, content):
    bad = _dataset(_copy(ds, tmp_path, "bademb"))
    Path(bad.samples[0].emb).write_bytes(content)
    it = NativeBatchIterator(bad, 2, shuffle=False, seed=0)
    with pytest.raises(RuntimeError, match="embedding"):
        for _ in range(it.batches_per_epoch()):
            next(it)


def test_pt_embeddings_are_read_through_npy_sidecars(ds, tmp_path):
    """Torch ``*-emb.pt`` d-vectors feed their true values (no zeros)."""
    d = _copy(ds, tmp_path, "ptemb")
    rng = np.random.default_rng(0)
    want = {}
    for s in _dataset(d).samples:
        vec = rng.standard_normal(256).astype(np.float32)
        pt_path = s.emb.rsplit(".", 1)[0] + ".pt"
        torch.save(torch.from_numpy(vec), pt_path)
        os.remove(s.emb)
        want[pt_path] = vec
    pt = _dataset(d)
    assert all(s.emb.endswith(".pt") for s in pt.samples)
    batch = next(NativeBatchIterator(pt, 2, shuffle=False, seed=0))
    for i in range(2):
        np.testing.assert_array_equal(batch["emb"][i], want[pt.samples[i].emb])
    sidecar = native_loader.as_npy_embedding(pt.samples[0].emb)
    assert Path(sidecar).parent == native_loader.BUILD_DIR / "emb_npy"


def test_six_processes_build_into_one_fresh_directory_at_once(tmp_path):
    """Six interpreters build the library into the same empty directory at
    the same time: all succeed, one library, no temporary file left."""
    build_dir = tmp_path / "build"
    code = textwrap.dedent(
        f"""
        from pathlib import Path
        from voicesplit_tpu_torch.data import native_loader as nl
        nl.BUILD_DIR = Path({str(build_dir)!r})
        lib = nl.load_library()
        assert lib.vsl_create is not None
        print(nl.library_path().name)
        """
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=str(REPO), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(6)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [err for _, err in outs]
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert sorted(p.name for p in build_dir.iterdir()) == sorted(names)


def test_missing_compiler_raises_with_no_fallback(ds, tmp_path, monkeypatch):
    """No g++ on the PATH and no library built: the factory raises instead
    of handing out the Python iterator."""
    monkeypatch.setattr(native_loader, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="g.. not found"):
        make_train_iterator(ds, 2)
    assert not (tmp_path / "empty").exists()
