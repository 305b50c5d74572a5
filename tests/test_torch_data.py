"""The port's data pipeline (`voicesplit_tpu_torch/data/`) against the JAX
package's (`voicesplit_tpu/data/`): the synthetic dataset writer, the
mixers, triplet discovery, the checkpointable batch iterator and the device
prefetcher.  Everything here is host-side numpy; the comparisons are exact.
"""

import json
import os
import pathlib

import numpy as np
import pytest
import torch

from voicesplit_tpu.config import load_config_from_str as jax_config
from voicesplit_tpu.data import dataset as jds
from voicesplit_tpu.data import mixer as jmixer
from voicesplit_tpu.data.synthetic import build_synthetic_dataset as jax_build
from voicesplit_tpu.dsp.processor import make_audio_processor as jax_audio_processor
from voicesplit_tpu_torch.config import load_config_from_str
from voicesplit_tpu_torch.data import dataset as tds
from voicesplit_tpu_torch.data import mixer as tmixer
from voicesplit_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from voicesplit_tpu_torch.data.synthetic import build_synthetic_dataset, speaker_embedding
from voicesplit_tpu_torch.dsp.processor import make_audio_processor

REPO = pathlib.Path(__file__).resolve().parents[1]
AUDIO_LEN, EMB = 0.25, 16
N_ITEMS = 7


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Several test processes share one machine: two PyTorch threads for this
    file's tests instead of one per core, which the processes would fight
    over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config_text(train_dir="", test_dir=""):
    d = json.loads((REPO / "configs" / "voicesplit.json").read_text())
    d["audio"]["voicefilter"].update(n_fft=128, hop_length=32, win_length=64, num_freq=65)
    d["audio"]["audio_len"] = AUDIO_LEN
    d["model"].update(emb_dim=EMB)
    d["train_config"].update(batch_size=2, seed=5)
    d["test_config"] = {"batch_size": 3}
    d["dataset"].update(train_dir=str(train_dir), test_dir=str(test_dir))
    return json.dumps(d)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """One synthetic dataset that both packages read."""
    root = tmp_path_factory.mktemp("triplets")
    fmt = load_config_from_str(_config_text()).dataset.format
    made = build_synthetic_dataset(str(root), N_ITEMS, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=fmt, seed=3)
    assert len(made) == N_ITEMS
    return root


def _datasets(data_dir):
    text = _config_text(data_dir, data_dir)
    jc, tc = jax_config(text), load_config_from_str(text)
    jap, tap = jax_audio_processor(jc), make_audio_processor(tc, device="cpu")
    jset = jds.SeparationDataset(jds.discover_samples(str(data_dir), jc.dataset.format), jap, AUDIO_LEN, EMB)
    tset = tds.SeparationDataset(tds.discover_samples(str(data_dir), tc.dataset.format), tap, AUDIO_LEN, EMB)
    return (jc, jap, jset), (tc, tap, tset)


def _assert_same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


def test_same_seed_writes_the_same_synthetic_files(tmp_path):
    fmt_t = load_config_from_str(_config_text()).dataset.format
    fmt_j = jax_config(_config_text()).dataset.format
    a = build_synthetic_dataset(str(tmp_path / "port"), 4, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=fmt_t, seed=9)
    b = jax_build(str(tmp_path / "jax"), 4, audio_len=AUDIO_LEN, emb_dim=EMB, fmt=fmt_j, seed=9)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 16
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    v = speaker_embedding(3, EMB)
    assert v.shape == (EMB,) and abs(float(np.linalg.norm(v)) - 1.0) < 1e-6


def test_mix_overlap_matches_jax():
    rng = np.random.default_rng(0)
    sr = 16000
    waves = [(0.3 * rng.standard_normal(sr)).astype(np.float32) for _ in range(3)]
    kwargs = dict(crop_jitter=True, snr_jitter_db=3.0, gain_jitter_db=6.0, allow_short=True)
    for kw in ({}, kwargs):
        got = tmixer.mix_overlap(*waves, sr, 0.5, rng=np.random.default_rng(1), **kw)
        want = jmixer.mix_overlap(*waves, sr, 0.5, rng=np.random.default_rng(1), **kw)
        for field in ("emb_wav", "target_wav", "mixed_wav"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert tmixer.mix_overlap(*waves, sr, 2.0) is None  # too short: discarded


def test_mix_sequential_matches_jax():
    rng = np.random.default_rng(2)
    sr = 16000
    t = np.arange(5 * sr) / sr
    voices = [(0.3 * np.sin(2 * np.pi * f * t) * (1 + 0.3 * rng.standard_normal(t.size))).astype(np.float32)
              for f in (140.0, 220.0, 180.0)]
    noises = [(0.05 * rng.standard_normal(10 * sr)).astype(np.float32) for _ in range(2)]
    got = tmixer.mix_sequential(*voices, *noises, sr, np.random.default_rng(4))
    want = jmixer.mix_sequential(*voices, *noises, sr, np.random.default_rng(4))
    assert [s.variant for s in got] == [s.variant for s in want] and len(got) == 4
    for g, w in zip(got, want):
        for field in ("emb_wav", "target_wav", "mixed_wav"):
            np.testing.assert_array_equal(getattr(g, field), getattr(w, field))


def test_discovery_and_items_match_jax(data_dir):
    (_, _, jset), (_, _, tset) = _datasets(data_dir)
    assert len(tset) == len(jset) == N_ITEMS
    assert [s.key for s in tset.samples] == [s.key for s in jset.samples]
    assert tset.n_samples == jset.n_samples and tset.n_frames == jset.n_frames
    for i in (0, N_ITEMS - 1):
        _assert_same_batch(tset[i], jset[i])


def test_discovery_rejects_an_inconsistent_directory_and_drops_sentinels(data_dir, tmp_path):
    import shutil

    broken = tmp_path / "broken"
    shutil.copytree(data_dir, broken)
    fmt = load_config_from_str(_config_text()).dataset.format
    np.save(broken / "000001-emb.npy", np.zeros(1, np.float32))  # failed-embedding sentinel
    assert len(tds.discover_samples(str(broken), fmt)) == N_ITEMS - 1
    assert len(tds.discover_samples(str(broken), fmt, drop_sentinels=False)) == N_ITEMS
    os.remove(broken / "000002-mixed.wav")
    with pytest.raises(ValueError, match="inconsistent dataset"):
        tds.discover_samples(str(broken), fmt)


ITERATORS = {
    "shuffled": dict(batch_size=2, shuffle=True, seed=11),
    "shard-1-of-2": dict(batch_size=1, shuffle=True, seed=11, shard_id=1, num_shards=2),
    "padded-last": dict(batch_size=3, shuffle=False, drop_last=False, pad_last=True),
    "kept-last": dict(batch_size=4, shuffle=True, seed=2, drop_last=False),
}


@pytest.mark.parametrize("name", sorted(ITERATORS))
def test_batches_come_in_the_jax_order_over_two_epochs(name, data_dir):
    (_, _, jset), (_, _, tset) = _datasets(data_dir)
    jit, tit = jds.BatchIterator(jset, **ITERATORS[name]), tds.BatchIterator(tset, **ITERATORS[name])
    assert tit.batches_per_epoch() == jit.batches_per_epoch() > 0
    for _ in range(2 * tit.batches_per_epoch() + 1):
        _assert_same_batch(next(tit), next(jit))
        assert tit.state.to_dict() == jit.state.to_dict()
    assert tit.state.epoch == 2


def test_padded_last_batch_reports_its_valid_items(data_dir):
    _, (_, _, tset) = _datasets(data_dir)
    it = tds.BatchIterator(tset, **ITERATORS["padded-last"])
    batches = [next(it) for _ in range(it.batches_per_epoch())]
    assert [int(b["n_valid"]) for b in batches] == [3, 3, 1]
    last = batches[-1]
    assert last["mixed_wav"].shape[0] == 3
    np.testing.assert_array_equal(last["mixed_wav"][1], last["mixed_wav"][0])


def test_load_state_resumes_mid_epoch(data_dir):
    _, (_, _, tset) = _datasets(data_dir)
    first = tds.BatchIterator(tset, **ITERATORS["shuffled"])
    seen = [next(first) for _ in range(2)]
    saved = first.state
    rest = [next(first) for _ in range(4)]  # crosses into the next epoch
    resumed = tds.BatchIterator(tset, batch_size=2, shuffle=True, seed=999)
    resumed.load_state(tds.IteratorState.from_dict(saved.to_dict()))
    for want in rest:
        _assert_same_batch(next(resumed), want)
    assert not np.array_equal(seen[0]["mixed_wav"], rest[0]["mixed_wav"])
    with pytest.raises(ValueError, match="smaller than one batch"):
        next(tds.BatchIterator(tset, batch_size=N_ITEMS + 1))


@pytest.mark.parametrize("factory", ["train_dataloader", "eval_dataloader", "test_dataloader"])
def test_loader_factories_match_jax(factory, data_dir):
    (jc, jap, _), (tc, tap, _) = _datasets(data_dir)
    jit, tit = getattr(jds, factory)(jc, jap), getattr(tds, factory)(tc, tap)
    assert tit.batch_size == jit.batch_size and tit.batches_per_epoch() == jit.batches_per_epoch()
    for _ in range(tit.batches_per_epoch()):
        _assert_same_batch(next(tit), next(jit))


def test_make_train_iterator_is_the_python_iterator(data_dir):
    """`prefer_native=False` names the Python iterator (the native one is
    `test_torch_native_loader.py`'s)."""
    from voicesplit_tpu_torch.data.native_loader import make_train_iterator

    _, (_, _, tset) = _datasets(data_dir)
    it = make_train_iterator(tset, 2, prefer_native=False, seed=11, shard_id=0, num_shards=1)
    assert type(it) is tds.BatchIterator
    _assert_same_batch(next(it), next(tds.BatchIterator(tset, **ITERATORS["shuffled"])))


def test_prefetcher_hands_out_the_same_stream_and_the_consumed_state(data_dir):
    """The prefetcher's `state` is that of the last batch handed out, not of
    the readahead: an iterator loaded with it continues with the next batch
    the consumer would have got."""
    _, (_, _, tset) = _datasets(data_dir)
    plain = tds.BatchIterator(tset, **ITERATORS["shuffled"])
    want = [next(plain) for _ in range(5)]
    inner = tds.BatchIterator(tset, **ITERATORS["shuffled"])
    with DevicePrefetcher(inner, place=lambda b: to_device(b, torch.device("cpu")), depth=3) as pf:
        assert pf.state.to_dict() == {"epoch": 0, "position": 0, "seed": 11}
        for i in range(3):
            got = next(pf)
            assert all(torch.is_tensor(v) for v in got.values())
            _assert_same_batch({k: v.numpy() for k, v in got.items()}, want[i])
        saved = pf.state
    assert saved.position == 3  # whatever the readahead drew meanwhile
    resumed = tds.BatchIterator(tset, **ITERATORS["shuffled"])
    resumed.load_state(saved)
    _assert_same_batch(next(resumed), want[3])
    with pytest.raises(ValueError, match="depth"):
        DevicePrefetcher(inner, place=lambda b: b, depth=0)


def test_prefetcher_surfaces_a_failing_iterator():
    class Broken:
        state = None

        def __next__(self):
            raise OSError("disk gone")

    with DevicePrefetcher(Broken(), place=lambda b: b) as pf:
        with pytest.raises(OSError, match="disk gone"):
            next(pf)
