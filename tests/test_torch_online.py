"""The port's online mixing (`voicesplit_tpu_torch/data/online.py`) and
spectral d-vectors against the JAX package's: the same corpus and seeds give
the same batches bit for bit; the mel filterbank and `spectral_dvector`
agree to 1e-6.
"""

import numpy as np
import pytest

from voicesplit_tpu.data import online as jonline
from voicesplit_tpu.dsp.mel import mel_filterbank as jax_mel_filterbank
from voicesplit_tpu.models.speaker_encoder import spectral_dvector as jax_spectral_dvector
from voicesplit_tpu_torch.data import online as tonline
from voicesplit_tpu_torch.data.synthetic import _speaker_wav
from voicesplit_tpu_torch.dsp.audio_io import save_wav_float
from voicesplit_tpu_torch.dsp.mel import mel_filterbank
from voicesplit_tpu_torch.models.speaker_encoder import spectral_dvector

SR = 16000
AUDIO_LEN = 1.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Speaker-per-directory corpus: 4 speakers × 3 utterances of 2 s (one
    with a chapter subdirectory, as LibriSpeech), plus a speed-perturbed
    pseudo-speaker of speaker 0 and a speaker with one utterance."""
    root = tmp_path_factory.mktemp("speakers")
    rng = np.random.default_rng(0)
    for s in range(4):
        d = root / f"spk{s}" / ("ch1" if s == 3 else "")
        d.mkdir(parents=True)
        for k in range(3):
            save_wav_float(_speaker_wav(rng, s, 2 * SR, SR), str(d / f"utt{k}.wav"), SR)
    (root / "spk0~p090").mkdir()
    for k in range(2):
        save_wav_float(_speaker_wav(rng, 0, 2 * SR, SR), str(root / "spk0~p090" / f"u{k}.wav"), SR)
    (root / "lonely").mkdir()
    save_wav_float(_speaker_wav(rng, 7, 2 * SR, SR), str(root / "lonely" / "u.wav"), SR)
    (root / "stray.wav").write_bytes(b"")  # not a directory: ignored
    return str(root)


def _pair(corpus, **kwargs):
    kw = dict(batch_size=2, audio_len=AUDIO_LEN, emb_dim=32, seed=5, **kwargs)
    return (jonline.OnlineMixIterator(jonline.discover_utterances(corpus), **kw),
            tonline.OnlineMixIterator(tonline.discover_utterances(corpus), **kw))


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("min_duration", [None, 1.5, 5.0])
def test_discover_utterances_matches_jax(corpus, min_duration):
    want = jonline.discover_utterances(corpus, min_duration=min_duration)
    assert tonline.discover_utterances(corpus, min_duration=min_duration) == want


CASES = {
    "pseudo": {},
    "spectral": {"emb_mode": "spectral"},
    "augment": {"augment": True},
    "speed_perturb": {"speed_perturb": (0.9, 1.1)},
    "emb_noise": {"emb_noise": 0.1, "emb_mode": "spectral"},
    "allow_short": {"allow_short": True, "crop_jitter": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_match_jax_across_epochs(corpus, case):
    """Every batch of two epochs, bit for bit, and the same iterator state."""
    jit, tit = _pair(corpus, **CASES[case])
    assert tit.batches_per_epoch() == jit.batches_per_epoch() > 0
    for _ in range(2 * tit.batches_per_epoch() + 1):
        _same(next(tit), next(jit))
        assert tit.state.to_dict() == jit.state.to_dict()
    assert tit.state.epoch == 2


def test_resume_matches_jax(corpus):
    """A port iterator loaded with the state of a JAX one mid-epoch continues
    with the JAX one's batches."""
    jit, tit = _pair(corpus, emb_mode="spectral")
    for _ in range(3):
        next(jit)
    tit.load_state(tonline.IteratorState(**jit.state.to_dict()))
    for _ in range(4):
        _same(next(tit), next(jit))


@pytest.mark.parametrize("shard_id", [0, 1])
def test_sharding_matches_jax(corpus, shard_id):
    jit, tit = _pair(corpus, shard_id=shard_id, num_shards=2)
    assert tit.batches_per_epoch() == jit.batches_per_epoch()
    for _ in range(tit.batches_per_epoch()):
        _same(next(tit), next(jit))


def test_embeddings_by_speaker_match_jax(corpus, tmp_path):
    """Precomputed ``<speaker>.npy`` d-vectors for some speakers, the rest by
    `emb_mode`."""
    path = tmp_path / "spk1.npy"
    np.save(path, np.random.default_rng(1).standard_normal(32).astype(np.float32))
    emb = {"spk1": str(path), "spk2": np.random.default_rng(2).standard_normal(32)}
    jit, tit = _pair(corpus, embeddings=emb, emb_mode="spectral")
    for _ in range(tit.batches_per_epoch()):
        _same(next(tit), next(jit))


def test_too_few_speakers_and_bad_mode_raise(corpus):
    with pytest.raises(ValueError, match="2 speakers"):
        tonline.OnlineMixIterator({"a": ["x.wav", "y.wav"]}, 2)
    with pytest.raises(ValueError, match="emb_mode"):
        tonline.OnlineMixIterator(tonline.discover_utterances(corpus), 2, emb_mode="ge2e")


@pytest.mark.parametrize("args", [(16000, 512, 40), (16000, 400, 40), (22050, 1024, 80),
                                  (16000, 1200, 40, 50.0, 7000.0, True, None)])
def test_mel_filterbank_matches_jax(args):
    np.testing.assert_allclose(mel_filterbank(*args), jax_mel_filterbank(*args), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("seconds,emb_dim", [(0.02, 256), (1.0, 256), (2.5, 64)])
def test_spectral_dvector_matches_jax(seconds, emb_dim):
    wav = _speaker_wav(np.random.default_rng(3), 4, int(seconds * SR), SR)
    got = spectral_dvector(wav, SR, emb_dim=emb_dim)
    want = jax_spectral_dvector(wav, SR, emb_dim=emb_dim)
    assert got.dtype == np.float32 and got.shape == (emb_dim,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert abs(float(np.linalg.norm(got)) - 1.0) < 1e-5
