"""On-the-fly overlap-mixing training pipeline (a numpy copy of the JAX
package's `voicesplit_tpu/data/online.py`: the same seeds give the same
batches, bit for bit).

The reference mixes offline into ``.pt`` dumps (`preprocess_by_csv.py`)
— every epoch sees the same mixtures.  This iterator performs the same
`mix_overlap` operation at batch-assembly time instead: every epoch
draws fresh speaker pairs and crops, which is both a data-augmentation
win and removes the disk blow-up of pre-mixed corpora.

Deterministic and resumable like `BatchIterator`: the RNG for item ``k``
of epoch ``e`` is seeded by ``(seed, e, k)``, so `state`/`load_state`
reproduce the exact stream on any host; host sharding partitions the
per-epoch item index space.  An LRU wav cache keeps repeated utterance
loads cheap.
"""

from __future__ import annotations

import os
from collections import OrderedDict
from glob import glob
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from voicesplit_tpu_torch.data.dataset import IteratorState, _load_array
from voicesplit_tpu_torch.data.mixer import mix_overlap
from voicesplit_tpu_torch.dsp.audio_io import load_wav, trim_silence
from voicesplit_tpu_torch.models.speaker_encoder import spectral_dvector


def discover_utterances(
    root: str,
    min_bytes: int = 1000,
    min_duration: Optional[float] = None,
    sample_rate: int = 16000,
    trim_top_db: float = 20.0,
) -> Dict[str, List[str]]:
    """Speaker → wav paths for two common layouts:

    - LibriSpeech: ``root/<spk>/<chapter>/*.wav``
    - speaker-per-dir (VCTK-ish): ``root/<spk>/*.wav``

    ``min_duration`` (seconds, opt-in) additionally loads each wav and
    keeps only utterances at least that long AFTER silence trimming —
    the same trim the mixer applies (`mix_overlap`, reference
    `generic_utils.py:308-321`), so every surviving utterance is
    guaranteed mixable and the iterator's retry loop can't exhaust on a
    short-clip-heavy corpus (the VCTK CSV generator makes the same <3 s
    rejection offline, reference `scripts/generate_VCTK_dev_csv.py`).
    """
    speakers: Dict[str, List[str]] = {}
    for spk in sorted(os.listdir(root)):
        spk_dir = os.path.join(root, spk)
        if not os.path.isdir(spk_dir):
            continue
        wavs = sorted(glob(os.path.join(spk_dir, "*.wav"))) + sorted(
            glob(os.path.join(spk_dir, "*", "*.wav"))
        )
        wavs = [w for w in wavs if os.path.getsize(w) >= min_bytes]
        if min_duration is not None:

            def long_enough(path: str) -> bool:
                wav = load_wav(path, sample_rate)
                trimmed, _ = trim_silence(wav, top_db=trim_top_db)
                return trimmed.shape[0] >= int(min_duration * sample_rate)

            wavs = [w for w in wavs if long_enough(w)]
        if len(wavs) >= 2:  # need clean + emb reference from the same speaker
            speakers[spk] = wavs
    return speakers


class _WavCache:
    def __init__(self, capacity: int, sample_rate: int):
        self.capacity = capacity
        self.sample_rate = sample_rate
        self._store: OrderedDict[Tuple[str, float], np.ndarray] = OrderedDict()

    def get(self, path: str, speed: float = 1.0) -> np.ndarray:
        """Wav at `sample_rate`, optionally speed-perturbed by `speed`
        (polyphase resample; >1 = faster/shorter).  Cached per (path,
        speed) so a 3-point perturb set costs 3 cache slots per wav."""
        key = (path, speed)
        if key in self._store:
            self._store.move_to_end(key)
            return self._store[key]
        if speed == 1.0:
            wav = load_wav(path, self.sample_rate)
        else:
            from fractions import Fraction

            from scipy.signal import resample_poly

            frac = Fraction(speed).limit_denominator(20)
            wav = resample_poly(
                self.get(path), frac.denominator, frac.numerator
            ).astype(np.float32)
        self._store[key] = wav
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
        return wav


class OnlineMixIterator:
    """Fresh 2-speaker mixtures every epoch, batched and fixed-shape.

    `embeddings` maps speaker id → d-vector (array or ``.npy``/``.pt``
    path).  Speakers without an embedding fall back per ``emb_mode``:
    ``"pseudo"`` — a deterministic unit-norm per-speaker random vector
    (identity token; smoke mode, cannot generalize to unseen speakers);
    ``"spectral"`` — a training-free signal-derived d-vector of the
    reference utterance (`models/speaker_encoder.py::spectral_dvector`),
    which supports open-set (unseen-speaker) conditioning.
    """

    def __init__(
        self,
        speakers: Dict[str, List[str]],
        batch_size: int,
        sample_rate: int = 16000,
        audio_len: float = 3.0,
        hop_length: int = 160,
        emb_dim: int = 256,
        embeddings: Optional[Dict[str, "np.ndarray | str"]] = None,
        emb_mode: str = "pseudo",
        items_per_epoch: Optional[int] = None,
        seed: int = 42,
        shard_id: int = 0,
        num_shards: int = 1,
        cache_size: int = 512,
        max_retries: int = 10,
        augment: bool = False,
        crop_jitter: Optional[bool] = None,
        snr_jitter_db: Optional[float] = None,
        gain_jitter_db: Optional[float] = None,
        speed_perturb: Optional[Sequence[float]] = None,
        allow_short: bool = False,
        emb_noise: float = 0.0,
    ):
        if len(speakers) < 2:
            raise ValueError("need at least 2 speakers to mix")
        self.speaker_ids = sorted(speakers)
        self.speakers = speakers
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.audio_len = audio_len
        self.hop_length = hop_length
        self.emb_dim = emb_dim
        if emb_mode not in ("pseudo", "spectral"):
            raise ValueError(f"emb_mode must be 'pseudo' or 'spectral', got {emb_mode!r}")
        self.emb_mode = emb_mode
        self.n_samples = int(sample_rate * audio_len)
        self.n_frames = 1 + (self.n_samples + 2 * 600 - 1200) // hop_length  # info only
        self.embeddings = embeddings or {}
        self.items_per_epoch = items_per_epoch or sum(len(v) for v in speakers.values())
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.max_retries = max_retries
        # augmentation (open-set quality lever, docs/RESULTS.md): the
        # `augment` master switch turns on the standard set; individual
        # kwargs override.  All draws flow through the per-item rng so
        # the stream stays deterministic + resumable.
        self.crop_jitter = augment if crop_jitter is None else crop_jitter
        self.snr_jitter_db = (5.0 if augment else 0.0) if snr_jitter_db is None else snr_jitter_db
        self.gain_jitter_db = (6.0 if augment else 0.0) if gain_jitter_db is None else gain_jitter_db
        if speed_perturb is None:
            speed_perturb = (0.9, 1.0, 1.1) if augment else (1.0,)
        self.speed_perturb = tuple(speed_perturb)
        self.allow_short = allow_short
        # Conditioning robustness (train-time only — leave 0 for eval):
        # Gaussian noise of this std is added to each item's d-vector
        # (then renormalized), so the mask net learns to degrade
        # gracefully on imperfect d-vectors instead of keying on exact
        # enrollment values — the open-set failure mode measured with the
        # JAX package (held-out encoder EER 0.233, docs/RESULTS.md).
        self.emb_noise = float(emb_noise)
        self._cache = _WavCache(cache_size, sample_rate)
        self._emb_cache: Dict[str, np.ndarray] = {}
        self._state = IteratorState(seed=seed)

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> IteratorState:
        return IteratorState(**self._state.to_dict())

    def load_state(self, state: IteratorState) -> None:
        self._state = IteratorState(**state.to_dict())

    def batches_per_epoch(self) -> int:
        return (self.items_per_epoch // self.num_shards) // self.batch_size

    # -- embedding lookup ----------------------------------------------
    def _embedding(self, spk: str) -> np.ndarray:
        if spk in self._emb_cache:
            return self._emb_cache[spk]
        src = self.embeddings.get(spk)
        if src is None:
            # Stable hash: Python's str hash() is salted per interpreter,
            # which would break the "same embedding on any host / after
            # resume" determinism contract of this iterator.
            import hashlib

            seed = int.from_bytes(
                hashlib.sha256(f"pseudo-emb:{spk}".encode()).digest()[:4], "little"
            )
            v = np.random.default_rng(seed).standard_normal(self.emb_dim)
            emb = (v / np.linalg.norm(v)).astype(np.float32)
        elif isinstance(src, np.ndarray):
            emb = src.astype(np.float32).reshape(-1)
        else:
            emb = _load_array(src).astype(np.float32).reshape(-1)
        self._emb_cache[spk] = emb
        return emb

    def _spectral_embedding(self, path: str) -> np.ndarray:
        """Signal-derived d-vector of one reference utterance (cached).

        Computed from the UTTERANCE (not the speaker id), so unseen
        speakers get meaningful conditioning — the VoiceFilter protocol
        of embedding a separate reference clip of the target speaker.
        """
        if path in self._emb_cache:
            return self._emb_cache[path]
        emb = spectral_dvector(
            self._cache.get(path), self.sample_rate, emb_dim=self.emb_dim
        )
        self._emb_cache[path] = emb
        return emb

    # -- mixing ---------------------------------------------------------
    @staticmethod
    def _draw_clean_and_emb(
        utts: Sequence[str], rng: np.random.Generator
    ) -> Tuple[str, str]:
        """Separation source and enrollment reference for one speaker.

        Files are grouped by base recording (``x.wav`` and ``x-norm.wav``
        are the SAME speech); when a speaker has ≥2 distinct recordings,
        clean and emb come from different ones — conditioning on a copy
        of the very utterance being separated is an eval leak and, in
        training, lets the net cheat by matching content instead of
        voice.  Single-recording speakers keep the old behavior."""
        groups: Dict[str, List[str]] = {}
        for u in utts:
            b = os.path.basename(u)
            b = b[: -len(".wav")] if b.endswith(".wav") else b
            key = b[: -len("-norm")] if b.endswith("-norm") else b
            groups.setdefault(key, []).append(u)
        keys = sorted(groups)
        if len(keys) >= 2:
            gc, ge = (keys[int(i)] for i in rng.choice(len(keys), 2, replace=False))
            clean = groups[gc][int(rng.integers(0, len(groups[gc])))]
            emb = groups[ge][int(rng.integers(0, len(groups[ge])))]
            return clean, emb
        return tuple(
            utts[int(i)] for i in rng.choice(len(utts), 2, replace=len(utts) < 2)
        )

    def _make_item(self, epoch: int, index: int) -> Dict[str, np.ndarray]:
        base = np.random.default_rng((self._state.seed, epoch, index))
        for attempt in range(self.max_retries):
            rng = np.random.default_rng(base.integers(0, 2**63))
            tgt, intf = rng.choice(len(self.speaker_ids), size=2, replace=False)
            tgt_spk = self.speaker_ids[int(tgt)]
            intf_spk = self.speaker_ids[int(intf)]
            # "<spk>~p090"-style speed-perturbed pseudo-speakers share a
            # base voice with "<spk>": mixing a speaker against their own
            # perturbed copy is a near-unseparable target — redraw
            if tgt_spk.split("~")[0] == intf_spk.split("~")[0]:
                continue
            tgt_utts = self.speakers[tgt_spk]
            clean_path, emb_path = self._draw_clean_and_emb(tgt_utts, rng)
            intf_utts = self.speakers[intf_spk]
            intf_path = intf_utts[int(rng.integers(0, len(intf_utts)))]
            sp = self.speed_perturb
            clean_speed = float(sp[int(rng.integers(0, len(sp)))])
            intf_speed = float(sp[int(rng.integers(0, len(sp)))])
            sample = mix_overlap(
                self._cache.get(emb_path),
                self._cache.get(clean_path, clean_speed),
                self._cache.get(intf_path, intf_speed),
                self.sample_rate,
                self.audio_len,
                rng=rng,
                crop_jitter=self.crop_jitter,
                snr_jitter_db=self.snr_jitter_db,
                gain_jitter_db=self.gain_jitter_db,
                allow_short=self.allow_short,
            )
            if sample is None:
                continue  # utterance too short — redraw deterministically
            self.last_pair = (tgt_spk, intf_spk)  # debug/test visibility
            L = self.n_samples
            if self.emb_mode == "spectral" and tgt_spk not in self.embeddings:
                emb = self._spectral_embedding(emb_path)
            else:
                emb = self._embedding(tgt_spk)
            if self.emb_noise > 0.0:
                # rides the per-item rng: deterministic + resumable
                emb = emb + self.emb_noise * rng.standard_normal(
                    emb.shape
                ).astype(np.float32)
                emb = emb / (np.linalg.norm(emb) + 1e-8)
            return {
                "emb": emb,
                "target_wav": sample.target_wav[:L].astype(np.float32),
                "mixed_wav": sample.mixed_wav[:L].astype(np.float32),
                "wav_len": np.int32(L),
                "seq_len": np.int32(1 + L // self.hop_length),
            }
        raise RuntimeError(
            f"could not build a mixture after {self.max_retries} draws "
            f"(utterances shorter than {self.audio_len}s?)"
        )

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        st = self._state
        nb = self.batches_per_epoch()
        if nb == 0:
            raise ValueError("items_per_epoch smaller than one batch per shard")
        if st.position >= nb:
            st.epoch += 1
            st.position = 0
        start = (st.position * self.num_shards + self.shard_id) * self.batch_size
        items = [
            self._make_item(st.epoch, start + i) for i in range(self.batch_size)
        ]
        st.position += 1
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
