"""Triplet datasets and the checkpointable batch iterator (counterpart of
`voicesplit_tpu/data/dataset.py`).

Mirrors the capability of reference `utils/dataset.py` (glob discovery of
``*-emb / *-target / *-mixed`` triplets, three loader factories) with the
JAX package's changes:

- **Waveforms, not spectrograms, cross the host→device boundary.**  The
  reference recomputes STFTs in 14 CPU DataLoader workers
  (`utils/dataset.py:33-41`); here the train step takes the STFT on the
  card, so a batch item is just ``(emb [256], target_wav [L], mixed_wav
  [L])`` and the hot path has no host DSP.
- **Fixed shapes**: every item is cropped/padded to ``audio_len`` seconds
  (the reference's fixed 3 s crop makes this exact).
- **Deterministic, checkpointable iteration**: `BatchIterator.state` /
  `load_state` capture (epoch, position, seed) so training resumes
  mid-epoch after preemption.  The shuffle of an epoch is
  ``numpy.random.default_rng((seed, epoch)).permutation(n)``, as in the JAX
  package: the same directory gives the same batches in the same order.
- **Sharding**: ``shard_id`` / ``num_shards`` give each process its slice.

Reads ``.npy`` embeddings and the reference's torch ``.pt`` files; failed
GE2E extractions saved as the scalar-``[0]`` sentinel are dropped at
discovery (reference filters them at collate, `utils/dataset.py:94,127`).
The native C++ loader with the same schedule is `data/native_loader.py`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from fnmatch import fnmatch
from glob import glob
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from voicesplit_tpu_torch.config import Config, DatasetFormat
from voicesplit_tpu_torch.dsp.audio_io import load_wav
from voicesplit_tpu_torch.dsp.processor import AudioProcessor


def _load_array(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".pt"):
        t = torch.load(path, map_location="cpu", weights_only=True)
        return np.asarray(t.detach().numpy() if hasattr(t, "detach") else t)
    raise ValueError(f"unsupported array file {path!r}")


@dataclass
class SampleFiles:
    emb: str
    target_wav: str
    mixed_wav: str
    key: str = ""  # shared prefix, for error messages / ordering


def discover_samples(data_dir: str, fmt: DatasetFormat, drop_sentinels: bool = True) -> List[SampleFiles]:
    """Glob triplets by the config's formats (reference `utils/dataset.py:20-27`).

    Accepts ``.npy`` or ``.pt`` embedding files regardless of the
    configured extension.  Asserts pairwise consistency like the
    reference's integrity checks.
    """

    def find(pattern: str) -> List[str]:
        hits = sorted(glob(os.path.join(data_dir, pattern)))
        if not hits and pattern.endswith(".pt"):
            hits = sorted(glob(os.path.join(data_dir, pattern[:-3] + ".npy")))
        elif not hits and pattern.endswith(".npy"):
            hits = sorted(glob(os.path.join(data_dir, pattern[:-4] + ".pt")))
        return hits

    def key_of(path: str, pattern: str) -> str:
        """Shared prefix: basename minus the pattern's non-* suffix
        (extension-insensitive — .pt embeddings may resolve as .npy)."""
        base = os.path.basename(path)
        suffix_root = os.path.splitext(pattern.split("*", 1)[1])[0]
        cut = base.rfind(suffix_root)
        return base[:cut] if cut > 0 else os.path.splitext(base)[0]

    by_key = {}
    for role, pattern in (("emb", fmt.emb), ("target", fmt.target_wav),
                          ("mixed", fmt.mixed_wav)):
        by_key[role] = {key_of(p, pattern): p for p in find(pattern)}
    keys = {r: set(d) for r, d in by_key.items()}
    if not (keys["emb"] == keys["target"] == keys["mixed"]):
        missing = (keys["emb"] ^ keys["target"]) | (keys["emb"] ^ keys["mixed"])
        raise ValueError(
            f"inconsistent dataset in {data_dir}: triplet keys disagree "
            f"(e.g. {sorted(missing)[:5]}) — "
            f"{len(keys['emb'])} embs / {len(keys['target'])} targets / "
            f"{len(keys['mixed'])} mixed"
        )
    samples = []
    for k in sorted(keys["emb"]):
        e, t, m = by_key["emb"][k], by_key["target"][k], by_key["mixed"][k]
        if drop_sentinels:
            arr = _load_array(e)
            if arr.size <= 1:  # failed-embedding sentinel tensor([0])
                continue
        samples.append(SampleFiles(e, t, m, key=os.path.basename(m)))
    return samples


class SeparationDataset:
    """Fixed-shape triplet dataset over discovered files."""

    def __init__(
        self,
        samples: List[SampleFiles],
        ap: AudioProcessor,
        audio_len: float,
        emb_dim: int = 256,
    ):
        self.samples = samples
        self.ap = ap
        self.n_samples = int(ap.sample_rate * audio_len)
        self.n_frames = ap.frames_for(self.n_samples)
        self.emb_dim = emb_dim

    def __len__(self) -> int:
        return len(self.samples)

    def _fixed(self, wav: np.ndarray) -> Tuple[np.ndarray, int]:
        """Crop/pad to the static length; returns (wav, true_length)."""
        L = self.n_samples
        true = min(len(wav), L)
        if len(wav) >= L:
            return wav[:L], true
        out = np.zeros(L, np.float32)
        out[: len(wav)] = wav
        return out, true

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        s = self.samples[i]
        emb = _load_array(s.emb).astype(np.float32).reshape(-1)
        if emb.shape[0] != self.emb_dim:
            raise ValueError(f"{s.emb}: embedding dim {emb.shape[0]} != {self.emb_dim}")
        target, _ = self._fixed(load_wav(s.target_wav, self.ap.sample_rate))
        mixed, true_len = self._fixed(load_wav(s.mixed_wav, self.ap.sample_rate))
        # per-frame validity for loss masking (frames fully inside true_len)
        seq_len = min(self.n_frames, 1 + true_len // self.ap.hop_length)
        return {
            "emb": emb,
            "target_wav": target.astype(np.float32),
            "mixed_wav": mixed.astype(np.float32),
            "wav_len": np.int32(true_len),
            "seq_len": np.int32(seq_len),
        }


@dataclass
class IteratorState:
    """Resumable position of a `BatchIterator` (stored in checkpoints)."""

    epoch: int = 0
    position: int = 0  # batches consumed within the epoch
    seed: int = 0

    def to_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "position": self.position, "seed": self.seed}

    @classmethod
    def from_dict(cls, d) -> "IteratorState":
        return cls(int(d["epoch"]), int(d["position"]), int(d["seed"]))


class BatchIterator:
    """Deterministic shuffled batch iterator with explicit state.

    Yields dict batches of stacked numpy arrays.  The shuffle permutation
    is a pure function of ``(seed, epoch)``, so `state`/`load_state`
    resume exactly, on any host.
    """

    def __init__(
        self,
        dataset: SeparationDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        shard_id: int = 0,
        num_shards: int = 1,
        pad_last: bool = False,
    ):
        # batch_size is the per-process batch; the global batch is
        # batch_size * num_shards
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._state = IteratorState(seed=seed)

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> IteratorState:
        return IteratorState(**self._state.to_dict())

    def load_state(self, state: IteratorState) -> None:
        self._state = IteratorState(**state.to_dict())

    # -- iteration ------------------------------------------------------
    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self._state.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        # every shard must see the SAME item count: a longer shard would
        # run extra train steps whose collectives the others never join
        per_shard = n // self.num_shards
        return order[self.shard_id :: self.num_shards][:per_shard]

    def batches_per_epoch(self) -> int:
        n = len(self._epoch_order(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        st = self._state
        order = self._epoch_order(st.epoch)
        nb = self.batches_per_epoch()
        if nb == 0:
            raise ValueError("dataset smaller than one batch")
        if st.position >= nb:
            st.epoch += 1
            st.position = 0
            order = self._epoch_order(st.epoch)
        idx = order[st.position * self.batch_size : (st.position + 1) * self.batch_size]
        st.position += 1
        items = [self.dataset[int(i)] for i in idx]
        n_valid = len(items)
        if self.pad_last and n_valid < self.batch_size:
            # Repeat the last item to keep shapes static; `n_valid` lets
            # consumers trim/weight.
            items = items + [items[-1]] * (self.batch_size - n_valid)
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        if self.pad_last:
            batch["n_valid"] = np.int32(n_valid)
        return batch


# ---------------------------------------------------------------------------
# Loader factories (reference `utils/dataset.py:60-78`)
# ---------------------------------------------------------------------------


def _make(config: Config, ap: AudioProcessor, data_dir: str, batch_size: int,
          shuffle: bool, seed: int, shard_id: int, num_shards: int,
          drop_last: bool = True, pad_last: bool = False) -> BatchIterator:
    samples = discover_samples(data_dir, config.dataset.format)
    ds = SeparationDataset(samples, ap, config.audio.audio_len, config.model.emb_dim)
    return BatchIterator(
        ds, batch_size, shuffle=shuffle, seed=seed,
        shard_id=shard_id, num_shards=num_shards,
        drop_last=drop_last, pad_last=pad_last,
    )


def train_dataloader(config: Config, ap: AudioProcessor, shard_id: int = 0, num_shards: int = 1) -> BatchIterator:
    return _make(
        config, ap, config.dataset.train_dir, config.train_config.batch_size,
        shuffle=True, seed=config.train_config.seed,
        shard_id=shard_id, num_shards=num_shards,
    )


def eval_dataloader(config: Config, ap: AudioProcessor) -> BatchIterator:
    return _make(
        config, ap, config.dataset.test_dir, 1,
        shuffle=False, seed=0, shard_id=0, num_shards=1,
        drop_last=False, pad_last=True,
    )


def test_dataloader(config: Config, ap: AudioProcessor) -> BatchIterator:
    """Eval loaders never drop tail items (the reference evaluates the
    whole test set at bs=1); the final partial batch is padded to keep
    shapes static and carries ``n_valid`` for trimming."""
    return _make(
        config, ap, config.dataset.test_dir, config.test_config.batch_size,
        shuffle=False, seed=0, shard_id=0, num_shards=1,
        drop_last=False, pad_last=True,
    )
