"""ctypes wrapper of the native C++ prefetching loader (counterpart of
`voicesplit_tpu/data/native_loader.py`).

`NativeBatchIterator` has the interface and the schedule of the Python
`BatchIterator`: the shuffle permutation is computed in Python from
``(seed, epoch)`` as `BatchIterator._epoch_order` does and handed to C++,
with the same `state` / `load_state` resume contract; wav decode, ``.npy``
parse and crop/pad run in a C++ thread pool with an in-order bounded ring,
overlapping the next batches with the train step.

The library is built at first use from `voicesplit_tpu_torch/native/loader.cc`
by ``g++ -O3 -std=c++17 -shared -fPIC`` into ``build/`` at the repository
root (beside the CUDA kernels' library), named by a hash of the source and
the flags.  Each build writes a file of its own and renames it into place,
so processes that build at once all succeed.  There is no silent fallback:
`make_train_iterator` returns the native iterator or raises, and
``prefer_native=False`` selects the Python `BatchIterator` by name.

The C loader parses ``.npy`` only; torch ``*-emb.pt`` d-vectors are
converted once to ``.npy`` sidecars under ``build/emb_npy/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import uuid
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from voicesplit_tpu_torch.data.dataset import (
    BatchIterator,
    IteratorState,
    SampleFiles,
    SeparationDataset,
    _load_array,
)

SRC = Path(__file__).resolve().parent.parent / "native" / "loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libvsloader-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the loader unless its library exists; returns its path.

    Raises RuntimeError when no ``g++`` is found or the compile fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the native loader cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a name of this build's own: builds that run at once never share a file
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.{uuid.uuid4().hex}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a process loading it never sees half a file
    return lib


def load_library() -> ctypes.CDLL:
    """The loaded library (built first if need be)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.vsl_create.restype = ctypes.c_void_p
    lib.vsl_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int,
        ctypes.c_int, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.vsl_start.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
    lib.vsl_next.restype = ctypes.c_int
    lib.vsl_next.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_float)] * 3 + [
        ctypes.POINTER(ctypes.c_int32)
    ]
    lib.vsl_destroy.argtypes = [ctypes.c_void_p]
    lib.vsl_error_count.restype = ctypes.c_int64
    lib.vsl_error_count.argtypes = [ctypes.c_void_p]
    lib.vsl_last_error.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    _lib = lib
    return lib


def as_npy_embedding(path: str) -> str:
    """`path` itself for a ``.npy``; for a torch ``.pt`` d-vector, a ``.npy``
    sidecar with its values under ``build/emb_npy/`` (keyed by absolute path
    and modification time), written once."""
    if not path.endswith(".pt"):
        return path
    key = hashlib.sha1(f"{os.path.abspath(path)}:{os.path.getmtime(path)}".encode()).hexdigest()
    cache = BUILD_DIR / "emb_npy" / f"{key}.npy"
    if not cache.exists():
        vec = _load_array(path).astype(np.float32).reshape(-1)
        cache.parent.mkdir(parents=True, exist_ok=True)
        tmp = cache.with_name(f"{key}.{os.getpid()}.{uuid.uuid4().hex}.npy")
        np.save(tmp, vec)
        os.replace(tmp, cache)
    return str(cache)


class NativeBatchIterator:
    """C++-prefetched batches with the `BatchIterator` interface."""

    def __init__(
        self,
        dataset: SeparationDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 42,
        shard_id: int = 0,
        num_shards: int = 1,
        n_threads: int = 8,
        queue_cap: int = 8,
    ):
        if not drop_last:
            raise ValueError("the native loader requires drop_last=True (fixed shapes)")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self._state = IteratorState(seed=seed)
        self._lib = load_library()

        samples: List[SampleFiles] = dataset.samples
        n = len(samples)
        emb_paths = [as_npy_embedding(s.emb) for s in samples]
        self._emb_arr = (ctypes.c_char_p * n)(*[p.encode() for p in emb_paths])
        self._tgt_arr = (ctypes.c_char_p * n)(*[s.target_wav.encode() for s in samples])
        self._mix_arr = (ctypes.c_char_p * n)(*[s.mixed_wav.encode() for s in samples])
        self._handle = self._lib.vsl_create(
            self._emb_arr, self._tgt_arr, self._mix_arr, n,
            batch_size, dataset.emb_dim, dataset.n_samples, n_threads, queue_cap,
            int(dataset.ap.sample_rate),
        )
        self._epoch_running: Optional[int] = None

    # -- state (the contract of BatchIterator) ---------------------------
    @property
    def state(self) -> IteratorState:
        return IteratorState(**self._state.to_dict())

    def load_state(self, state: IteratorState) -> None:
        self._state = IteratorState(**state.to_dict())
        self._epoch_running = None  # restart the prefetch at the new position

    def _epoch_order(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng((self._state.seed, epoch)).permutation(n)
        else:
            order = np.arange(n)
        per_shard = n // self.num_shards  # equal shard lengths, as BatchIterator
        return order[self.shard_id :: self.num_shards][:per_shard]

    def batches_per_epoch(self) -> int:
        return len(self._epoch_order(0)) // self.batch_size

    # -- iteration ------------------------------------------------------
    def _start_epoch(self) -> None:
        st = self._state
        order = self._epoch_order(st.epoch).astype(np.int64)
        nb = self.batches_per_epoch()
        sched = order[st.position * self.batch_size : nb * self.batch_size]
        ptr = sched.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        self._lib.vsl_start(self._handle, ptr, len(sched))  # copies the schedule
        self._epoch_running = st.epoch

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        st = self._state
        nb = self.batches_per_epoch()
        if nb == 0:
            raise ValueError("dataset smaller than one batch")
        if st.position >= nb:
            st.epoch += 1
            st.position = 0
            self._epoch_running = None
        if self._epoch_running != st.epoch:
            self._start_epoch()

        B, E, L = self.batch_size, self.dataset.emb_dim, self.dataset.n_samples
        emb = np.empty((B, E), np.float32)
        tgt = np.empty((B, L), np.float32)
        mix = np.empty((B, L), np.float32)
        wl = np.empty((B,), np.int32)
        ok = self._lib.vsl_next(
            self._handle,
            emb.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            tgt.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            mix.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            wl.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        if not ok:
            raise RuntimeError("the native loader stopped unexpectedly")
        n_err = self._lib.vsl_error_count(self._handle)
        if n_err:
            buf = ctypes.create_string_buffer(1024)
            self._lib.vsl_last_error(self._handle, buf, len(buf))
            raise RuntimeError(
                f"the native loader hit {n_err} data error(s); first: "
                f"{buf.value.decode(errors='replace')}"
            )
        st.position += 1
        hop = self.dataset.ap.hop_length
        seq = np.minimum(self.dataset.n_frames, 1 + wl // hop).astype(np.int32)
        return {"emb": emb, "target_wav": tgt, "mixed_wav": mix, "wav_len": wl, "seq_len": seq}

    def close(self) -> None:
        """Stop the worker threads and free the loader."""
        if getattr(self, "_handle", None):
            self._lib.vsl_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def make_train_iterator(dataset: SeparationDataset, batch_size: int, prefer_native: bool = True,
                        n_threads: int = 8, queue_cap: int = 8, **kwargs):
    """The native iterator over `dataset`; it raises when the library cannot
    be built or loaded.  ``prefer_native=False`` gives the Python
    `BatchIterator` (which takes no `n_threads` / `queue_cap`)."""
    if not prefer_native:
        return BatchIterator(dataset, batch_size, **kwargs)
    return NativeBatchIterator(dataset, batch_size, n_threads=n_threads, queue_cap=queue_cap,
                               **kwargs)
