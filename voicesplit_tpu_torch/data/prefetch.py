"""Device prefetch: overlap host batch assembly and the host→device copy
with compute (counterpart of `voicesplit_tpu/data/prefetch.py`).

The train step consumes batches that lie on the card; without prefetch the
card idles while the host reads and stacks the next batch.
`DevicePrefetcher` wraps any batch iterator with a background thread that
stays `depth` batches ahead and calls `place` on each batch off the
critical path.  `place` defaults to `to_device`: pinned host memory and a
``non_blocking`` copy to the CUDA card (a plain tensor conversion for the
CPU).

Checkpoint/resume correctness: the wrapped iterator's `state` is
snapshotted right after each batch is drawn (i.e. it points at the NEXT
undrawn batch) and travels with that batch; `state` returns the snapshot of
the most recently CONSUMED batch, so saving it and later `load_state`-ing
the inner iterator replays the stream exactly from the first unconsumed
batch — prefetched-but-unconsumed batches are not lost.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch


def to_device(batch: Dict[str, np.ndarray], device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays as tensors on `device`; for a CUDA device
    through pinned host memory with ``non_blocking`` copies, which the
    card's stream orders before the kernels that read them."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t
    return out


class DevicePrefetcher:
    """Iterator adapter: background thread assembling + placing batches.

    `place` maps a host batch to what the consumer gets, e.g.
    ``lambda b: to_device(b, torch.device("cuda"))``.
    """

    def __init__(
        self,
        it: Iterator[Dict[str, np.ndarray]],
        place: Callable[[Dict[str, np.ndarray]], Any],
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._it = it
        self._place = place
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._consumed_state = getattr(it, "state", None)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        try:
            while not self._stop.is_set():
                try:
                    batch = next(self._it)
                except StopIteration:
                    self._q.put(("stop", None, None))
                    return
                # post-draw snapshot: restoring it replays the stream from
                # the batch AFTER this one — i.e. resume-after-consume
                state = getattr(self._it, "state", None)
                placed = self._place(batch)
                # block while the queue is full — bounded readahead
                while not self._stop.is_set():
                    try:
                        self._q.put(("batch", placed, state), timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface producer crashes to the consumer
            self._q.put(("error", e, None))

    def __iter__(self):
        return self

    def __next__(self):
        kind, payload, state = self._q.get()
        if kind == "stop":
            raise StopIteration
        if kind == "error":
            raise payload
        self._consumed_state = state
        return payload

    @property
    def state(self):
        """Inner-iterator state as of the last CONSUMED batch (for
        checkpointing; see module docstring)."""
        return self._consumed_state

    def close(self):
        self._stop.set()
        # drain so a blocked producer can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
