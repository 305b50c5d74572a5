"""Checkpointing: the port's own ``torch.save`` files with step + config +
data-iterator state, and a reader for the JAX package's msgpack files
(counterpart of `voicesplit_tpu/train/checkpoint.py`).

The reference saves ``{'model', 'optimizer', 'step', 'config_str'}`` every
`checkpoint_interval` steps (`train.py:125-132`) and supports partial
warm-start restores that filter by name/shape and honor `reinit_layers`
(`set_init_dict`, `utils/generic_utils.py:647-679`).  Same capabilities
here, plus the data-iterator state so a preempted run resumes mid-epoch
deterministically.

A checkpoint ``checkpoint_<step>.pt`` holds the JAX package's payload keys:
``model`` (the parameters by the port's names), ``batch_stats`` (the
BatchNorm running statistics), ``optimizer`` (the optimizer's
``state_dict``), ``step``, ``config_str`` and ``data_state``; every tensor
on the CPU.  It is written to a temporary name and renamed, so a reader
never sees a torn file.

`load_jax_checkpoint` reads a ``checkpoint_<step>.msgpack`` written by the
JAX package into trees of numpy arrays, which
`weights.state_dict_from_jax` and `weights.optimizer_state_from_jax` carry
into the port; `read_msgpack` reads any such file (the speaker encoder's
``encoder_<step>.msgpack`` too).  It decodes flax's msgpack extension types
itself and needs the ``msgpack`` package, nothing of JAX or flax.

`config_from_checkpoint` and `load_model_variables` take either format,
chosen by the file's suffix: a port ``checkpoint_<step>.pt`` or a JAX
``checkpoint_<step>.msgpack``; both are held to the model's names and
shapes before anything is loaded, as the JAX package's loader holds its
own files.

`bilstm_to_streaming_sd` and `convert_bilstm_checkpoint_to_streaming` seed
the streaming model (forward-only LSTM, `MaskNet(streaming=True)`) from an
offline BiLSTM checkpoint of either package.
"""

from __future__ import annotations

import os
import re
import threading
from glob import glob
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from voicesplit_tpu_torch.config import Config, load_config_from_str
from voicesplit_tpu_torch.data.dataset import IteratorState
from voicesplit_tpu_torch.train.state import TrainState

CKPT_PATTERN = "checkpoint_%d.pt"
_CKPT_RE = re.compile(r"checkpoint_(\d+)\.pt$")


def is_checkpoint_name(path: str) -> bool:
    """True for a file named like the trainer's checkpoints."""
    return _CKPT_RE.search(os.path.basename(path)) is not None


def _to_cpu(tree):
    """A copy of a tree of dicts, lists and tensors with every tensor on the
    CPU (a copy even for a CPU tensor: the trainer goes on updating the
    original while a writer thread serializes)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def optimizer_state_dict(state: TrainState) -> dict:
    """The optimizer's state dict in the one-process layout: under the gate
    split the moments of every split parameter gathered from its slices (a
    collective over the model group; every rank of it must call this)."""
    if state.shards is None:
        return state.optimizer.state_dict()
    return state.shards.full_optimizer_state_dict(state.optimizer)


def _payload(state: TrainState, config: Config, data_state: Optional[IteratorState],
             optimizer_state: Optional[dict] = None) -> dict:
    state.gather_()
    params = dict(state.model.named_parameters())
    sd = state.model.state_dict()
    if optimizer_state is None:
        optimizer_state = optimizer_state_dict(state)
    return {
        "model": _to_cpu({k: v for k, v in sd.items() if k in params}),
        "batch_stats": _to_cpu({k: v for k, v in sd.items() if k not in params}),
        "optimizer": _to_cpu(optimizer_state),
        "step": int(state.step),
        "config_str": config.to_json(),
        "data_state": (data_state or IteratorState()).to_dict(),
    }


def _write(payload: dict, path: str, keep: Optional[int]) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic — a preempted process never leaves a torn file
    if keep:
        for old in list_checkpoints(os.path.dirname(path))[:-keep]:
            os.remove(old)


def save_checkpoint(
    log_dir: str,
    state: TrainState,
    config: Config,
    data_state: Optional[IteratorState] = None,
    keep: Optional[int] = None,
    optimizer_state: Optional[dict] = None,
) -> str:
    """Write ``checkpoint_<step>.pt``; with `keep`, remove all but the newest
    `keep` checkpoints of `log_dir`.  Under the gate split the file holds
    the full state, as the one-process trainer's at the same step:
    parameters gathered, and the optimizer's moments gathered unless
    `optimizer_state` (`optimizer_state_dict`'s, taken on every rank of the
    model group) is given."""
    os.makedirs(log_dir, exist_ok=True)
    payload = _payload(state, config, data_state, optimizer_state)
    path = os.path.join(log_dir, CKPT_PATTERN % payload["step"])
    _write(payload, path, keep)
    return path


class AsyncCheckpointer:
    """One-in-flight background checkpoint writer.

    The copy of the state to the host runs synchronously in `save` — the
    caller's next train step updates the parameters in place, so the copy
    must exist before control returns — but serialization and the disk
    write (the slow part, which needs no device) run in a daemon worker
    thread.  At most one write is in flight: a new `save` joins the
    previous one first, and `wait()` must be called before process exit
    (the trainer does on fit() return and on the preemption path) so a
    graceful shutdown never drops the final checkpoint.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(
        self,
        log_dir: str,
        state: TrainState,
        config: Config,
        data_state: Optional[IteratorState] = None,
        keep: Optional[int] = None,
        optimizer_state: Optional[dict] = None,
    ) -> str:
        """Start writing ``checkpoint_<step>.pt`` (pruning to the newest
        `keep`, and with `optimizer_state`, as `save_checkpoint`); returns
        its path."""
        self.wait()
        os.makedirs(log_dir, exist_ok=True)
        payload = _payload(state, config, data_state, optimizer_state)
        path = os.path.join(log_dir, CKPT_PATTERN % payload["step"])

        def _run():
            try:
                _write(payload, path, keep)
            except BaseException as e:  # surfaced on the next save/wait
                self._error = e

        self._thread = threading.Thread(target=_run, name="ckpt-writer", daemon=True)
        self._thread.start()
        return path

    def wait(self) -> None:
        """Join the in-flight write; re-raise any writer error loudly."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from e


def list_checkpoints(log_dir: str) -> List[str]:
    """All checkpoints in `log_dir`, sorted by step."""
    with_steps = []
    for h in glob(os.path.join(log_dir, "checkpoint_*.pt")):
        m = _CKPT_RE.search(h)
        if m:
            with_steps.append((int(m.group(1)), h))
    return [h for _, h in sorted(with_steps)]


def latest_checkpoint(log_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(log_dir)
    return ckpts[-1] if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Raw payload dict: model/batch_stats/optimizer/step/config_str/data_state,
    tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def read_model_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], str]:
    """The model's ``state_dict`` (parameters and running statistics) and the
    embedded config string of a checkpoint: the JAX package's
    ``checkpoint_<step>.msgpack`` where `path` ends so (carried by
    `weights.state_dict_from_jax`), else the port's ``checkpoint_<step>.pt``."""
    if path.endswith(".msgpack"):
        from voicesplit_tpu_torch.weights import state_dict_from_jax

        payload = load_jax_checkpoint(path)
        return state_dict_from_jax(payload["params"], payload["batch_stats"]), payload["config_str"]
    payload = load_checkpoint(path)
    return {**payload["model"], **payload["batch_stats"]}, payload["config_str"]


def config_from_checkpoint(path: str) -> Config:
    """Recover the embedded config of either format (reference
    `test.py:87-89`)."""
    return load_config_from_str(read_model_checkpoint(path)[1])


def _shape_mismatches(loaded: Mapping[str, torch.Tensor], model: nn.Module) -> List[str]:
    want = model.state_dict()
    bad = [f"{k}: missing from the checkpoint" for k in want if k not in loaded]
    bad += [f"{k}: not in the model" for k in loaded if k not in want]
    bad += [
        f"{k}: checkpoint {tuple(loaded[k].shape)} vs model {tuple(v.shape)}"
        for k, v in want.items()
        if k in loaded and tuple(loaded[k].shape) != tuple(v.shape)
    ]
    return bad


def check_model_variables(
    config: Config, sd: Dict[str, torch.Tensor], checkpoint_path: str, streaming: bool = False
) -> Dict[str, torch.Tensor]:
    """`sd`, once its names and shapes are those of the config's model (the
    streaming one with `streaming`); a ``ValueError`` naming every misfit
    otherwise."""
    from voicesplit_tpu_torch.models.masknet import make_masknet

    bad = _shape_mismatches(sd, make_masknet(config, streaming=streaming, device="meta"))
    if bad:
        raise ValueError(
            f"checkpoint {checkpoint_path!r} does not fit the "
            f"{'streaming ' if streaming else ''}model: " + "; ".join(bad))
    return sd


def load_model_variables(
    config: Config, checkpoint_path: str, streaming: bool = False
) -> Dict[str, torch.Tensor]:
    """Inference-ready ``state_dict`` (parameters and running statistics) of
    the config's model (the streaming one with `streaming`) from a port or
    JAX checkpoint (`read_model_checkpoint`); raises where the checkpoint
    does not fit the model (a BiLSTM checkpoint given with `streaming`,
    say), before anything is loaded."""
    sd = read_model_checkpoint(checkpoint_path)[0]
    return check_model_variables(config, sd, checkpoint_path, streaming)


def restore_train_state(
    payload: Dict[str, Any],
    state: TrainState,
    partial: bool = False,
    reinit_layers: Optional[List[str]] = None,
) -> Tuple[TrainState, IteratorState]:
    """Load a payload into `state` (its model and optimizer, in place) and
    return it with the data-iterator state.

    A full restore checks every name and shape first and raises a
    ``ValueError`` before it changes anything.  ``partial=True`` applies the
    reference's warm-start semantics: keep the fresh init and copy over
    only parameters that exist with matching shapes, skipping any whose
    name matches `reinit_layers` (reference `set_init_dict`,
    `utils/generic_utils.py:647-679`); running statistics, optimizer state
    and step stay fresh in that case.

    Under the gate split (``state.shards``) the payload is the full state, as
    any checkpoint is: the parameters go to the module and are sliced to the
    owned shards, and so is the optimizer's state.
    """
    state.gather_()  # a partial restore keeps the rest of the current parameters
    if partial:
        partial_restore(state.model, payload["model"], reinit_layers)
        if state.shards is not None:
            state.shards.load_from_model_()
        return state, IteratorState()
    sd = {**payload["model"], **payload["batch_stats"]}
    bad = _shape_mismatches(sd, state.model)
    if bad:
        raise ValueError("checkpoint does not fit the model: " + "; ".join(bad))
    state.model.load_state_dict(sd)
    if state.shards is None:
        state.optimizer.load_state_dict(payload["optimizer"])
    else:
        state.shards.load_from_model_()
        state.shards.load_full_optimizer_state_dict(state.optimizer, payload["optimizer"])
    state.step = int(payload["step"])
    data_state = IteratorState.from_dict(payload.get("data_state", IteratorState().to_dict()))
    return state, data_state


def bilstm_to_streaming_sd(
    model_sd: Mapping[str, torch.Tensor], lstm_dim: int
) -> Dict[str, torch.Tensor]:
    """A BiLSTM model's ``state_dict`` → the streaming (forward-only LSTM)
    model's, as `voicesplit_tpu/train/checkpoint.py::bilstm_to_streaming_sd`:

    - ``lstm.fwd_*`` copied, ``lstm.bwd_*`` dropped;
    - ``fc1``: the BiLSTM head computes ``h_f @ W_f + h_b @ W_b``; collapsing
      it to ``h_f @ (W_f + W_b)`` is exact where ``h_b ≈ h_f`` and keeps the
      head's input scale.  ``fc1.weight`` is ``[fc1, 2H]`` here (JAX's
      kernel rows are these columns);
    - everything else (convs, BatchNorm, fc2) copied.
    """
    H = lstm_dim
    w = torch.as_tensor(model_sd["fc1.weight"])
    if w.shape[1] != 2 * H:
        raise ValueError(
            f"fc1 input features {w.shape[1]} != 2*lstm_dim {2 * H}: not a BiLSTM checkpoint")
    out = {k: v for k, v in model_sd.items()
           if not k.startswith("lstm.bwd_") and k != "fc1.weight"}
    out["fc1.weight"] = w[:, :H] + w[:, H:]
    return out


def convert_bilstm_checkpoint_to_streaming(
    ckpt_path: str, out_dir: str, causal: Optional[bool] = None, device=None,
) -> str:
    """An offline BiLSTM checkpoint (the port's ``.pt`` or the JAX package's
    ``.msgpack``) → a streaming-model ``checkpoint_0.pt`` in `out_dir`, for
    causal fine-tuning (`Trainer` on its config) or serving.

    `causal` sets ``config.model.causal`` in the written config (default
    True: the zero-lookahead geometry).  The step is 0 and the optimizer
    state fresh: a warm start, not a resume.  The model is built on
    `device` (the CUDA card unless the CPU is named).  Returns the path."""
    from voicesplit_tpu_torch.models.masknet import make_masknet
    from voicesplit_tpu_torch.train.state import create_train_state, make_optimizer

    sd, config_str = read_model_checkpoint(ckpt_path)
    config = load_config_from_str(config_str)
    config.model.causal = True if causal is None else causal
    model = make_masknet(config, streaming=True, device=device)
    sd = bilstm_to_streaming_sd(sd, config.model.lstm_dim)
    bad = _shape_mismatches(sd, model)
    if bad:
        raise ValueError(f"checkpoint {ckpt_path!r} does not fit the streaming model: "
                         + "; ".join(bad))
    model.load_state_dict(sd)
    state = create_train_state(model, make_optimizer(config, model))
    return save_checkpoint(out_dir, state, config)


def partial_restore(
    model: nn.Module,
    loaded: Mapping[str, torch.Tensor],
    reinit_layers: Optional[List[str]] = None,
) -> List[str]:
    """Name+shape-filtered merge of `loaded` parameters into `model`, in
    place; returns the names it took.  A name matches `reinit_layers` when
    it contains one of the patterns (the port's names, e.g. ``fc2`` or
    ``conv8.conv``)."""
    reinit_layers = reinit_layers or []
    taken = []
    with torch.no_grad():
        for k, p in model.named_parameters():
            take = (
                k in loaded
                and tuple(loaded[k].shape) == tuple(p.shape)
                and not any(pat in k for pat in reinit_layers)
            )
            if take:
                p.copy_(torch.as_tensor(loaded[k]).to(p.device, p.dtype))
                taken.append(k)
    return taken


# ---------------------------------------------------------------------------
# The JAX package's msgpack checkpoints
# ---------------------------------------------------------------------------

# flax.serialization's msgpack extension type ids
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _ndarray_from_bytes(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode() if isinstance(dtype_name, bytes) else dtype_name
    if name == "bfloat16":  # numpy has no bfloat16: widen to float32
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """flax splits arrays above 2^30 bytes into chunks; join them again."""
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(path: str) -> Dict[str, Any]:
    """The tree of a msgpack file written by ``flax.serialization``: nested
    dicts with numpy arrays (bfloat16 widened to float32), chunked arrays
    joined again."""
    try:
        import msgpack
    except ImportError as e:
        raise ImportError(
            "reading a JAX checkpoint needs the 'msgpack' package, which is not installed"
        ) from e

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(msgpack, data)[()]
        if code == _EXT_COMPLEX:
            re_, im = msgpack.unpackb(data)
            return complex(re_, im)
        return msgpack.ExtType(code, data)

    with open(path, "rb") as f:
        return _unchunk(msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False))


def load_jax_checkpoint(path: str) -> Dict[str, Any]:
    """Read a ``checkpoint_<step>.msgpack`` of the JAX package.

    Returns ``params`` and ``batch_stats`` (nested dicts of numpy arrays in
    the JAX layout, for `weights.state_dict_from_jax`), ``opt_state`` (the
    optax state as nested dicts, for `weights.optimizer_state_from_jax`),
    ``step``, ``config_str`` and ``data_state`` (an `IteratorState`).
    """
    payload = read_msgpack(path)
    return {
        "params": payload["model"],
        "batch_stats": payload["batch_stats"],
        "opt_state": payload["optimizer"],
        "step": int(payload["step"]),
        "config_str": payload["config_str"],
        "data_state": IteratorState.from_dict(
            payload.get("data_state", IteratorState().to_dict())
        ),
    }
