"""Forward LSTM recurrence kernels (CUDA, `csrc/lstm_fwd.cu`) and their
plain PyTorch versions.

``lstm_fwd`` replaces `voicesplit_tpu/ops/lstm_pallas.py::_fwd_kernel` (one
direction from a given ``(h0, c0)``) and ``bilstm_fwd`` replaces
``_fwd2_kernel`` (both directions in one pass, zero initial state).  Both
take time-major inputs and return ``(hs, cs, gates)`` in float32, like the
Pallas kernels; the source's header says how the kernel is laid out and
what bounds it.

Dispatch: a CUDA tensor goes to the kernel, or the call raises; the plain
versions (``lstm_fwd_ref``, ``bilstm_fwd_ref``) run only for tensors on the
CPU.  Each wrapper adds one to ``LAUNCHES[name]`` per kernel launch.

The kernels are compiled by ``nvcc`` for ``sm_90a`` into ``build/`` at the
repository root on first use, from the source in the checkout, and loaded
with ``ctypes``.  The backward kernels come with the training slice: until
then the autograd backward raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "lstm_fwd.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel launches per wrapper, for showing that a run went through them
LAUNCHES = {"lstm_fwd": 0, "bilstm_fwd": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the LSTM kernels cannot be built")


def build() -> Tuple[Path, str]:
    """Compile the kernels if the source changed; returns ``(library, log)``.

    The log holds ``ptxas -v`` (registers, shared memory, spills) of a fresh
    build and is empty when an up-to-date library was found.
    """
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"liblstm_fwd-{digest[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a process building at the same time never loads half a file
    return lib, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.lstm_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
        lib.lstm_fwd.restype = i
        lib.bilstm_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.bilstm_fwd.restype = i
        lib.lstm_launch_config.argtypes = [
            i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(ctypes.c_longlong),
        ]
        lib.lstm_launch_config.restype = i
        lib.lstm_error_string.argtypes = [i]
        lib.lstm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _library().lstm_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} ({msg})")


def launch_config(directions: int, batch: int, hidden: int, dtype: torch.dtype) -> dict:
    """Grid the kernel uses on the current card: blocks, hidden units per
    block and dynamic shared memory bytes."""
    blocks, units, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    err = _library().lstm_launch_config(
        directions, batch, hidden, int(dtype == torch.bfloat16),
        ctypes.byref(blocks), ctypes.byref(units), ctypes.byref(smem),
    )
    _raise_on(err, "lstm_launch_config")
    return {"blocks": blocks.value, "units": units.value, "smem_bytes": smem.value}


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' oracle)
# ---------------------------------------------------------------------------


def _cell(pre: torch.Tensor, c: torch.Tensor, H: int):
    i = torch.sigmoid(pre[:, 0 * H : 1 * H])
    f = torch.sigmoid(pre[:, 1 * H : 2 * H])
    g = torch.tanh(pre[:, 2 * H : 3 * H])
    o = torch.sigmoid(pre[:, 3 * H : 4 * H])
    c = f * c + i * g
    h = o * torch.tanh(c)
    return h, c, torch.cat([i, f, g, o], dim=-1)


def lstm_fwd_ref(xp, whh, h0, c0):
    """One direction: ``xp [T, B, 4H]``, ``whh [H, 4H]`` (bf16 or fp32),
    ``h0, c0 [B, H]`` → ``hs, cs [T, B, H]``, ``gates [T, B, 4H]`` fp32.
    h is rounded to the operand dtype before each product, which runs in
    fp32."""
    H = whh.shape[0]
    w = whh.float()
    h, c = h0.float(), c0.float()
    hs, cs, gates = [], [], []
    for t in range(xp.shape[0]):
        pre = xp[t].float() + h.to(whh.dtype).float() @ w
        h, c, g = _cell(pre, c, H)
        hs.append(h), cs.append(c), gates.append(g)
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def bilstm_fwd_ref(xp, whh_f, whh_b):
    """Both directions, zero initial state: ``xp [T, 2B, 4H]`` with rows
    ``[B, 2B)`` already time-reversed → ``hs, cs [T, 2B, H]``, ``gates``."""
    H = whh_f.shape[0]
    B = xp.shape[1] // 2
    wf, wb = whh_f.float(), whh_b.float()
    h = torch.zeros(2 * B, H, dtype=torch.float32, device=xp.device)
    c = torch.zeros_like(h)
    hs, cs, gates = [], [], []
    for t in range(xp.shape[0]):
        hm = h.to(whh_f.dtype).float()
        pre = xp[t].float() + torch.cat([hm[:B] @ wf, hm[B:] @ wb], dim=0)
        h, c, g = _cell(pre, c, H)
        hs.append(h), cs.append(c), gates.append(g)
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------


def _check(xp: torch.Tensor, rows: int, weights, states) -> Tuple[int, int]:
    if xp.dim() != 3 or xp.shape[2] % 4 or xp.shape[1] != rows:
        raise ValueError(f"xp must be [T, {rows}, 4H], got {tuple(xp.shape)}")
    if xp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"operands must be bf16 or fp32, got {xp.dtype}")
    T, H = xp.shape[0], xp.shape[2] // 4
    if T == 0 or rows == 0:
        raise ValueError("empty sequence or batch")
    for w in weights:
        if w.dtype != xp.dtype or tuple(w.shape) != (H, 4 * H):
            raise ValueError(f"W_hh must be [{H}, {4 * H}] {xp.dtype}, got {tuple(w.shape)} {w.dtype}")
    for s in states:
        if s.dtype != torch.float32 or tuple(s.shape) != (rows, H):
            raise ValueError(f"h0/c0 must be [{rows}, {H}] fp32, got {tuple(s.shape)} {s.dtype}")
    for a in (xp, *weights, *states):
        if a.device != xp.device:
            raise ValueError("all operands must be on one device")
        if not a.is_contiguous():
            raise ValueError("operands must be contiguous")
    return T, H


def _outputs(xp: torch.Tensor, H: int):
    T, R = xp.shape[:2]
    kw = dict(dtype=torch.float32, device=xp.device)
    return torch.empty(T, R, H, **kw), torch.empty(T, R, H, **kw), torch.empty(T, R, 4 * H, **kw)


def _launch_lstm_fwd(xp, whh, h0, c0):
    T, H = xp.shape[0], whh.shape[0]
    hs, cs, gates = _outputs(xp, H)
    lib = _library()
    with torch.cuda.device(xp.device):
        err = lib.lstm_fwd(
            xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            T, xp.shape[1], H, int(xp.dtype == torch.bfloat16),
            torch.cuda.current_stream(xp.device).cuda_stream,
        )
    _raise_on(err, "lstm_fwd")
    LAUNCHES["lstm_fwd"] += 1
    return hs, cs, gates


def _launch_bilstm_fwd(xp, whh_f, whh_b):
    T, H = xp.shape[0], whh_f.shape[0]
    hs, cs, gates = _outputs(xp, H)
    lib = _library()
    with torch.cuda.device(xp.device):
        err = lib.bilstm_fwd(
            xp.data_ptr(), whh_f.data_ptr(), whh_b.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            T, xp.shape[1] // 2, H, int(xp.dtype == torch.bfloat16),
            torch.cuda.current_stream(xp.device).cuda_stream,
        )
    _raise_on(err, "bilstm_fwd")
    LAUNCHES["bilstm_fwd"] += 1
    return hs, cs, gates


class _LSTMFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, whh, h0, c0):
        _check(xp, h0.shape[0], (whh,), (h0, c0))
        if xp.device.type == "cuda":
            return _launch_lstm_fwd(xp, whh, h0, c0)
        if xp.device.type != "cpu":
            raise ValueError(f"unsupported device {xp.device}")
        return lstm_fwd_ref(xp, whh, h0, c0)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("training slice")


class _BiLSTMFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, whh_f, whh_b):
        if xp.dim() != 3 or xp.shape[1] % 2:
            raise ValueError(f"xp must be [T, 2B, 4H], got {tuple(xp.shape)}")
        _check(xp, xp.shape[1], (whh_f, whh_b), ())
        if xp.device.type == "cuda":
            return _launch_bilstm_fwd(xp, whh_f, whh_b)
        if xp.device.type != "cpu":
            raise ValueError(f"unsupported device {xp.device}")
        return bilstm_fwd_ref(xp, whh_f, whh_b)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("training slice")


def lstm_fwd(xp, whh, h0, c0):
    """One-direction recurrence (kernel on CUDA, plain version on the CPU);
    see `lstm_fwd_ref` for shapes and dtypes."""
    return _LSTMFwd.apply(xp, whh, h0, c0)


def bilstm_fwd(xp, whh_f, whh_b):
    """Two-direction recurrence (kernel on CUDA, plain version on the CPU);
    see `bilstm_fwd_ref` for shapes and dtypes."""
    return _BiLSTMFwd.apply(xp, whh_f, whh_b)
