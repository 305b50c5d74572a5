"""Builds and loads the port's CUDA kernels (`csrc/*.cu`).

Every source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), the objects are linked into one
shared library in ``build/`` at the repository root, and the library is
loaded with ``ctypes`` at first use.  The sources expose a plain C
interface: every pointer and the stream is a ``void*``, every launch
returns its ``cudaError_t`` and the Python wrapper raises on anything but 0.
The kernel modules (`lstm_cuda`, `conv_fused`, `conv_cuda`) declare the argument types of
their own functions on the library this module returns, and share the
dispatch rule below: the kernel for a CUDA tensor, the plain version for a
CPU one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH, "-shared")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def build() -> Tuple[Path, str]:
    """Compile the kernels if any source changed; returns ``(library, log)``.

    Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all
    started together, and the objects are linked into one library named
    by a hash of all sources, the headers they share (``csrc/*.cuh``) and
    the flags.  The log holds ``ptxas -v``
    (registers, shared memory, spills) of a fresh build and is empty when
    an up-to-date library was found.
    """
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted([*srcs, *CSRC.glob("*.cuh")]):  # a changed header is a new library
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"libvoicesplit-{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(srcs, objs)
    ]
    logs = []
    for src, proc in zip(srcs, procs):
        out, _ = proc.communicate()
        logs.append(f"[{src.name}]\n{out}")
        if proc.returncode != 0:
            for p in procs:
                p.wait()
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)], capture_output=True, text=True
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: a process building at the same time never loads half a file
    return lib, "".join(logs) + link.stdout + link.stderr


def library() -> ctypes.CDLL:
    """The loaded library (built first if need be)."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def declare(signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Set ``argtypes`` of the named functions (all return an ``int``
    ``cudaError_t``) and return the library."""
    lib = library()
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel failed: CUDA error {err} ({msg})")


def dispatch(device: torch.device, kernel, plain):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if device.type == "cuda":
        return kernel
    if device.type == "cpu":
        return plain
    raise ValueError(f"unsupported device {device}")


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of `t`'s device, as the kernels take it."""
    return torch.cuda.current_stream(t.device).cuda_stream
