"""LSTM recurrence kernels (CUDA, `csrc/`) and their plain PyTorch versions.

Forward (`csrc/lstm_fwd.cu`): ``lstm_fwd`` replaces
`voicesplit_tpu/ops/lstm_pallas.py::_fwd_kernel` (one direction from a
given ``(h0, c0)``) and ``bilstm_fwd`` replaces ``_fwd2_kernel`` (both
directions in one pass, zero initial state).  Both take time-major inputs
and return ``(hs, cs, gates)`` in float32, like the Pallas kernels.  The
kernel is chosen from the shape before the launch: the cluster walk
(``lstm_fwd_kernel``) wherever it holds the shape (every shape of the
model at H=400), else in bf16 the split walk (``lstm_fwd_split_kernel``:
two clusters a direction and row group, H=800) wherever the card holds all
its clusters at once, else the grid route (``lstm_fwd_grid_kernel``: fp32
at H=800); ``ROUTES`` counts the forward launches by route.  The split walk
takes scratch memory for its exchange between the two clusters, which the
wrapper allocates (``_exchange``) and the kernel's C function zeroes.

Backward (`csrc/lstm_bwd.cu`): ``lstm_bwd`` replaces ``_bwd_kernel`` and
``bilstm_bwd`` replaces ``_bwd2_kernel``: the reverse walk that gives
``dxp`` (in the type of x) and, for one direction, ``dh0, dc0``, then the
dW_hh kernel (``lstm_dwhh``, float32 ``dW_hh`` from the saved ``hs`` and
``dxp``), both launched by one call.  They read ``hs[t-1]`` and ``cs[t-1]``
in place, where the JAX wrappers build shifted copies.  Both walks split a
direction's rows into row groups, one thread-block cluster each, so they
take any batch of which one row fits (`launch_config` reports the groups).
Where not one row fits (H=800), the walk takes in bf16 the split walk
(``lstm_bwd_split_kernel``, two clusters a direction and row group of at most
8 rows, where the card holds all its clusters at once), else the grid
route (``lstm_bwd_grid_kernel``), chosen from the shape before the launch,
as the forward's; ``ROUTES_BWD`` counts the backward launches by route.  Each
source's header says how the kernel is laid out and what bounds it.

Dispatch: a CUDA tensor goes to the kernel, or the call raises; the plain
versions (``*_ref``) run only for tensors on the CPU.  Each kernel launch
adds one to ``LAUNCHES[name]`` (``lstm_bwd`` / ``bilstm_bwd`` count their
call, which launches the walk and the dW_hh kernel; ``lstm_dwhh`` alone,
which only tests and timings call, counts nothing).  ``lstm_fwd`` /
``bilstm_fwd`` are differentiable: their autograd backward runs
``lstm_bwd`` / ``bilstm_bwd`` on the same dispatch rule.

The two forwards are `torch.library` operators, ``voicesplit::lstm_fwd`` and
``voicesplit::bilstm_fwd``, each with a fake implementation that gives the
outputs' shapes and types for any (also symbolic) batch, so that
`torch.export` traces them and a saved program launches them (`export.py`).
The operator's implementation is the dispatch above: checks, the route chosen
from the shape and the counts all happen inside it, never while tracing.
The autograd functions and the plain call reach the kernels only through
the operators.

The kernels are compiled and loaded by `ops/_build.py` (``nvcc`` for
``sm_90a`` into ``build/`` at first use, ``ctypes``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from voicesplit_tpu_torch.ops import _build

# kernel launches per wrapper, for showing that a run went through them
LAUNCHES = {"lstm_fwd": 0, "bilstm_fwd": 0, "lstm_bwd": 0, "bilstm_bwd": 0}
# the forward wrappers' launches by route: "cluster" (`lstm_fwd_kernel`, the
# cluster walk), "split" (`lstm_fwd_split_kernel`, two clusters a direction
# and row group: bf16 shapes one cluster cannot hold) and "grid"
# (`lstm_fwd_grid_kernel`, the shapes neither walk holds)
ROUTES = {"cluster": 0, "split": 0, "grid": 0}
# the backward wrappers' launches by route: "cluster" (`lstm_bwd_kernel`),
# "split" (`lstm_bwd_split_kernel`) and "grid" (`lstm_bwd_grid_kernel`)
ROUTES_BWD = {"cluster": 0, "split": 0, "grid": 0}

_declared = False


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, ROUTES, ROUTES_BWD):
        for k in counts:
            counts[k] = 0


def _library() -> ctypes.CDLL:
    global _declared
    if not _declared:
        p, i, pi = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
        ll, pll = ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong)
        out = [pi, pi, pll, *[pi] * 7]
        _build.declare({
            "lstm_fwd": [p] * 7 + [i] * 4 + [p, ll, p, pi],
            "bilstm_fwd": [p] * 6 + [i] * 4 + [p, ll, p, pi],
            "lstm_fwd_exchange_bytes": [i] * 4 + [pll],
            "lstm_bwd": [p] * 13 + [i] * 4 + [p, ll, p, pi],
            "bilstm_bwd": [p] * 9 + [i] * 4 + [p, ll, p, pi],
            "lstm_bwd_exchange_bytes": [i] * 4 + [pll],
            "lstm_dwhh": [p] * 5 + [i] * 5 + [p],
            "lstm_launch_config": [i, i, i, i, pi, *out],
            "lstm_bwd_launch_config": [i, i, i, i, pi, *out, pi],
        })
        _declared = True
    return _build.library()


_raise_on = _build.raise_on


def launch_config(
    directions: int, batch: int, hidden: int, dtype: torch.dtype, backward: bool
) -> dict:
    """Launch a kernel makes on the current card for `directions`
    directions of `batch` rows each: blocks, hidden units per block, dynamic
    shared memory bytes, cluster size, threads a block, the clusters the
    card holds at once (``cudaOccupancyMaxActiveClusters``; 0: it cannot
    launch), registers and spilled bytes a thread, row groups a direction
    (one cluster each) and rows a cluster, and the route, chosen from the
    shape: "cluster" (the walk), "split" (the split walk: two clusters a
    direction and row group, ``blocks`` all of them, each row group a pair)
    or "grid" (the grid route: ``cluster`` 0,
    and the blocks the card holds at once under ``resident_blocks``; the
    backward's also ``w_shared``, whether W_hh's rows sit in shared memory
    or are read through L2)."""
    route, w_shared, ints = ctypes.c_int(), ctypes.c_int(), [ctypes.c_int() for _ in range(9)]
    smem = ctypes.c_longlong()
    refs = [ctypes.byref(ints[0]), ctypes.byref(ints[1]), ctypes.byref(smem),
            *map(ctypes.byref, ints[2:])]
    lib = _library()
    args = (directions, batch, hidden, int(dtype == torch.bfloat16))
    if backward:
        err = lib.lstm_bwd_launch_config(*args, ctypes.byref(route), *refs, ctypes.byref(w_shared))
    else:
        err = lib.lstm_launch_config(*args, ctypes.byref(route), *refs)
    _raise_on(err, "launch_config")
    keys = ("blocks", "units", "cluster", "threads", "max_active_clusters", "registers",
            "local_bytes", "groups", "rows")
    out = dict(zip(keys, (v.value for v in ints)), smem_bytes=smem.value)
    out["route"] = _ROUTE_NAMES[route.value]
    if out["route"] == "grid":
        out["resident_blocks"] = out.pop("max_active_clusters")
        if backward:
            out["w_shared"] = bool(w_shared.value)
    return out


# the route numbers the C functions report
_ROUTE_NAMES = {0: "grid", 1: "cluster", 2: "split"}


@functools.lru_cache(maxsize=None)
def _exchange_bytes(directions: int, batch: int, hidden: int, bf16: int, backward: bool,
                    device_index: int) -> int:
    n = ctypes.c_longlong()
    name = "lstm_bwd_exchange_bytes" if backward else "lstm_fwd_exchange_bytes"
    err = getattr(_library(), name)(directions, batch, hidden, bf16, ctypes.byref(n))
    _raise_on(err, name)
    return n.value


def _exchange(directions: int, batch: int, hidden: int, dtype: torch.dtype, device,
              backward: bool = False):
    """Scratch memory of the split walk for this launch (None, 0 on the
    other routes), on the current device: the kernel's C function zeroes
    what needs it on the stream before the walk."""
    n = _exchange_bytes(directions, batch, hidden, int(dtype == torch.bfloat16), backward,
                        torch.cuda.current_device())
    if n == 0:
        return None, 0
    return torch.empty(n, dtype=torch.uint8, device=device), n


def _raise_on_walk(err: int, name: str, directions: int, batch: int, hidden: int, dtype) -> None:
    """Raises for a failed backward launch, with the walk's launch shape
    (on the grid route, a grid of more blocks than the card holds at once is
    refused before the launch)."""
    if err != 0:
        cfg = launch_config(directions, batch, hidden, dtype, backward=True)
        _raise_on(err, f"{name} (walk launch {cfg})")


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


def lstm_dwhh_ref(hs, h0, dg, directions, dtype):
    """dW_hh of `directions` directions of B = R / directions rows each:
    ``dW_d = sum_t round(h_prev[t, rows_d])^T @ round(dg[t, rows_d])`` with
    ``h_prev[t] = hs[t-1]`` (``h0`` at t = 0; None is the zero state) and
    round() the cast to `dtype` (W_hh's type), accumulated in fp32 from the
    last step to the first, as the reverse walk of `_bwd_kernel` /
    `_bwd2_kernel` adds it.  ``hs [T, R, H]`` fp32, ``dg [T, R, 4H]`` (the
    dgates, or dxp) → a tuple of ``[H, 4H]`` fp32, one per direction."""
    T, R, H = hs.shape
    B = R // directions
    rows = [slice(d * B, (d + 1) * B) for d in range(directions)]
    dws = [torch.zeros(H, 4 * H, dtype=torch.float32, device=hs.device) for _ in rows]
    for t in range(T - 1, -1, -1):
        if t:
            h_prev = hs[t - 1]
        elif h0 is not None:
            h_prev = h0.float()
        else:
            continue  # the zero state adds nothing
        hr = h_prev.to(dtype).float()
        dgr = dg[t].to(dtype).float()
        for r, dw in zip(rows, dws):
            dw += hr[r].t() @ dgr[r]
    return tuple(dws)


def _bwd_ref(ws, gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype):
    """The reverse walk of `_bwd_kernel` / `_bwd2_kernel` for D = len(ws)
    directions of B = R / D rows each (row block d uses ``ws[d]``), then
    dW_hh from `lstm_dwhh_ref`, as the kernels split it."""
    T, R, G = gates.shape
    H = G // 4
    D = len(ws)
    B = R // D
    op = ws[0].dtype
    wf = [w.float() for w in ws]
    dxp = torch.empty(T, R, G, dtype=x_dtype, device=gates.device)
    dgr_all = torch.empty(T, R, G, dtype=op, device=gates.device)
    dh_carry, dc_carry = dhf.float(), dcf.float()
    rows = [slice(d * B, (d + 1) * B) for d in range(D)]
    for t in range(T - 1, -1, -1):
        i, f, g, o = gates[t].split(H, dim=-1)
        c_prev = cs[t - 1] if t else c0.float()
        tc = torch.tanh(f * c_prev + i * g)
        dh = dhs[t] + dh_carry
        do = dh * tc
        dct = dh * o * (1.0 - tc * tc) + dc_carry
        dc_carry = dct * f
        dgates = torch.cat(
            [dct * g * i * (1.0 - i), dct * c_prev * f * (1.0 - f),
             dct * i * (1.0 - g * g), do * o * (1.0 - o)],
            dim=-1,
        )
        dxp[t] = dgates.to(x_dtype)
        # the product takes dgates rounded to W_hh's type and accumulates in
        # fp32, as the Pallas kernels' matrix products do
        dgr_all[t] = dgates.to(op)
        dgr = dgr_all[t].float()
        dh_carry = torch.cat([dgr[r] @ w.t() for r, w in zip(rows, wf)], dim=0)
    dws = lstm_dwhh_ref(hs, h0, dgr_all, D, op)
    return dxp, dws, dh_carry, dc_carry


def lstm_bwd_ref(whh, gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype):
    """Backward of `lstm_fwd_ref` (`_bwd_kernel`): ``gates [T, B, 4H]``,
    ``cs, hs, dhs [T, B, H]`` fp32 (unshifted: step t reads ``[t-1]``, or
    ``h0, c0`` at t = 0), final-state cotangents ``dhf, dcf [B, H]`` →
    ``dxp [T, B, 4H]`` in `x_dtype`, ``dwhh [H, 4H]`` fp32, ``dh0, dc0``."""
    dxp, (dw,), dh0, dc0 = _bwd_ref((whh,), gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype)
    return dxp, dw, dh0, dc0


def bilstm_bwd_ref(whh_f, whh_b, gates, cs, hs, dhs, x_dtype):
    """Backward of `bilstm_fwd_ref` (`_bwd2_kernel`), zero initial state and
    no final-state cotangent → ``dxp [T, 2B, 4H]`` in `x_dtype`,
    ``dwhh_f, dwhh_b [H, 4H]`` fp32."""
    R, H = hs.shape[1:]
    zeros = torch.zeros(R, H, dtype=torch.float32, device=hs.device)
    dxp, (dwf, dwb), _, _ = _bwd_ref(
        (whh_f, whh_b), gates, cs, hs, zeros, zeros, dhs, zeros, zeros, x_dtype
    )
    return dxp, dwf, dwb


# ---------------------------------------------------------------------------
# Checks and kernel launches
# ---------------------------------------------------------------------------


def _same_device_contiguous(tensors) -> None:
    dev = tensors[0].device
    for a in tensors:
        if a.device != dev:
            raise ValueError("all operands must be on one device")
        if not a.is_contiguous():
            raise ValueError("operands must be contiguous")


def _check_weights(weights, dtype: torch.dtype, H: int) -> None:
    for w in weights:
        if w.dtype != dtype or tuple(w.shape) != (H, 4 * H):
            raise ValueError(f"W_hh must be [{H}, {4 * H}] {dtype}, got {tuple(w.shape)} {w.dtype}")


def _check_fp32(tensors, shape) -> None:
    for s in tensors:
        if s.dtype != torch.float32 or tuple(s.shape) != tuple(shape):
            raise ValueError(f"expected {list(shape)} fp32, got {tuple(s.shape)} {s.dtype}")


def _check(xp: torch.Tensor, rows: int, weights, states) -> Tuple[int, int]:
    if xp.dim() != 3 or xp.shape[2] % 4 or xp.shape[1] != rows:
        raise ValueError(f"xp must be [T, {rows}, 4H], got {tuple(xp.shape)}")
    if xp.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"operands must be bf16 or fp32, got {xp.dtype}")
    T, H = xp.shape[0], xp.shape[2] // 4
    if T == 0 or rows == 0:
        raise ValueError("empty sequence or batch")
    _check_weights(weights, xp.dtype, H)
    _check_fp32(states, (rows, H))
    _same_device_contiguous((xp, *weights, *states))
    return T, H


def _check_bwd(weights, gates, seqs, states, x_dtype) -> None:
    if gates.dim() != 3 or gates.shape[2] % 4 or 0 in gates.shape:
        raise ValueError(f"gates must be [T, R, 4H], got {tuple(gates.shape)}")
    T, R, G = gates.shape
    H = G // 4
    if weights[0].dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"W_hh must be bf16 or fp32, got {weights[0].dtype}")
    if x_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bf16 or fp32, got {x_dtype}")
    _check_weights(weights, weights[0].dtype, H)
    _check_fp32((gates,), (T, R, G))
    _check_fp32(seqs, (T, R, H))
    _check_fp32(states, (R, H))
    _same_device_contiguous((*weights, gates, *seqs, *states))
    if gates.device.type == "cuda" and x_dtype != weights[0].dtype:
        # the kernel reads dgates back from dxp as the rounded product operand
        raise ValueError(f"the kernel needs x in W_hh's type {weights[0].dtype}, got {x_dtype}")


def _outputs(xp: torch.Tensor, H: int):
    T, R = xp.shape[:2]
    kw = dict(dtype=torch.float32, device=xp.device)
    return torch.empty(T, R, H, **kw), torch.empty(T, R, H, **kw), torch.empty(T, R, 4 * H, **kw)


def _count(name: str, route: ctypes.c_int, routes: dict) -> None:
    LAUNCHES[name] += 1
    routes[_ROUTE_NAMES[route.value]] += 1


def _launch_lstm_fwd(xp, whh, h0, c0):
    T, H = xp.shape[0], whh.shape[0]
    hs, cs, gates = _outputs(xp, H)
    lib, route = _library(), ctypes.c_int()
    with torch.cuda.device(xp.device):
        ex, ex_bytes = _exchange(1, xp.shape[1], H, xp.dtype, xp.device)
        err = lib.lstm_fwd(
            xp.data_ptr(), whh.data_ptr(), h0.data_ptr(), c0.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            T, xp.shape[1], H, int(xp.dtype == torch.bfloat16),
            None if ex is None else ex.data_ptr(), ex_bytes, _build.stream(xp), ctypes.byref(route),
        )
    _raise_on(err, "lstm_fwd")
    _count("lstm_fwd", route, ROUTES)
    return hs, cs, gates


def _launch_bilstm_fwd(xp, whh_f, whh_b):
    T, H = xp.shape[0], whh_f.shape[0]
    hs, cs, gates = _outputs(xp, H)
    lib, route = _library(), ctypes.c_int()
    with torch.cuda.device(xp.device):
        ex, ex_bytes = _exchange(2, xp.shape[1] // 2, H, xp.dtype, xp.device)
        err = lib.bilstm_fwd(
            xp.data_ptr(), whh_f.data_ptr(), whh_b.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
            T, xp.shape[1] // 2, H, int(xp.dtype == torch.bfloat16),
            None if ex is None else ex.data_ptr(), ex_bytes, _build.stream(xp), ctypes.byref(route),
        )
    _raise_on(err, "bilstm_fwd")
    _count("bilstm_fwd", route, ROUTES)
    return hs, cs, gates


def _launch_lstm_bwd(whh, gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype):
    T, R, G = gates.shape
    kw = dict(dtype=torch.float32, device=gates.device)
    dxp = torch.empty(T, R, G, dtype=x_dtype, device=gates.device)
    dw = torch.empty(G // 4, G, **kw)
    dh0, dc0 = torch.empty(R, G // 4, **kw), torch.empty(R, G // 4, **kw)
    lib, route = _library(), ctypes.c_int()
    with torch.cuda.device(gates.device):
        ex, ex_bytes = _exchange(1, R, G // 4, whh.dtype, gates.device, backward=True)
        err = lib.lstm_bwd(
            whh.data_ptr(), gates.data_ptr(), cs.data_ptr(), hs.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), dhs.data_ptr(), dhf.data_ptr(), dcf.data_ptr(),
            dxp.data_ptr(), dw.data_ptr(), dh0.data_ptr(), dc0.data_ptr(),
            T, R, G // 4, int(whh.dtype == torch.bfloat16),
            None if ex is None else ex.data_ptr(), ex_bytes, _build.stream(gates), ctypes.byref(route),
        )
    _raise_on_walk(err, "lstm_bwd", 1, R, G // 4, whh.dtype)
    _count("lstm_bwd", route, ROUTES_BWD)
    return dxp, dw, dh0, dc0


def _launch_bilstm_bwd(whh_f, whh_b, gates, cs, hs, dhs, x_dtype):
    T, R, G = gates.shape
    dxp = torch.empty(T, R, G, dtype=x_dtype, device=gates.device)
    dwf = torch.empty(G // 4, G, dtype=torch.float32, device=gates.device)
    dwb = torch.empty_like(dwf)
    lib, route = _library(), ctypes.c_int()
    with torch.cuda.device(gates.device):
        ex, ex_bytes = _exchange(2, R // 2, G // 4, whh_f.dtype, gates.device, backward=True)
        err = lib.bilstm_bwd(
            whh_f.data_ptr(), whh_b.data_ptr(), gates.data_ptr(), cs.data_ptr(),
            hs.data_ptr(), dhs.data_ptr(), dxp.data_ptr(), dwf.data_ptr(), dwb.data_ptr(),
            T, R // 2, G // 4, int(whh_f.dtype == torch.bfloat16),
            None if ex is None else ex.data_ptr(), ex_bytes, _build.stream(gates), ctypes.byref(route),
        )
    _raise_on_walk(err, "bilstm_bwd", 2, R // 2, G // 4, whh_f.dtype)
    _count("bilstm_bwd", route, ROUTES_BWD)
    return dxp, dwf, dwb


def _launch_lstm_dwhh(hs, h0, dg, directions, dtype):
    T, R, H = hs.shape
    dws = tuple(torch.empty(H, 4 * H, dtype=torch.float32, device=hs.device)
                for _ in range(directions))
    lib = _library()
    with torch.cuda.device(hs.device):
        err = lib.lstm_dwhh(
            hs.data_ptr(), None if h0 is None else h0.data_ptr(), dg.data_ptr(),
            dws[0].data_ptr(), None if directions == 1 else dws[1].data_ptr(),
            T, R // directions, directions, H, int(dtype == torch.bfloat16), _build.stream(hs),
        )
    _raise_on(err, "lstm_dwhh")
    return dws


def lstm_dwhh(hs, h0, dg, directions, dtype):
    """The dW_hh kernel alone (kernel on CUDA, plain version on the CPU),
    as `lstm_bwd` / `bilstm_bwd` launch it after their walk; see
    `lstm_dwhh_ref` for shapes.  On the card `dg` is the walk's dxp, in the
    operand type `dtype`."""
    if hs.dim() != 3 or directions not in (1, 2) or hs.shape[1] % directions or 0 in hs.shape:
        raise ValueError(f"hs must be [T, R, H] with R a multiple of {directions}, got {tuple(hs.shape)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the operand type must be bf16 or fp32, got {dtype}")
    T, R, H = hs.shape
    _check_fp32((hs,), (T, R, H))
    if h0 is not None:
        _check_fp32((h0,), (R, H))
    if tuple(dg.shape) != (T, R, 4 * H):
        raise ValueError(f"dg must be [{T}, {R}, {4 * H}], got {tuple(dg.shape)}")
    _same_device_contiguous((hs, dg) if h0 is None else (hs, h0, dg))
    if hs.device.type == "cuda" and dg.dtype != dtype:
        raise ValueError(f"the kernel reads dg (dxp) in the operand type {dtype}, got {dg.dtype}")
    fn = _build.dispatch(hs.device, _launch_lstm_dwhh, lstm_dwhh_ref)
    return fn(hs, h0, dg, directions, dtype)


def lstm_bwd(whh, gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype):
    """Backward of one direction (kernel on CUDA, plain version on the CPU);
    see `lstm_bwd_ref` for shapes and dtypes."""
    _check_bwd((whh,), gates, (cs, hs, dhs), (h0, c0, dhf, dcf), x_dtype)
    fn = _build.dispatch(gates.device, _launch_lstm_bwd, lstm_bwd_ref)
    return fn(whh, gates, cs, hs, h0, c0, dhs, dhf, dcf, x_dtype)


def bilstm_bwd(whh_f, whh_b, gates, cs, hs, dhs, x_dtype):
    """Backward of both directions (kernel on CUDA, plain version on the
    CPU); see `bilstm_bwd_ref` for shapes and dtypes."""
    if gates.dim() != 3 or gates.shape[1] % 2:
        raise ValueError(f"gates must be [T, 2B, 4H], got {tuple(gates.shape)}")
    _check_bwd((whh_f, whh_b), gates, (cs, hs, dhs), (), x_dtype)
    fn = _build.dispatch(gates.device, _launch_bilstm_bwd, bilstm_bwd_ref)
    return fn(whh_f, whh_b, gates, cs, hs, dhs, x_dtype)


# ---------------------------------------------------------------------------
# Autograd: the backward kernels behind the forward ones
# ---------------------------------------------------------------------------


def _cs_cotangent(dcs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The final cell state's cotangent; the kernels take no other of cs."""
    if dcs is None:
        return None
    if dcs.shape[0] > 1 and bool(dcs[:-1].any()):
        raise NotImplementedError("gradients reach cs only through its last step")
    return dcs[-1].float().contiguous()


# ---------------------------------------------------------------------------
# The operators: the one launch path of the forward kernels
# ---------------------------------------------------------------------------


@torch.library.custom_op(
    "voicesplit::lstm_fwd", mutates_args=(),
    schema="(Tensor xp, Tensor whh, Tensor h0, Tensor c0) -> (Tensor, Tensor, Tensor)",
)
def _lstm_fwd_op(xp, whh, h0, c0):
    _check(xp, h0.shape[0], (whh,), (h0, c0))
    return _build.dispatch(xp.device, _launch_lstm_fwd, lstm_fwd_ref)(xp, whh, h0, c0)


@torch.library.custom_op(
    "voicesplit::bilstm_fwd", mutates_args=(),
    schema="(Tensor xp, Tensor whh_f, Tensor whh_b) -> (Tensor, Tensor, Tensor)",
)
def _bilstm_fwd_op(xp, whh_f, whh_b):
    if xp.dim() != 3 or xp.shape[1] % 2:
        raise ValueError(f"xp must be [T, 2B, 4H], got {tuple(xp.shape)}")
    _check(xp, xp.shape[1], (whh_f, whh_b), ())
    return _build.dispatch(xp.device, _launch_bilstm_fwd, bilstm_fwd_ref)(xp, whh_f, whh_b)


def _fake_outputs(xp, whh):
    """``hs, cs [T, R, H]`` and ``gates [T, R, 4H]``, fp32 on xp's device."""
    T, R = xp.shape[:2]
    H = whh.shape[0]
    return (xp.new_empty((T, R, H), dtype=torch.float32),
            xp.new_empty((T, R, H), dtype=torch.float32),
            xp.new_empty((T, R, 4 * H), dtype=torch.float32))


@_lstm_fwd_op.register_fake
def _(xp, whh, h0, c0):
    return _fake_outputs(xp, whh)


@_bilstm_fwd_op.register_fake
def _(xp, whh_f, whh_b):
    return _fake_outputs(xp, whh_f)


class _LSTMFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, whh, h0, c0, save):
        hs, cs, gates = torch.ops.voicesplit.lstm_fwd(xp, whh, h0, c0)
        ctx.mark_non_differentiable(gates)
        ctx.set_materialize_grads(False)
        ctx.x_dtype = xp.dtype
        if save:
            ctx.save_for_backward(whh, gates, cs, hs, h0, c0)
        return hs, cs, gates

    @staticmethod
    def backward(ctx, dhs, dcs, _dgates):
        whh, gates, cs, hs, h0, c0 = ctx.saved_tensors
        dcf = _cs_cotangent(dcs)
        dhs = torch.zeros_like(hs) if dhs is None else dhs.float().contiguous()
        dhf = torch.zeros_like(h0)
        dcf = torch.zeros_like(c0) if dcf is None else dcf
        dxp, dw, dh0, dc0 = lstm_bwd(whh, gates, cs, hs, h0, c0, dhs, dhf, dcf, ctx.x_dtype)
        return dxp, dw.to(whh.dtype), dh0, dc0, None


class _BiLSTMFwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, whh_f, whh_b, save):
        hs, cs, gates = torch.ops.voicesplit.bilstm_fwd(xp, whh_f, whh_b)
        ctx.mark_non_differentiable(gates)
        ctx.set_materialize_grads(False)
        ctx.x_dtype = xp.dtype
        if save:
            ctx.save_for_backward(whh_f, whh_b, gates, cs, hs)
        return hs, cs, gates

    @staticmethod
    def backward(ctx, dhs, dcs, _dgates):
        whh_f, whh_b, gates, cs, hs = ctx.saved_tensors
        if dcs is not None and bool(dcs.any()):
            raise NotImplementedError("the two-direction kernel takes no cotangent of cs")
        dhs = torch.zeros_like(hs) if dhs is None else dhs.float().contiguous()
        dxp, dwf, dwb = bilstm_bwd(whh_f, whh_b, gates, cs, hs, dhs, ctx.x_dtype)
        return dxp, dwf.to(whh_f.dtype), dwb.to(whh_b.dtype), None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_fwd(xp, whh, h0, c0):
    """One-direction recurrence (kernel on CUDA, plain version on the CPU);
    see `lstm_fwd_ref` for shapes and dtypes.  Differentiable in xp, whh,
    h0, c0 through hs and the final cell state ``cs[-1]``."""
    return _LSTMFwd.apply(xp, whh, h0, c0, _needs_grad(xp, whh, h0, c0))


def bilstm_fwd(xp, whh_f, whh_b):
    """Two-direction recurrence (kernel on CUDA, plain version on the CPU);
    see `bilstm_fwd_ref` for shapes and dtypes.  Differentiable in xp and
    both W_hh through hs."""
    return _BiLSTMFwd.apply(xp, whh_f, whh_b, _needs_grad(xp, whh_f, whh_b))
