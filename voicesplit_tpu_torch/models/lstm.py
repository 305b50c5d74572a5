"""LSTM layers with a hoisted input projection (PyTorch counterpart of
`voicesplit_tpu/models/lstm.py`).

The input projection ``x @ W_ih + b`` for all time steps is one matmul
outside the recurrence; the recurrence runs in the kernels of
`voicesplit_tpu_torch.ops.lstm_cuda` (or their plain versions on the CPU).
Parameters keep the JAX layout and names, ``{fwd,bwd}_w_ih [in, 4H]``,
``_w_hh [H, 4H]`` and ``_b [4H]``, gate order ``[i, f, g, o]``, so weights
carry across from a JAX checkpoint unpermuted.

Gradients reach ``{fwd,bwd}_{w_ih,w_hh,b}`` through the projection matmul
and the kernels' autograd backward (`lstm_bwd` / `bilstm_bwd`).

`UniLSTM`, the streaming model's forward-only LSTM, takes and returns its
``(h, c)`` carry, so that streaming inference threads the state across
chunks (`streaming.py`).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from voicesplit_tpu_torch.ops import lstm_cuda


def lstm_scan(
    x_proj: torch.Tensor,  # [B, T, 4H] — precomputed x @ w_ih + b
    w_hh: torch.Tensor,  # [H, 4H]
    h0: torch.Tensor,  # [B, H]
    c0: torch.Tensor,  # [B, H]
    reverse: bool = False,
    frame_mask: Optional[torch.Tensor] = None,  # [T] or [B, T] 0/1
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Plain recurrence in the inputs' dtype; returns ``([B, T, H], (h, c))``.

    Frames where `frame_mask` is 0 leave the carry untouched."""
    B, T, _ = x_proj.shape
    mask = None
    if frame_mask is not None:
        mask = torch.broadcast_to(torch.atleast_2d(frame_mask), (B, T)).bool()
    h, c = h0, c0
    outs = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = x_proj[:, t] + h @ w_hh
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        if mask is not None:
            m = mask[:, t, None]
            c_new = torch.where(m, c_new, c)
            h_new = torch.where(m, h_new, h)
        h, c = h_new, c_new
        outs[t] = h
    return torch.stack(outs, dim=1), (h, c)


class _LSTMBase(nn.Module):
    """The parameters of `directions`, each ``{d}_w_ih [in, 4H]``,
    ``{d}_w_hh [H, 4H]``, ``{d}_b [4H]``."""

    def __init__(self, in_features: int, hidden: int, compute_dtype, directions):
        super().__init__()
        self.hidden = hidden
        self.compute_dtype = compute_dtype
        H4 = 4 * hidden
        for d in directions:
            self.register_parameter(f"{d}_w_ih", nn.Parameter(torch.empty(in_features, H4)))
            self.register_parameter(f"{d}_w_hh", nn.Parameter(torch.empty(hidden, H4)))
            self.register_parameter(f"{d}_b", nn.Parameter(torch.empty(H4)))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Uniform(-1/sqrt(H), 1/sqrt(H)), the standard LSTM init."""
        s = self.hidden ** -0.5
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-s, s, generator=generator)


class UniLSTM(_LSTMBase):
    """Forward-only LSTM; ``[B, T, in]`` and an optional carry ``(h, c)``
    ``[B, H]`` → ``([B, T, H], (h, c))``, all in the compute dtype.

    As the JAX module (`models/lstm.py:112-128`): the incoming carry is cast
    to the compute dtype (in bf16 it is rounded at every chunk boundary,
    `fused_lstm_scan` returning it in x's dtype), then one `lstm_fwd` from it;
    the outgoing carry is the last step's ``(h, c)``.  It never takes the
    two-direction kernel."""

    def __init__(self, in_features: int, hidden: int, compute_dtype=torch.float32):
        super().__init__(in_features, hidden, compute_dtype, ("fwd",))

    def forward(
        self, x: torch.Tensor, carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        B = x.shape[0]
        cd = self.compute_dtype
        xp = x.to(cd) @ self.fwd_w_ih.to(cd) + self.fwd_b.to(cd)  # [B, T, 4H]
        if carry is None:
            h0 = c0 = torch.zeros(B, self.hidden, dtype=torch.float32, device=x.device)
        else:
            # the kernel takes fp32 states: round to the compute dtype first
            h0, c0 = (s.to(cd).float().contiguous() for s in carry)
        hs, cs, _ = lstm_cuda.lstm_fwd(
            xp.transpose(0, 1).contiguous(), self.fwd_w_hh.to(cd), h0, c0
        )
        return hs.transpose(0, 1).to(cd), (hs[-1].to(cd), cs[-1].to(cd))


class BiLSTM(_LSTMBase):
    """Bidirectional LSTM; ``[B, T, in]`` → ``[B, T, 2H]`` (fwd ∥ bwd).

    Same dispatch as the JAX module (`models/lstm.py:145-160`): a batch
    that is a multiple of 8 runs both directions in one `bilstm_fwd`
    launch; any other batch runs `lstm_fwd` once per direction, the
    backward one on time-flipped input whose output is flipped back.  A
    symbolic batch (`torch.export` with the batch left free) takes the
    route that serves any batch, the two `lstm_fwd` calls, as the JAX
    export takes `lax.scan` (`export.py:75-93`)."""

    def __init__(self, in_features: int, hidden: int, compute_dtype=torch.float32):
        super().__init__(in_features, hidden, compute_dtype, ("fwd", "bwd"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B = x.shape[0]
        cd = self.compute_dtype
        xc = x.to(cd)
        xp_f = xc @ self.fwd_w_ih.to(cd) + self.fwd_b.to(cd)  # [B, T, 4H]
        xp_b = xc @ self.bwd_w_ih.to(cd) + self.bwd_b.to(cd)
        w_f, w_b = self.fwd_w_hh.to(cd), self.bwd_w_hh.to(cd)
        if isinstance(B, int) and B % 8 == 0:
            xcat = torch.cat([xp_f.transpose(0, 1), xp_b.flip(1).transpose(0, 1)], dim=1)
            hs, _, _ = lstm_cuda.bilstm_fwd(xcat.contiguous(), w_f, w_b)  # [T, 2B, H]
            out_f, out_b = hs[:, :B], hs[:, B:].flip(0)
        else:
            zeros = torch.zeros(B, self.hidden, dtype=torch.float32, device=x.device)
            out_f, _, _ = lstm_cuda.lstm_fwd(
                xp_f.transpose(0, 1).contiguous(), w_f, zeros, zeros
            )
            hs_b, _, _ = lstm_cuda.lstm_fwd(
                xp_b.flip(1).transpose(0, 1).contiguous(), w_b, zeros, zeros
            )
            out_b = hs_b.flip(0)
        return torch.cat([out_f, out_b], dim=-1).transpose(0, 1).to(cd)
