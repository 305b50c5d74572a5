"""Scale-invariant SNR with permutation-invariant training (counterpart of
`voicesplit_tpu/losses/si_snr.py`; reference `utils/generic_utils.py:403-474`).

The pairwise SI-SNR matrix is computed for all (estimate, source) pairs at
once and the best permutation is picked by a gather over the ``C!``
permutations, for any number of sources C (the trainer uses C = 1, where
PIT is plain negative SI-SNR).
"""

from __future__ import annotations

from itertools import permutations
from typing import Optional

import torch

# ε of the JAX package's functions (their `epsilon` default)
_EPS = 1e-16


def sequence_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """``[B] → [B, 1, max_len]`` float 0/1 mask (reference `get_mask`)."""
    pos = torch.arange(max_len, device=lengths.device)[None, None, :]
    return (pos < lengths[:, None, None]).float()


def si_snr_matrix(
    estimate: torch.Tensor,  # [B, C, T]
    source: torch.Tensor,  # [B, C, T]
    lengths: Optional[torch.Tensor] = None,  # [B]
) -> torch.Tensor:
    """Pairwise SI-SNR ``[B, C_est, C_src]`` after masking and zero-meaning."""
    B, C, T = source.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=source.device)
    mask = sequence_mask(lengths, T)
    estimate = estimate * mask
    source = source * mask

    # max(len, 1): a zero-length item yields a finite 0-energy row, not 0/0
    num = torch.clamp(lengths[:, None, None].float(), min=1.0)
    source = (source - torch.sum(source, 2, keepdim=True) / num) * mask
    estimate = (estimate - torch.sum(estimate, 2, keepdim=True) / num) * mask

    s_tgt = source[:, None, :, :]  # [B, 1, C, T]
    s_est = estimate[:, :, None, :]  # [B, C, 1, T]
    dot = torch.sum(s_est * s_tgt, dim=3, keepdim=True)  # [B, C, C, 1]
    tgt_energy = torch.sum(s_tgt**2, dim=3, keepdim=True) + _EPS
    proj = dot * s_tgt / tgt_energy  # [B, C, C, T]
    noise = s_est - proj
    ratio = torch.sum(proj**2, dim=3) / (torch.sum(noise**2, dim=3) + _EPS)
    return 10.0 * torch.log10(ratio + _EPS)  # [B, C, C]


def si_snr_with_pit(
    estimate: torch.Tensor,
    source: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """PIT loss: ``20 − mean(max-permutation SI-SNR / C)``."""
    C = source.shape[1]
    matrix = si_snr_matrix(estimate, source, lengths)
    perms = torch.tensor(list(permutations(range(C))), device=matrix.device)  # [C!, C]
    # snr_set[b, p] = sum_i matrix[b, i, perms[p, i]]
    gathered = matrix[:, torch.arange(C, device=matrix.device)[None, :], perms]  # [B, C!, C]
    max_snr = gathered.sum(dim=-1).max(dim=-1).values / C  # [B]
    return 20.0 - max_snr.mean()


def si_snr(
    estimate: torch.Tensor,  # [..., T]
    source: torch.Tensor,  # [..., T]
    lengths: Optional[torch.Tensor] = None,  # leading dims of [..., 1]
) -> torch.Tensor:
    """Plain SI-SNR in dB per item (the eval metric; higher is better).

    ``lengths`` masks the trailing zero-pad of short items."""
    if lengths is not None:
        T = source.shape[-1]
        mask = (torch.arange(T, device=source.device) < lengths[..., None]).to(source.dtype)
        source = source * mask
        estimate = estimate * mask
        cnt = torch.clamp(lengths[..., None].to(source.dtype), min=1.0)
        source = (source - torch.sum(source, -1, keepdim=True) / cnt) * mask
        estimate = (estimate - torch.sum(estimate, -1, keepdim=True) / cnt) * mask
    else:
        source = source - torch.mean(source, dim=-1, keepdim=True)
        estimate = estimate - torch.mean(estimate, dim=-1, keepdim=True)
    dot = torch.sum(estimate * source, dim=-1, keepdim=True)
    energy = torch.sum(source**2, dim=-1, keepdim=True) + _EPS
    proj = dot * source / energy
    noise = estimate - proj
    ratio = torch.sum(proj**2, dim=-1) / (torch.sum(noise**2, dim=-1) + _EPS)
    return 10.0 * torch.log10(ratio + _EPS)
