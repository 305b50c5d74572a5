"""GE2E softmax loss (Wan et al. 2018, arXiv:1710.10467 §2.1) and the
pairwise EER that measures an encoder's progress (counterpart of
`voicesplit_tpu/losses/ge2e.py`).

Batch layout: ``emb [N, M, D]``, N speakers x M utterances, each already
L2-normalized (the `SpeakerEncoder` output).  Each utterance is scored
against every speaker centroid, its own speaker's centroid computed without
the utterance itself (eq. 8-9); the scores are scaled by a learnable
``(w, b)`` with w kept positive (eq. 5); softmax loss (eq. 6/10).  The EER
functions are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def ge2e_softmax_loss(emb: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean GE2E softmax loss over the [N, M] utterances.

    ``emb`` must be L2-normalized along D.  ``w`` / ``b`` are the scalar
    (0-d or [1]) similarity scale and bias; w is clamped at 1e-4 inside the
    loss (the paper keeps w > 0)."""
    N, M, D = emb.shape
    if N < 2 or M < 2:
        raise ValueError("GE2E needs >=2 speakers and >=2 utterances each")
    w = torch.clamp(w.reshape(()), min=1e-4)
    b = b.reshape(())

    cent = emb.mean(dim=1)  # [N, D]
    cent = cent / (torch.linalg.vector_norm(cent, dim=-1, keepdim=True) + 1e-8)
    # exclusive own centroid per utterance (eq. 9)
    excl = (emb.sum(dim=1, keepdim=True) - emb) / (M - 1)  # [N, M, D]
    excl = excl / (torch.linalg.vector_norm(excl, dim=-1, keepdim=True) + 1e-8)

    sim = torch.einsum("nmd,kd->nmk", emb, cent)  # cosines: emb is unit-norm
    own = torch.einsum("nmd,nmd->nm", emb, excl)
    eye = torch.eye(N, dtype=torch.bool, device=emb.device)[:, None, :]  # [N, 1, N]
    sim = torch.where(eye, own[:, :, None], sim)
    logits = w * sim + b  # [N, M, N]

    n = torch.arange(N, device=emb.device)[:, None]
    target = logits[n, torch.arange(M, device=emb.device)[None, :], n]  # [N, M]
    return torch.mean(torch.logsumexp(logits, dim=-1) - target)


def _f64(emb) -> np.ndarray:
    if torch.is_tensor(emb):
        emb = emb.detach().cpu().numpy()
    return np.asarray(emb, np.float64)


def _eer_from_pairs(s: np.ndarray, same: np.ndarray) -> float:
    """EER from scored pairs: ``s [P]`` cosine scores, ``same [P]`` bool."""
    if not same.any() or same.all():
        return float("nan")
    order = np.argsort(-s)
    same_sorted = same[order]
    n_same = same.sum()
    n_diff = (~same).sum()
    # sweep thresholds: FA = diff accepted / n_diff, FR = same rejected / n_same
    tp = np.cumsum(same_sorted)
    fp = np.cumsum(~same_sorted)
    fa = fp / n_diff
    fr = 1.0 - tp / n_same
    k = int(np.argmin(np.abs(fa - fr)))
    return float((fa[k] + fr[k]) / 2.0)


def pairwise_eer(emb, speaker_ids) -> float:
    """Equal error rate of cosine utterance-pair verification.

    ``emb [K, D]`` L2-normalized (numpy or a tensor), ``speaker_ids [K]``.
    All K(K-1)/2 pairs are scored by cosine; the EER is where false accept
    equals false reject."""
    e = _f64(emb)
    ids = np.asarray(speaker_ids)
    scores = e @ e.T
    iu = np.triu_indices(len(ids), k=1)
    return _eer_from_pairs(scores[iu], ids[iu[0]] == ids[iu[1]])


def pairwise_eer_stats(emb, speaker_ids, n_boot: int = 1000, seed: int = 0, groups=None,
                       exclude_within_group: bool = True) -> dict:
    """`pairwise_eer` plus the statistics an EER claim needs at small n:
    ``{eer, n_utts, n_trials, n_target, n_nontarget, ci95: [lo, hi], n_boot}``.

    The 95% CI is a percentile bootstrap that resamples utterances with
    replacement (every pair sharing an utterance is correlated), the K x K
    score matrix computed once; resamples without a target or a non-target
    pair are drawn again.  ``groups`` ([K], optional) marks each row's
    dependence cluster (the source recording of sliding-window d-vectors):
    the bootstrap then resamples groups; ``exclude_within_group`` drops
    trials between two rows of one group (a strict cross-session protocol)
    or, False, keeps them (a same-session number, flagged in
    ``within_group_trials``; needed where speakers have one recording).
    ``n_groups`` and ``n_target_cross_group`` are reported with groups.
    """
    e = _f64(emb)
    ids = np.asarray(speaker_ids)
    K = len(ids)
    scores = e @ e.T
    iu = np.triu_indices(K, k=1)
    same_full = ids[iu[0]] == ids[iu[1]]
    rng = np.random.default_rng(seed)
    boots = []
    attempts = 0
    if groups is None:
        out = {
            "eer": _eer_from_pairs(scores[iu], same_full),
            "n_utts": int(K),
            "n_trials": int(same_full.size),
            "n_target": int(same_full.sum()),
            "n_nontarget": int((~same_full).sum()),
        }
        while len(boots) < n_boot and attempts < 4 * n_boot:
            attempts += 1
            idx = rng.integers(0, K, size=K)
            sub = scores[np.ix_(idx, idx)]
            bi = np.triu_indices(K, k=1)
            same = ids[idx][bi[0]] == ids[idx][bi[1]]
            v = _eer_from_pairs(sub[bi], same)
            if v == v:  # not NaN: the resample had both kinds of pair
                boots.append(v)
    else:
        _, grp = np.unique(np.asarray(groups), return_inverse=True)
        within = grp[iu[0]] == grp[iu[1]]
        keep0 = ~within if exclude_within_group else np.ones_like(within)
        same_kept = same_full[keep0]
        out = {
            "eer": _eer_from_pairs(scores[iu][keep0], same_kept),
            "n_utts": int(K),
            "n_groups": int(grp.max() + 1),
            "n_trials": int(same_kept.size),
            "n_target": int(same_kept.sum()),
            "n_nontarget": int((~same_kept).sum()),
            "n_target_cross_group": int((same_full & ~within).sum()),
            "within_group_trials": not exclude_within_group,
        }
        members = [np.flatnonzero(grp == g) for g in range(int(grp.max()) + 1)]
        G = len(members)
        while len(boots) < n_boot and attempts < 4 * n_boot:
            attempts += 1
            draw = rng.integers(0, G, size=G)
            idx = np.concatenate([members[d] for d in draw])
            gs = grp[idx]  # the underlying cluster of each resampled row
            sub = scores[np.ix_(idx, idx)]
            bi = np.triu_indices(len(idx), k=1)
            if exclude_within_group:
                # two copies of one drawn cluster must not pair either
                keep = gs[bi[0]] != gs[bi[1]]
            else:
                # within-cluster pairs are trials, but a row never scores
                # against its own duplicate from a repeated draw
                keep = idx[bi[0]] != idx[bi[1]]
            same = (ids[idx][bi[0]] == ids[idx][bi[1]])[keep]
            v = _eer_from_pairs(sub[bi][keep], same)
            if v == v:
                boots.append(v)
    if boots:
        lo, hi = np.percentile(boots, [2.5, 97.5])
        out["ci95"] = [round(float(lo), 4), round(float(hi), 4)]
        out["n_boot"] = len(boots)
    return out
