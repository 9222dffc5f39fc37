"""ACPM's test-time profile matching, on the host (port of
fudanocr_tpu/eval/profile_matching.py; reference
character-profile-matching/util.py:38-200, 381-441).

A decoded radical sequence picks the characters whose decomposition lies
within `search_level` of the least Levenshtein distance; among several,
the pick maximises a weighted similarity of the conv features (1 - MSE),
the radical count, the stroke-orientation counts and the stroke-length
inner ratios.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from fudanocr_tpu_torch.eval.levenshtein import edit_distance


def get_candidates(pred: str, legal_radicals: Sequence[str],
                   search_level: int = 0) -> List[int]:
    """Indices of the characters whose decomposition is within min +
    `search_level` edit distance of `pred` (util.py:153-176)."""
    dists = [edit_distance(pred, r) for r in legal_radicals]
    lo = min(dists)
    return [i for i, d in enumerate(dists) if d <= lo + search_level]


def _inner_ratio(v: np.ndarray) -> np.ndarray:
    """A stroke-length vector -> its components over the first."""
    v = np.asarray(v, np.float64)
    base = v[0] if abs(v[0]) > 1e-8 else 1.0
    return v / base


def _ratio_sim(r: float) -> float:
    """The similarity of a ratio to 1 (util.py inner_ratio_similarity)."""
    if r <= 0 or not np.isfinite(r):
        return 0.0
    return float(min(r, 1.0 / r))


def select_candidate(candidates: Sequence[int],
                     pred_feature: np.ndarray,
                     pred_r_num: float,
                     pred_s_num: np.ndarray,
                     pred_s_len: np.ndarray,
                     profile_features: Dict[int, np.ndarray],
                     profile_r_num: Sequence[float],
                     profile_s_num: Sequence[np.ndarray],
                     profile_s_len: Sequence[np.ndarray],
                     lambdas=(1.0, 1.0, 1.0, 1.0)) -> int:
    """The candidate index of the largest weighted similarity
    (util.py:122-152); the first on a tie."""
    lam_f, lam_rn, lam_sn, lam_sl = lambdas
    best, best_sim = candidates[0], -np.inf
    for idx in candidates:
        sim_f = 1.0 - float(np.mean((pred_feature
                                     - profile_features[idx]) ** 2))
        sim_rn = 1.0 - abs(float(pred_r_num) - float(profile_r_num[idx]))
        sim_sn = 1.0 - float(np.mean((np.asarray(pred_s_num)
                                      - np.asarray(profile_s_num[idx])) ** 2))
        rp = _inner_ratio(pred_s_len)
        rc = _inner_ratio(profile_s_len[idx])
        with np.errstate(divide="ignore", invalid="ignore"):
            sim_sl = np.mean([_ratio_sim(rp[k] / rc[k]) if rc[k] else 0.0
                              for k in range(1, 4)])
        total = (sim_f * lam_f + sim_rn * lam_rn + sim_sn * lam_sn
                 + sim_sl * lam_sl)
        if total > best_sim:
            best_sim, best = total, idx
    return best
