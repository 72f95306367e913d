"""The comparison that decides ``correct``: the program's readings of the
checked blocks against the reference's, each number held to its limit.

* ``loss_gap``: the largest relative gap between the program's loss and
  the reference's, over every local step of every agent in every checked
  block.
* ``grad_gap``: the first gradient (local step 0 of block 0) as the
  optimizer gets it, by the worst leaf and agent: the gap between the
  program's norm of the leaf's gradient and the reference's, over the
  reference's norm of that leaf or of the agent's median leaf, whichever
  is larger.
* ``change_gap``: the same for each leaf's change after the checked
  blocks, leaving out leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by rounding alone).

A number that is not finite fails.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["compare", "norm_gap", "passes", "EXCLUDE_BELOW"]

#: leaves whose reference gradient norm is under this share of the
#: median leaf's take no part in change_gap
EXCLUDE_BELOW = 1e-3


def norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """max over leaves p and agents k of |prog - ref| / max(ref, the
    median of ref over the leaves) (``prog``, ``ref``: {path: (K,)}),
    over the leaves ``keep(p, k)`` admits."""
    paths = sorted(ref)
    r = np.array([ref[p] for p in paths], dtype=np.float64)   # (P, K)
    g = np.array([prog[p] for p in paths], dtype=np.float64)
    worst = 0.0
    for k in range(r.shape[1]):
        rows = [i for i, p in enumerate(paths) if keep is None or keep(p, k)]
        if not rows:
            continue
        med = float(np.median(r[rows, k]))
        for i in rows:
            denom = max(r[i, k], med)
            gap = abs(g[i, k] - r[i, k]) / denom if denom > 0 else \
                (0.0 if g[i, k] == 0 else math.inf)
            if not math.isfinite(gap) or not math.isfinite(g[i, k]):
                return math.inf
            worst = max(worst, gap)
    return worst


def compare(prog: dict, ref: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of the three numbers (module docstring).
    ``prog`` and ``ref``: {"loss": (blocks, T, K), "grad0": {path: (K,)},
    "change": {path: (K,)}}."""
    lp = np.asarray(prog["loss"], dtype=np.float64)
    lr = np.asarray(ref["loss"], dtype=np.float64)
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr))) \
        if np.all(np.isfinite(lp)) else math.inf
    g_ref = ref["grad0"]
    paths = sorted(g_ref)
    med = np.median(np.array([g_ref[p] for p in paths]), axis=0)

    def moves(p, k):
        return g_ref[p][k] >= EXCLUDE_BELOW * med[k]

    numbers = {"loss_gap": loss_gap,
               "grad_gap": norm_gap(prog["grad0"], g_ref),
               "change_gap": norm_gap(prog["change"], ref["change"], moves)}
    return {name: {"value": value, "limit": limits[name]}
            for name, value in numbers.items()}


def passes(checks: dict) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
