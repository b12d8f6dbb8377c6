"""The numbers that decide ``correct``, each from the program's outputs and
the plain reference (``exact``), in float64.

- ``inv_gap``: the largest L1 distance, over the sampled sources, between
  the program's reserve ``p`` and what the reference says it must hold,
  ``(e_s - r) M``. Every push and every edge correction keeps ``p + r M =
  pi_s`` in exact arithmetic, at any eps, so what is left is rounding or a
  fault: a slide applied wrong, a lost delivery, an altered entry.
- ``fresh``: the largest ``|r[v, j]| / (eps max(d_out(v), 1))`` over every
  vertex and source, degrees from the reference's own window. Freshness at
  eps is the configuration's guarantee, so its limit is 1, and the
  invariant then bounds ``p``'s error by ``r``.
- ``topk_ties``: the mass of ``p`` that a read's served ids miss against
  the true top-k of the same ``p`` (summed exactly, so a served set that
  is a top-k, ties included, reads 0): the top-k stage followed from the
  program's own state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import exact


def fresh(r, deg: np.ndarray, eps: float, block: int | None = None) -> float:
    """``max |r[v, j]| / (eps max(deg[v], 1))`` over rows ``v < len(deg)``;
    ``r`` a numpy array or a tensor, read where it lies, ``block`` rows at a
    time."""
    r = torch.as_tensor(r)
    n = deg.shape[0]
    block = block or max(1, (1 << 24) // max(r.shape[1], 1))
    thr = eps * torch.as_tensor(deg, device=r.device).clamp(min=1).double()
    worst = torch.zeros((), dtype=torch.float64, device=r.device)
    for lo in range(0, n, block):
        rows = r[lo:min(lo + block, n)].abs().amax(1).double()
        worst = torch.maximum(worst, (rows / thr[lo:lo + rows.shape[0]]).max())
    return float(worst)


def inv_gap(pt: torch.Tensor, p: np.ndarray, r: np.ndarray, sources, alpha: float,
            block: int = 32) -> float:
    """``max_j ||p[:, j] - (e_{sources[j]} - r[:, j]) M||_1`` over the
    given columns (``p``, ``r``: ``[>= n, k]``), ``block`` columns at a
    time."""
    n = pt.shape[0]
    dev = pt.device
    sources = np.asarray(sources)
    worst = 0.0
    for lo in range(0, sources.shape[0], block):
        cols = slice(lo, lo + block)
        rhs = exact.unit_columns(n, sources[cols], dev)
        rhs -= torch.as_tensor(r[:n, cols], device=dev).double()
        want = exact.solve(pt, rhs, alpha)
        del rhs
        want -= torch.as_tensor(p[:n, cols], device=dev).double()
        worst = max(worst, float(want.abs().sum(0).max()))
    return worst


def _missed(scores: np.ndarray, ids: np.ndarray, k: int) -> float:
    """Exact sum of the k largest ``scores`` less the exact sum of
    ``scores`` over the distinct in-range ``ids``."""
    n = scores.shape[0]
    best = np.partition(scores, n - k)[n - k:] if n > k else scores
    ids = np.unique(ids[(ids >= 0) & (ids < n)])
    return math.fsum(best.tolist()) - math.fsum(scores[ids].tolist())


def topk_ties(p: np.ndarray, ids: np.ndarray, k: int) -> float:
    """The largest mass of ``p`` missed over the columns of ``p`` (``[n,
    m]``, float64) and the rows of ``ids`` (``[m, k]``): each id counted
    once, an id out of range counting 0."""
    return max(_missed(p[:, j], ids[j], k) for j in range(ids.shape[0]))
