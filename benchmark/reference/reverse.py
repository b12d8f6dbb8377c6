"""The plain reference of reverse (target-side) PPR and the numbers that
``correct`` compares in a reverse cell, in float64.

Rewritten for the benchmark from the definitions, not from the port: the
same convention as ``exact.py``, that a vertex without out-edges keeps its
mass as a self-loop, and parallel edges count. With the row-stochastic
transition matrix P (P[u, w] = 1 / d_out(u) for each edge (u, w)) and
teleport alpha, M = alpha (I - (1 - alpha) P)^-1, and the column ``M e_t``
holds pi_s(t) for every s: what each vertex sends to the target t. A
reverse push state ``(p, r)`` of target t keeps ``p + M r = M e_t`` in
exact arithmetic, at any eps, so ``p`` must equal ``M (e_t - r)``; what is
left is rounding or a fault (a slide applied wrong, a lost delivery).

- ``inv_gap_reverse``: the largest ``|p_t(s) - [M (e_t - r_t)](s)|`` over
  every vertex s and every judged target t (the L-infinity form: a
  column's entries are each a probability, its sum is not bounded).
- ``fresh_reverse``: the largest ``|r|`` over eps; the reverse push's
  threshold is ``|r| > eps`` at every vertex, so its limit is 1.

Imports nothing of the port.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def transition(src, dst, n: int, device) -> torch.Tensor:
    """Sparse (CSR) float64 P, ``[n, n]``, built on ``device`` from the
    edges (numpy arrays or tensors): row u holds 1 / d_out(u) at each of
    its out-edges' ``dst``, parallel edges summed as the product sums
    them; a vertex without out-edges gets a self-loop of weight 1."""
    src = torch.as_tensor(src, device=device).long()
    dst = torch.as_tensor(dst, device=device).long()
    deg = torch.bincount(src, minlength=n)[:n].double()
    dangling = torch.nonzero(deg == 0).squeeze(1)
    rows, order = torch.sort(torch.cat([src, dangling]))
    cols = torch.cat([dst, dangling])[order]
    vals = torch.cat([deg.reciprocal()[src],
                      torch.ones(dangling.shape[0], dtype=torch.float64, device=device)])[order]
    del src, dst, order
    crow = torch.searchsorted(rows, torch.arange(n + 1, device=device))
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, vals, (n, n), check_invariants=False)


def solve(pm: torch.Tensor, rhs: torch.Tensor, alpha: float, tol: float = 1e-13,
          max_iter: int = 10_000) -> torch.Tensor:
    """``x = alpha rhs + (1 - alpha) P x`` for each column of ``rhs``
    (``[n, k]`` on ``pm``'s device), iterated until the largest entry of a
    step is below ``tol``: P is row-stochastic, so each step shrinks that
    by ``1 - alpha`` and the error left is below ``tol (1 - alpha) /
    alpha``. Raises if it does not get there."""
    tele = alpha * rhs.double()
    x = tele
    for _ in range(max_iter):
        nxt = torch.sparse.mm(pm, x).mul_(1.0 - alpha).add_(tele)
        step = float((nxt - x).abs().max())
        x = nxt
        if step < tol:
            return x
    raise RuntimeError(f"power iteration did not reach {tol} in {max_iter} steps")


def inv_gap_reverse(pm: torch.Tensor, p, r, targets, alpha: float, block: int = 32) -> float:
    """``max_t max_s |p[s, t] - [M (e_t - r[:, t])](s)|`` over the columns
    of ``p`` and ``r`` (``[>= n, k]``, numpy arrays or tensors; column j
    belongs to ``targets[j]``), ``block`` columns a solve."""
    n, dev = pm.shape[0], pm.device
    targets = np.asarray(targets, dtype=np.int64)
    worst = 0.0
    for lo in range(0, targets.shape[0], block):
        cols = slice(lo, lo + block)
        t = torch.as_tensor(targets[cols], device=dev)
        rhs = -torch.as_tensor(r[:n, cols], device=dev).double()
        rhs[t, torch.arange(t.shape[0], device=dev)] += 1.0
        want = solve(pm, rhs, alpha)
        del rhs
        want -= torch.as_tensor(p[:n, cols], device=dev).double()
        worst = max(worst, float(want.abs().max()))
    return worst


def fresh_reverse(r, n: int, eps: float, block: int | None = None) -> float:
    """``max |r[v, j]| / eps`` over rows ``v < n`` and every column; ``r``
    a numpy array or a tensor, read where it lies, ``block`` rows at a
    time."""
    r = torch.as_tensor(r)
    block = block or max(1, (1 << 24) // max(r.shape[1], 1))
    worst = 0.0
    for lo in range(0, n, block):
        worst = max(worst, float(r[lo:min(lo + block, n)].abs().max()))
    return worst / eps
