"""Exact PPR by power iteration, written plainly for the benchmark.

Rewritten from ``pprx_torch/ref/exact.py`` (the port's own oracle, which the
benchmark may not use): the same convention, that a vertex without
out-edges keeps its mass as a self-loop, and parallel edges count. With the
row-stochastic transition matrix P and teleport alpha, the PPR row of a
source s is pi_s = alpha e_s + (1 - alpha) pi_s P, and M = alpha (I - (1 -
alpha) P)^-1 holds those rows. ``solve`` computes ``v M`` for the columns
of ``rhs`` (each a row vector v): unit vectors give PPR, and ``e_s - r``
gives what a forward-push state ``(p, r)`` must hold in ``p``
(``p + r M = pi_s``, the push invariant).

Everything here is float64 on the given device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def window_edges(src: np.ndarray, dst: np.ndarray, head: int, window: int):
    """The live window of a stream that repeats ``(src, dst)`` end to end:
    stream positions ``[head - window, head)``."""
    pos = np.arange(head - window, head, dtype=np.int64) % src.shape[0]
    return src[pos], dst[pos]


def out_degree(src, n: int) -> np.ndarray:
    """Each vertex's out-degree, from the edges' ``src`` (a numpy array or a
    tensor, counted where it lies)."""
    src = torch.as_tensor(src).long()
    return torch.bincount(src, minlength=n)[:n].cpu().numpy()


def transition_t(src, dst, n: int, device) -> torch.Tensor:
    """Sparse (CSR) float64 P^T, ``[n, n]``, built on ``device`` from the
    edges (numpy arrays or tensors): entry (w, u) is the share of u's mass
    that one step moves to w, parallel edges summed as the product sums
    them; a vertex without out-edges gets a self-loop."""
    src = torch.as_tensor(src, device=device).long()
    dst = torch.as_tensor(dst, device=device).long()
    deg = torch.bincount(src, minlength=n)[:n].double()
    dangling = torch.nonzero(deg == 0).squeeze(1)
    rows, order = torch.sort(torch.cat([dst, dangling]))
    cols = torch.cat([src, dangling])[order]
    vals = torch.cat([deg.reciprocal()[src], torch.ones(dangling.shape[0], dtype=torch.float64,
                                                        device=device)])[order]
    del src, dst, order
    crow = torch.searchsorted(rows, torch.arange(n + 1, device=device))
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(crow, cols, vals, (n, n), check_invariants=False)


def solve(pt: torch.Tensor, rhs: torch.Tensor, alpha: float, tol: float = 1e-13,
          max_iter: int = 10_000) -> torch.Tensor:
    """``x = alpha rhs + (1 - alpha) P^T x`` for each column of ``rhs``
    (float64 ``[n, k]`` on ``pt``'s device), iterated until every column's
    L1 step is below ``tol``; raises if it does not get there."""
    rhs = rhs.double()
    tele = alpha * rhs
    x = rhs
    for _ in range(max_iter):
        nxt = tele + (1.0 - alpha) * torch.sparse.mm(pt, x)
        step = float((nxt - x).abs().sum(0).max())
        x = nxt
        if step < tol:
            return x
    raise RuntimeError(f"power iteration did not reach {tol} in {max_iter} steps")


def unit_columns(n: int, sources, device) -> torch.Tensor:
    """float64 ``[n, k]``: column j is the unit vector of ``sources[j]``."""
    idx = torch.as_tensor(np.asarray(sources, dtype=np.int64), device=device)
    out = torch.zeros((n, idx.shape[0]), dtype=torch.float64, device=device)
    out[idx, torch.arange(idx.shape[0], device=device)] = 1.0
    return out
