"""Exact PPR by power iteration (counterpart of ``pprx.ref.exact``).

The ground truth the push engine is held to, and independent of it: a
sparse matrix product of PyTorch's, not the engine's rounds or kernels.
With the row-stochastic transition matrix P (uniform over out-edges,
parallel edges counted; a dangling vertex keeps its mass, as a self-loop,
the convention every engine shares) and teleport alpha,

    pi_s = alpha * e_s + (1 - alpha) * pi_s @ P.

With M = alpha (I - (1-alpha) P)^-1, pi_s is row s of M. Reverse push
maintains columns of M instead: the contribution vector of a target t,

    c_t = alpha * e_t + (1 - alpha) * P @ c_t,      c_t[v] = M[v, t],

which is what ``exact_ppr_columns`` iterates. The reverse contract: a state
pushed to |r| <= eps has max_v |p[v, j] - M[v, t_j]| <= eps (rows of M sum
to 1).

All queries iterate at once, as columns of one [n, k] matrix, in f64 on
the given device.
"""

from __future__ import annotations

import numpy as np
import torch

from pprx_torch.device import resolve_device


def transition_matrix_t(
    src: np.ndarray, dst: np.ndarray, n: int, device: torch.device | str | None = None
) -> torch.Tensor:
    """Sparse f64 P^T ([n, n], coalesced COO: parallel edges summed) of a
    COO multi-edge list; a dangling vertex gets a self-loop. On ``device``
    (``None``: the card)."""
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    deg = np.bincount(src, minlength=n).astype(np.float64)
    dangling = np.flatnonzero(deg == 0)
    rows = np.concatenate([dst, dangling])
    cols = np.concatenate([src, dangling])
    vals = np.concatenate([1.0 / deg[src], np.ones(dangling.size)])
    with torch.sparse.check_sparse_tensor_invariants():
        pt = torch.sparse_coo_tensor(
            torch.from_numpy(np.stack([rows, cols])), torch.from_numpy(vals), (n, n)
        )
    return pt.coalesce().to(device)


def _unit_columns(n: int, queries, device: torch.device) -> torch.Tensor:
    """f64 [n, len(queries)]: column j is the unit vector of ``queries[j]``."""
    idx = torch.as_tensor(np.asarray(queries, dtype=np.int64), device=device)
    k = idx.shape[0]
    units = torch.zeros((n, k), dtype=torch.float64, device=device)
    units[idx, torch.arange(k, device=device)] = 1.0
    return units


def _fixed_point(mat: torch.Tensor, rhs: torch.Tensor, alpha: float, tol: float, max_iter: int):
    """f64 [n, k] on ``mat``'s device: x = alpha rhs + (1-alpha) mat @ x for
    each column of ``rhs``, iterated until every column's L1 step is below
    ``tol``."""
    tele = alpha * rhs
    x = rhs
    for _ in range(max_iter):
        nxt = tele + (1.0 - alpha) * (mat @ x)
        step = float((nxt - x).abs().sum(0).max())
        x = nxt
        if step < tol:
            break
    return x


def exact_ppr(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    sources,
    alpha: float,
    tol: float = 1e-12,
    max_iter: int = 100_000,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """f64 [len(sources), n]: pi_s (row s of M) for each source, iterated
    until every source's L1 step is below ``tol``. Iterates on ``device``
    (``None``: the card)."""
    pt = transition_matrix_t(src, dst, n, resolve_device(device))
    x = _fixed_point(pt, _unit_columns(n, sources, pt.device), alpha, tol, max_iter)
    return x.T.cpu().numpy()


def exact_ppr_columns(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    targets,
    alpha: float,
    tol: float = 1e-12,
    max_iter: int = 100_000,
    device: torch.device | str | None = None,
) -> np.ndarray:
    """f64 [len(targets), n]: column t of M (``out[j, v] = M[v, t_j]``, the
    contribution of v to t) for each target: what reverse push
    approximates. Iterates on ``device`` (``None``: the card)."""
    p = transition_matrix_t(src, dst, n, resolve_device(device)).t().coalesce()
    x = _fixed_point(p, _unit_columns(n, targets, p.device), alpha, tol, max_iter)
    return x.T.cpu().numpy()


def ppr_matrix_times(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    x: torch.Tensor,
    alpha: float,
    tol: float = 1e-12,
    max_iter: int = 100_000,
) -> torch.Tensor:
    """f64 [n, k] on ``x``'s device: ``M @ x`` for the columns of ``x``
    (``[n, k]``), by the same iteration as ``exact_ppr_columns`` (which is
    this on unit vectors)."""
    mat = transition_matrix_t(src, dst, n, x.device).t().coalesce()
    return _fixed_point(mat, x.double(), alpha, tol, max_iter)


def reverse_invariant_gap(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    targets,
    p: torch.Tensor,
    r: torch.Tensor,
    alpha: float,
    tol: float = 1e-12,
) -> float:
    """How far a reverse state is from its invariant: the largest entry of
    ``|p + M r - M e_t|`` over the given columns (``p``, ``r``: ``[>= n, k]``,
    column j for ``targets[j]``), in f64 on the state's device. Pushes and
    edge corrections keep ``p + M r = M e_t`` in exact arithmetic, at any
    eps; what is measured here is what rounding, or a fault, has added, and
    no further push removes it. One solve: ``M (e_t - r)`` against ``p``."""
    rhs = _unit_columns(n, targets, p.device) - r[:n].double()
    return float((p[:n].double() - ppr_matrix_times(src, dst, n, rhs, alpha, tol)).abs().max())
