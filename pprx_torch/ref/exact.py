"""Exact PPR by power iteration (counterpart of ``pprx.ref.exact``).

The ground truth the push engine is held to, and independent of it: a
sparse matrix product of PyTorch's, not the engine's rounds or kernels.
With the row-stochastic transition matrix P (uniform over out-edges,
parallel edges counted; a dangling vertex keeps its mass, as a self-loop,
the convention every engine shares) and teleport alpha,

    pi_s = alpha * e_s + (1 - alpha) * pi_s @ P.

All sources iterate at once, as columns of one [n, k] matrix, in f64 on
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
    """f64 [len(sources), n]: pi_s for each source, iterated until every
    source's L1 step is below ``tol``. Iterates on ``device`` (``None``:
    the card)."""
    device = resolve_device(device)
    pt = transition_matrix_t(src, dst, n, device)
    src_idx = torch.as_tensor(np.asarray(sources, dtype=np.int64), device=device)
    k = src_idx.shape[0]
    tele = torch.zeros((n, k), dtype=torch.float64, device=device)
    tele[src_idx, torch.arange(k, device=device)] = alpha
    pi = tele / alpha
    for _ in range(max_iter):
        nxt = tele + (1.0 - alpha) * (pt @ pi)
        step = float((nxt - pi).abs().sum(0).max())
        pi = nxt
        if step < tol:
            break
    return pi.T.cpu().numpy()
