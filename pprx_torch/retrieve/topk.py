"""Top-k-by-PPR-score retrieval head (port of ``pprx.retrieve.topk``).

``p`` is vertex-major [N+1, S]; top-k runs per query over the vertex axis
(phantom row excluded). Both heads run ``torch.topk``: torch has nothing
like ``lax.approx_max_k``, so ``exact=False`` is exact too. The reference's
chunked two-stage reduction (``exact_topk_rows``, ``TOPK_LANES_MAX``) guards
a TPU compile-time cliff and is not ported.
"""

from __future__ import annotations

import torch

from pprx_torch import trace
from pprx_torch.engine.state import PprState


def topk_candidates(
    p: torch.Tensor, k: int, exact: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k vertices by reserve score: (scores [S, k], ids [S, k]),
    scores descending per query. ``exact`` is accepted for the reference's
    signature; both values give the exact answer. The flight recorder
    stamps its device work at ``topk`` and ``topk.end``."""
    del exact  # see module docstring
    trace.stamp("topk", p.device)
    out = torch.topk(p[:-1].T, k, dim=1, largest=True, sorted=True)
    trace.stamp("topk.end", p.device)
    return out


def retrieve(state: PprState, k: int = 100, exact: bool = True):
    """Candidate generation from a converged push state."""
    return topk_candidates(state.p, k, exact)
