"""Typed configuration of the port (counterpart of ``pprx.config``).

The same frozen dataclasses, fields and checks as the reference, so a
configuration means the same in both packages; the port keeps its own copy
so that nothing of the JAX package is imported. The reference's
``MeshConfig`` has no caller there and is not ported: the sharded engines
take a ``pprx_torch.dist.mesh.RowMesh``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PprConfig:
    """Parameters of the push-based PPR approximation.

    alpha: teleport probability (0.15 by default).
    eps: residual tolerance. Forward push is converged when
        ``|r[v]| <= eps * max(d_out(v), 1)`` for every v; reverse push when
        ``|r[v]| <= eps``. Deletions drive residuals negative, hence ``|.|``.
    max_rounds: hard cap on push rounds of one convergence loop.
    """

    alpha: float = 0.15
    eps: float = 1e-6
    max_rounds: int = 10_000

    def __post_init__(self):
        if not (0.0 < self.alpha < 1.0):
            raise ValueError(f"alpha must be in (0,1), got {self.alpha}")
        if self.eps <= 0.0:
            raise ValueError(f"eps must be positive, got {self.eps}")
        if self.max_rounds <= 0:
            raise ValueError(f"max_rounds must be positive, got {self.max_rounds}")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Sliding-window edge-stream parameters.

    window: number of edges W in the live window.
    slide: batch size b per step — b edges inserted at the head and b
        deleted at the tail per slide.
    """

    window: int
    slide: int

    def __post_init__(self):
        if self.window <= 0 or self.slide <= 0:
            raise ValueError("window and slide must be positive")
        if self.slide > self.window:
            raise ValueError("slide must not exceed window")
