"""The synthetic power-law graph, drawn on the device.

The distribution of ``pprx_torch/graph/io.py`` (``synthetic_powerlaw_stream``):
both endpoints of every edge drawn independently with popularity
rank^-exponent over a random permutation of the n vertices, a self-loop's
``dst`` drawn again, parallel edges kept. It is drawn here by a torch
generator on the run's device, by the inverse of the popularity's CDF, in
blocks: 10^8 edges take about a second on the card, where the port's numpy
draw takes minutes. The same seed on the same device gives the same edges.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25  # draws a call: bounds the float64 uniforms in flight


def powerlaw_edges(n: int, m: int, seed: int, exponent: float, device,
                   block: int = BLOCK) -> tuple[torch.Tensor, torch.Tensor]:
    """``m`` edges over ``n`` vertices, int32 ``src`` and ``dst`` on ``device``
    in stream order, no self-loops."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
    cdf = torch.arange(1, n + 1, dtype=torch.float64, device=dev).pow_(-exponent).cumsum_(0)
    cdf /= cdf[-1].item()
    perm = torch.randperm(n, generator=gen, device=dev).to(torch.int32)

    def draw(k: int) -> torch.Tensor:
        out = torch.empty(k, dtype=torch.int32, device=dev)
        for lo in range(0, k, block):
            u = torch.rand(min(block, k - lo), generator=gen, dtype=torch.float64, device=dev)
            rank = torch.searchsorted(cdf, u, right=True).clamp_(max=n - 1)
            out[lo:lo + u.shape[0]] = perm[rank]
        return out

    src, dst = draw(m), draw(m)
    bad = torch.nonzero(src == dst).squeeze(1)
    while bad.numel():
        dst[bad] = draw(bad.numel())
        bad = bad[src[bad] == dst[bad]]
    return src, dst
