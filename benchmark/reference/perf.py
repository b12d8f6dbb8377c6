"""Rates and shares from counts and clocks, written out for the benchmark.

``updates_per_s`` is the arithmetic of ``pprx_torch/eval/perf.py``
(``summarize``: a slide of b edges is b insertions and b deletions);
``idle_share`` that of ``chip_smoke.py --turns`` (``event_slides``: device
time inside CUDA-event marks against the window's wall).
"""

from __future__ import annotations


def updates_per_s(slides: int, slide: int, wall_s: float) -> float:
    """Edge updates per second: 2 b per slide over the wall seconds."""
    return 2 * slide * slides / wall_s


def idle_share(busy_ms: float, wall_ms: float) -> float:
    """The share of the wall, in %, in which no marked work ran."""
    return 100.0 * (1.0 - busy_ms / wall_ms)
