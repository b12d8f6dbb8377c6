"""Throughput summary of a timed stream segment (own copy of
``pprx.eval.perf``: the same fields and keys, so a report means the same in
both packages).

Turns per-slide ``PushStats`` and a wall clock into edge updates/s and
edge pushes/s per chip.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PerfReport:
    wall_s: float
    steps: int
    edges_updated: float
    rounds: int
    pushes: float
    edge_pushes: float
    n_chips: int = 1
    wl_rounds: int = 0
    scans_cand: int = 0
    scans_fed: int = 0
    scans_liv: int = 0

    @property
    def updates_per_sec(self) -> float:
        return self.edges_updated / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def pushes_per_sec_per_chip(self) -> float:
        if self.wall_s <= 0 or self.n_chips <= 0:
            return 0.0
        return self.edge_pushes / self.wall_s / self.n_chips

    @property
    def steps_per_sec(self) -> float:
        return self.steps / self.wall_s if self.wall_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            **dataclasses.asdict(self),
            "updates_per_sec": self.updates_per_sec,
            "pushes_per_sec_per_chip": self.pushes_per_sec_per_chip,
            "steps_per_sec": self.steps_per_sec,
        }


def summarize(stats_list, wall_s: float, edges_per_step: int, n_chips: int = 1) -> PerfReport:
    """Aggregate per-step PushStats into one report. ``edges_per_step`` is
    insertions + deletions per slide (2b for a full window slide)."""
    def total(field):
        return sum(getattr(s, field, 0) for s in stats_list)

    n = len(stats_list)
    return PerfReport(
        wall_s=wall_s,
        steps=n,
        edges_updated=float(n * edges_per_step),
        rounds=int(total("rounds")),
        pushes=float(total("pushes")),
        edge_pushes=float(total("edge_pushes")),
        n_chips=n_chips,
        wl_rounds=int(total("wl_rounds")),
        scans_cand=int(total("scans_cand")),
        scans_fed=int(total("scans_fed")),
        scans_liv=int(total("scans_liv")),
    )
