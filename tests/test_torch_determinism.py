"""An audit of the port's floating-point scatters on every single-card path.

On the card ``index_add_`` and its kin add on atomics, so where two lanes
meet in one row their sum may differ from run to run in the last bits. Every
f32 sum where two lanes can meet goes through the segment sum K1 over keys
sorted by their row (``pprx_torch.engine.segsum``; on the CPU its plain
version, an ``index_add_`` of the sorted lanes). What is left are adds at
unique rows: a round's candidate or frontier rows, where padding lanes add
zeros and no two live lanes meet.

A ``TorchFunctionMode`` records every floating-point ``index_add_`` /
``index_add``, ``index_put_`` / ``index_put`` with ``accumulate=True``,
``scatter_add_`` / ``scatter_add``, ``scatter_reduce_`` with a sum or mean,
and ``put_`` with ``accumulate=True``, with its call site, over a seed and
two slides of each single-card path at a tiny size. Each call must be in
K1's plain version, or at one of the unique-row sites with the live lanes'
(a nonzero source row) indices unique. A planted scatter form of the sorted
delivery fails the audit.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest
import torch
from torch.overrides import TorchFunctionMode

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.dist.mesh import make_row_mesh
from pprx_torch.dist.stream import ShardedStreamDriver
from pprx_torch.engine import update, wl2
from pprx_torch.engine.state import FORWARD, REVERSE
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.hybrid_stream import HybridStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream
from pprx_torch.graph.stream import StreamDriver

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# K1's plain version: every call there sums lanes sorted by their row
K1_PLAIN = "pprx_torch/engine/segsum.py"
# the adds at unique rows, by (file, function): p's add and the residual
# removal at a round's candidate or frontier rows
UNIQUE_ROW_SITES = {
    ("pprx_torch/engine/wl2.py", "_compact_round"),
    ("pprx_torch/engine/sparse.py", "worklist_round"),
    ("pprx_torch/engine/sparse.py", "_sparse_scan_"),
    ("pprx_torch/dist/wl.py", "_expand"),
}
ACCUMULATING = {"index_add_", "index_add", "scatter_add_", "scatter_add"}


@dataclasses.dataclass
class Scatter:
    op: str
    file: str
    line: int
    function: str
    index: torch.Tensor | None  # the live lanes' rows (index_add only)


def _arg(args, kwargs, pos: int, name: str, default=None):
    return args[pos] if len(args) > pos else kwargs.get(name, default)


class ScatterAudit(TorchFunctionMode):
    """Records every floating-point scatter that sums (``calls``)."""

    def __init__(self):
        super().__init__()
        self.calls: list[Scatter] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        target = args[0] if args else None
        if isinstance(target, torch.Tensor) and target.is_floating_point():
            sums = name in ACCUMULATING
            if name in ("index_put_", "index_put"):
                sums = bool(_arg(args, kwargs, 3, "accumulate", False))
            elif name == "put_":
                sums = bool(_arg(args, kwargs, 3, "accumulate", False))
            elif name in ("scatter_reduce_", "scatter_reduce"):
                sums = _arg(args, kwargs, 4, "reduce") in ("sum", "mean")
            if sums:
                self.calls.append(self._record(name, args, kwargs, sys._getframe(1)))
        return func(*args, **kwargs)

    @staticmethod
    def _record(name, args, kwargs, frame) -> Scatter:
        index = None
        if name in ("index_add_", "index_add"):
            idx = _arg(args, kwargs, 2, "index")
            src = _arg(args, kwargs, 3, "source")
            live = src.ne(0).flatten(1).any(dim=1) if src.dim() > 1 else src.ne(0)
            index = idx[live].clone()
        path = os.path.relpath(frame.f_code.co_filename, ROOT).replace(os.sep, "/")
        return Scatter(name, path, frame.f_lineno, frame.f_code.co_name, index)


def violations(calls: list[Scatter]) -> list[str]:
    """The calls that may sum two lanes in one row outside K1."""
    bad = []
    for c in calls:
        if c.file == K1_PLAIN:
            continue
        at = f"{c.op} at {c.file}:{c.line} ({c.function})"
        if (c.file, c.function) not in UNIQUE_ROW_SITES or c.index is None:
            bad.append(f"{at}: not K1 and not a unique-row site")
        elif c.index.unique().numel() != c.index.numel():
            bad.append(f"{at}: live lanes meet in a row")
    return bad


N, W, B, S = 300, 1500, 100, 4
CFG = PprConfig(alpha=0.15, eps=1e-4, max_rounds=2000)
SCFG = StreamConfig(window=W, slide=B)
QUERIES = list(range(S))


@pytest.fixture(scope="module")
def stream():
    return synthetic_powerlaw_stream(N, W + 3 * B, seed=5)


def _fast(mode=FORWARD, bf16d=False):
    return lambda src, dst, n: FastStreamDriver(src, dst, n, QUERIES, CFG, SCFG, mode=mode,
                                                rebuild_every=4, bf16d=bf16d, device="cpu")


def _dense(mode):
    return lambda src, dst, n: StreamDriver(src, dst, n, QUERIES, CFG, SCFG, mode=mode,
                                            device="cpu")


def _hybrid(mode, worklist):
    return lambda src, dst, n: HybridStreamDriver(src, dst, n, QUERIES, CFG, SCFG, mode=mode,
                                                  worklist=worklist, device="cpu")


def _sharded(engine, mode):
    return lambda src, dst, n: ShardedStreamDriver(src, dst, n, QUERIES, CFG, SCFG,
                                                   make_row_mesh(1, 1), mode=mode,
                                                   engine=engine, device="cpu")


PATHS = {
    "fast_forward": _fast(),
    "fast_reverse": _fast(REVERSE),
    "fast_bf16": _fast(bf16d=True),
    "dense_forward": _dense(FORWARD),
    "dense_reverse": _dense(REVERSE),
    "hybrid_forward": _hybrid(FORWARD, True),
    "hybrid_reverse": _hybrid(REVERSE, True),
    "hybrid_no_worklist_forward": _hybrid(FORWARD, False),
    "hybrid_no_worklist_reverse": _hybrid(REVERSE, False),
    "sharded_wl_forward": _sharded("wl", FORWARD),
    "sharded_wl_reverse": _sharded("wl", REVERSE),
    "wlp_forward": _sharded("wlp", FORWARD),
    "wlp_reverse": _sharded("wlp", REVERSE),
    "sharded_dense_forward": _sharded("dense", FORWARD),
    "sharded_dense_reverse": _sharded("dense", REVERSE),
}


def audited(make, stream) -> list[Scatter]:
    """A seed and two slides of one path under the audit."""
    drv = make(*stream)
    with ScatterAudit() as audit:
        drv.seed()
        assert len(list(drv.run(2))) == 2
    return audit.calls


@pytest.mark.parametrize("path", PATHS)
def test_no_float_scatter_meets_outside_k1(path, stream):
    calls = audited(PATHS[path], stream)
    assert violations(calls) == []
    # the audit saw the path's sums: K1's plain version summed them
    assert any(c.file == K1_PLAIN for c in calls)


def _scatter_form(rin, keys, table, rows=None, row_scale=None, site="other"):
    """``segsum.sorted_deliver_``'s old unsorted form: one ``index_add_``
    of the lanes whose key lies in ``rin``'s rows."""
    live = keys < rin.shape[0]
    vals = table if rows is None else table[rows]
    if row_scale is not None:
        vals = vals * row_scale[keys.clamp(max=rin.shape[0] - 1)][:, None]
    rin.index_add_(0, keys[live], vals[live].to(rin.dtype))
    return torch.sort(keys, stable=True)[0]


@pytest.mark.parametrize("where", ["wl2_compact_round", "update_corrections"])
def test_planted_scatter_fails_the_audit(monkeypatch, stream, where):
    """The fast driver's compact rounds (``wl2.sorted_deliver_``) or the
    unsorted corrections (``update.sorted_deliver_``, the hybrid driver's)
    back on a colliding ``index_add_``: the audit names the call."""
    module, path = (wl2, "fast_forward") if where.startswith("wl2") else (update, "hybrid_forward")
    monkeypatch.setattr(module, "sorted_deliver_", _scatter_form)
    bad = violations(audited(PATHS[path], stream))
    assert bad and all("_scatter_form" in v for v in bad)


def test_colliding_live_lanes_at_a_unique_row_site_fail():
    """At a unique-row site two live lanes in one row fail; padding lanes
    that add zeros do not."""
    r = torch.zeros(5, 2)
    src = torch.tensor([[1.0, 0.0], [0.0, 0.0], [0.0, 0.0], [2.0, 1.0]])

    def _compact_round(index):  # named as the site in wl2.py
        with ScatterAudit() as audit:
            r.index_add_(0, index, src)
        for c in audit.calls:
            c.file = "pprx_torch/engine/wl2.py"
        return violations(audit.calls)

    assert _compact_round(torch.tensor([0, 4, 4, 2])) == []
    assert "live lanes meet" in _compact_round(torch.tensor([2, 4, 4, 2]))[0]
