"""The benchmark's harness: finds a cell's files by name, runs its traffic
kind once, reads its per-layer metrics and prints the result line.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``. Everything that
belongs to one cell, configuration, traffic mix or per-layer metric sits in a
file of its own, found by name:

- ``benchmark/workloads/<cell>.json``: the cell's run parameters (stream
  headroom, the sample the check draws) and the limits of ``correct``;
- ``benchmark/configs/<config>.json``: the deployment's sizes and guarantees;
- ``benchmark/traffic/<traffic>.json``: the mix, which names its ``kind``,
  and ``benchmark/traffic/<kind>.py``, the one generator of that kind;
- ``benchmark/metrics/<metric>.py``: a per-layer metric, a ``read(record)``
  that returns a number or ``None`` where it finds nothing to read, and an
  optional ``probe(cell, info)`` that measures after the window, in the
  traced run only.

A kind's ``run(cell)`` sets up, calls ``cell.open_window()``, drives the
program for ``cell.seconds``, calls ``cell.close_window()``, frees the
program's state, calls ``cell.probe(info)`` and returns an ``Outcome`` whose
``checks`` the plain reference computed. ``run_cell`` takes a ``device`` so
that the CPU tests can drive a tiny run; ``main`` refuses to run without a
card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pprx")  # top-level module names


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no file {path.relative_to(ROOT)} for {kind[:-1]} {name!r}")
    return json.loads(path.read_text())


def load_module(path: Path):
    """A module from its file, whatever its name holds (metric names hold
    dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def for_cell(entries: list[dict], cell: str) -> list[dict]:
    """The metrics of ``entries`` that ``cell`` reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in entries if cell in m.get("workloads", [cell])]


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def forbidden_modules() -> list[str]:
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class NoMarks:
    """What a kind calls when the run is not traced: nothing."""

    phase = ""

    def span(self, label: str):
        return contextlib.nullcontext()


class Marks:
    """CUDA events around every graph launch (``torch.cuda.CUDAGraph.replay``
    and ``LoopGraph.launch``, patched on their classes while installed) and
    around the harness's own eager device work (``span``). Each mark keeps
    the phase the kind was in (``phase``: ``slide``, ``read``, ``request``).
    The arithmetic is ``chip_smoke.py --turns``' (``event_slides``): device
    time inside the marks against the window's wall."""

    def __init__(self):
        import torch

        from pprx_torch.engine import loop

        self.torch = torch
        self.targets = [(torch.cuda.CUDAGraph, "replay", "replay"),
                        (loop.LoopGraph, "launch", "loop")]
        self.rows: list[tuple[Any, str, str, Any, Any]] = []
        self.phase = "window"
        self.saved: list[tuple[type, str, Callable]] = []
        self.start = self.end = None

    def _event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def install(self) -> None:
        for cls, name, kind in self.targets:
            fn = getattr(cls, name)
            self.saved.append((cls, name, fn))

            def timed(obj, *args, _fn=fn, _kind=kind, **kw):
                start = self._event()
                out = _fn(obj, *args, **kw)
                self.rows.append((obj, _kind, self.phase, start, self._event()))
                return out

            setattr(cls, name, timed)
        self.start = self._event()

    def remove(self) -> None:
        self.end = self._event()
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)
        self.saved = []

    @contextlib.contextmanager
    def span(self, label: str):
        start = self._event()
        yield
        self.rows.append((label, "eager", self.phase, start, self._event()))

    def resolve(self, round_graphs: list) -> list[dict]:
        """Each mark's device ms, the device's idle ms before it, and a
        label from the graph's key in its ``RoundGraphs`` (call after a
        sync)."""
        names = {}
        for rg in round_graphs:
            names.update({id(v[0]): key_label("loop", k[0]) for k, v in rg.loops.items()})
            names.update({id(v[0]): key_label("replay", k) for k, v in rg.graphs.items()})
        out, prev = [], self.start
        for obj, kind, phase, start, end in self.rows:
            label = obj if kind == "eager" else names.get(id(obj), kind)
            out.append({"label": label, "kind": kind, "phase": phase,
                        "ms": start.elapsed_time(end), "gap_ms": prev.elapsed_time(start)})
            prev = end
        out.append({"label": "window end", "kind": "end", "phase": "", "ms": 0.0,
                    "gap_ms": prev.elapsed_time(self.end)})
        return out


def key_label(kind: str, key) -> str:
    """A captured step's key as a short name: its words and its eps."""
    if key is None:
        return kind
    words = [x for x in key if isinstance(x, str)]
    eps = next((x for x in key if isinstance(x, float)), None)
    return " ".join([kind, *words] + ([f"eps={eps:g}"] if eps is not None else []))


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back: the end-to-end values it measured, the
    window's operations and the compared numbers (the traced record stays
    in ``Cell.record``)."""

    metrics: dict[str, float]
    attempted: int
    failed: int
    checks: dict[str, float]


class Cell:
    """One run of one cell: its files, the run's arguments, and the hooks a
    kind calls around its window."""

    def __init__(self, name: str, seed: int, seconds: float, trace: bool, device,
                 t_start: float, overrides: dict | None = None):
        import torch

        self.torch = torch
        self.name = name
        self.bench = manifest()
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"BENCHMARK.json has no workload {name!r}")
        self.entry = entry
        self.params = load_json("workloads", name)
        for key in ("config", "traffic", "chips"):
            if self.params[key] != entry[key]:
                raise SystemExit(f"benchmark/workloads/{name}.json: {key} "
                                 f"{self.params[key]!r} is not BENCHMARK.json's {entry[key]!r}")
        overrides = overrides or {}
        self.config = {**load_json("configs", entry["config"]), **overrides.get("config", {})}
        self.traffic = {**load_json("traffic", entry["traffic"]), **overrides.get("traffic", {})}
        self.params.update(overrides.get("params", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = t_start
        self.marks = NoMarks()
        self.round_graphs: list = []
        self.record: dict = {}
        self.setup_s = self.window_s = None
        self.peak_bytes = 0
        self.t_open = None
        self.per_layer = for_cell(self.bench["per_layer"], name)

    def note(self, what: str) -> None:
        """A line on standard error: the seconds since the run's start and
        what the run has done."""
        print(f"{time.perf_counter() - self.t_start:8.2f} s  {what}", file=sys.stderr, flush=True)

    def rng(self, *tags: int) -> np.random.Generator:
        """A generator of the run's seed (any whole number) and fixed tags,
        so that each use draws its own sequence."""
        return np.random.default_rng([self.seed % (1 << 64), *tags])

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def open_window(self, round_graphs: list) -> float:
        """Set-up ends: every shape is warm. Returns the window's start on
        the host clock."""
        self.sync()
        self.round_graphs = round_graphs
        if self.cuda:
            self.peak_bytes = self.torch.cuda.max_memory_allocated(self.device)
            self.torch.cuda.reset_peak_memory_stats(self.device)
            if self.trace:
                self.marks = Marks()
                self.marks.install()
        gc.collect()
        gc.disable()  # no collector pauses inside the window
        self.t_open = time.perf_counter()
        self.setup_s = self.t_open - self.t_start
        return self.t_open

    def close_window(self) -> None:
        """The last operation of the window has completed."""
        self.sync()
        self.window_s = time.perf_counter() - self.t_open
        gc.enable()
        if isinstance(self.marks, Marks):
            self.marks.remove()
            self.sync()
            self.record["marks"] = self.marks.resolve(self.round_graphs)
            self.marks = NoMarks()
        self.record["window_s"] = self.window_s
        if self.cuda:
            window_peak = self.torch.cuda.max_memory_allocated(self.device)
            self.record["peak_bytes_window"] = window_peak
            self.peak_bytes = max(self.peak_bytes, window_peak)

    def free(self) -> None:
        """After the kind has dropped the program's state."""
        self.round_graphs = []
        gc.collect()
        if self.cuda:
            self.torch.cuda.empty_cache()

    def probe(self, info: dict) -> None:
        """Each per-layer metric's ``probe`` (traced runs on a card only)."""
        if not (self.trace and self.cuda):
            return
        for m in self.per_layer:
            mod = metric_module(m["name"])
            if hasattr(mod, "probe"):
                self.record.update(mod.probe(self, info) or {})
                self.free()


def metric_module(name: str):
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"no file {path.relative_to(ROOT)} for per-layer metric {name!r}")
    return load_module(path)


def kind_module(kind: str):
    path = HERE / "traffic" / f"{kind}.py"
    if not path.is_file():
        raise SystemExit(f"no file {path.relative_to(ROOT)} for traffic kind {kind!r}")
    return load_module(path)


def breakdown(marks: list[dict]) -> dict:
    """Device seconds by graph or span label, and the device's idle seconds
    by what the host was doing before the next launch: the ten largest of
    each."""
    ops: dict[str, float] = {}
    gaps: dict[str, float] = {}
    for row in marks:
        if row["kind"] != "end":
            ops[row["label"]] = ops.get(row["label"], 0.0) + row["ms"] / 1e3
        name = f"{row['phase']}: before {row['label']}" if row["phase"] else "after the last launch"
        gaps[name] = gaps.get(name, 0.0) + row["gap_ms"] / 1e3
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: float | None = None,
             overrides: dict | None = None) -> tuple[dict, list[str]]:
    """One run of cell ``name``: the result line's object, and the lines
    that end standard error (each compared number beside its limit)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, seed, seconds, trace, device, t_start, overrides)
    torch = cell.torch
    out: Outcome = kind_module(cell.traffic["kind"]).run(cell)

    limits = cell.params["limits"]
    checks = {k: {"value": out.checks.get(k), "limit": limits.get(k)}
              for k in dict.fromkeys([*limits, *out.checks])}
    correct = all(v["value"] is not None and v["limit"] is not None
                  and math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_module(m["name"]).read(cell.record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {**out.metrics, "setup_s": cell.setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in for_cell(cell.bench["end_to_end"], name)}
    device_info = {
        "platform": "gpu" if cell.cuda else "cpu",
        "kind": torch.cuda.get_device_name(cell.device) if cell.cuda else "cpu",
        "count": cell.entry["chips"],
        "memory_peak_bytes": cell.peak_bytes,
    }
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": device_info}
    if trace and "marks" in cell.record:
        busy_s = sum(r["ms"] for r in cell.record["marks"]) / 1e3
        device_info.update(busy_s=busy_s, window_s=cell.window_s)
        result["breakdown"] = breakdown(cell.record["marks"])
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return result, lines


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    entry = next((w for w in manifest()["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"BENCHMARK.json has no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", t_start)
    found = forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
