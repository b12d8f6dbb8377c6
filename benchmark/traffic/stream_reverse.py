"""Traffic kind ``stream_reverse``: the sliding window of kind ``stream``
(``stream.py``), its driver in reverse mode, BASELINE config 3: for each
of the configuration's ``targets`` t, ``FastStreamDriver(mode=REVERSE)``
keeps pi_s(t) for every vertex s (who sends mass to t) eps-fresh, ``|r|
<= eps`` at every vertex, as the window slides in a closed loop.

The mix (``benchmark/traffic/<traffic>.json``): ``slide`` (b, edges in and
out a slide); ``read_every`` must be 0 (this kind runs no reads), and
``read_eps`` and ``k`` are not read. The configuration gives N, the window
W, the targets S, alpha, eps, the stream's exponent and seed, and the
precision of the state and of the scan rounds' delivery (``state``,
``delivery``: float32, or bfloat16 delivery, the program's ``bf16d``);
``rebuild_every`` is the headline runner's rule, ``max(1, min(8, W // (6
b)))``.

The stream is kind ``stream``'s: the base stream drawn on the device from
``graph_seed``, its vertices relabeled by a permutation drawn from the
run's seed (the same tag, so a seed gives both kinds the same labels), the
targets its vertices 0..S-1, relabeled alike, the whole repeated end to end
as long as the cell's file says. Set-up warms the seed push and ``rebuild_every
+ 2`` slides, the first rebuild included. Each slide is timed from the call
that hands its batch to the driver until one device sync after it.

The check (``benchmark/reference/reverse.py``) judges the last state, every
target, and every ``check_every``-th slide's state of the window (from an
offset drawn from the seed), ``check_targets`` columns drawn from the seed,
copied on the card after the slide's clock has stopped and to the host
after the window; each on the window it works out from the stream and the
count of slides.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.harness import Cell, Outcome, p95
from benchmark.reference import exact, perf, reverse
from benchmark.traffic.powerlaw import powerlaw_edges

RELABEL, CHECK_SLIDES, CHECK_TARGETS = 1, 5, 6  # seed tags; RELABEL is kind stream's


def run(cell: Cell) -> Outcome:
    import torch

    from pprx_torch.config import PprConfig, StreamConfig
    from pprx_torch.engine.state import REVERSE
    from pprx_torch.graph import fast_stream

    cfg, mix, par = cell.config, cell.traffic, cell.params
    n, w, s, alpha = cfg["n"], cfg["window"], cfg["targets"], cfg["alpha"]
    b = mix["slide"]
    rebuild_every = max(1, min(8, w // (6 * b)))
    warm = rebuild_every + 2

    if cfg["mode"] != "reverse" or mix["read_every"]:
        raise SystemExit(f"kind stream_reverse runs reverse mode without reads, not mode "
                         f"{cfg['mode']!r} with read_every {mix['read_every']!r}")
    if cfg["state"] != "float32" or cfg["delivery"] not in ("float32", "bfloat16"):
        raise SystemExit(f"the fast driver runs a float32 state with float32 or bfloat16 "
                         f"delivery, not {cfg['state']} and {cfg['delivery']}")

    relabel = torch.from_numpy(cell.rng(RELABEL).permutation(n).astype(np.int32)).to(cell.device)
    base = powerlaw_edges(n, round(cfg["base_windows"] * w), cfg["graph_seed"], cfg["exponent"],
                          cell.device)
    base_src, base_dst = (relabel.index_select(0, e).cpu().numpy() for e in base)
    targets = relabel[:s].cpu().numpy()
    del base, relabel
    cell.note(f"stream of {base_src.shape[0]} edges drawn")
    need = w + (warm + 1) * b + math.ceil(par["stream_headroom"] * par["edges_per_s"]
                                          * cell.seconds)
    src, dst = np.resize(base_src, need), np.resize(base_dst, need)
    pcfg = PprConfig(alpha=alpha, eps=cfg["eps"], max_rounds=cfg["max_rounds"])
    drv = fast_stream.FastStreamDriver(
        src, dst, n, targets.tolist(), pcfg, StreamConfig(window=w, slide=b), mode=REVERSE,
        rebuild_every=rebuild_every, bf16d=cfg["delivery"] == "bfloat16", device=cell.device)
    del src, dst
    cell.note("driver built")

    drv.seed()
    done = sum(1 for _ in drv.run(warm))
    if done != warm:
        raise SystemExit(f"the stream holds fewer than {warm} warm-up slides")
    cell.note(f"seeded and {warm} slides warmed")

    every = par["check_every"]
    offset = int(cell.rng(CHECK_SLIDES).integers(every))
    cols = np.sort(cell.rng(CHECK_TARGETS).choice(s, min(par["check_targets"], s), replace=False))
    cols_t = torch.as_tensor(cols, device=cell.device)

    def keep(judged):
        """What the check judges of the state now: the slides done, the
        judged columns of ``p`` and ``r`` (``None``: every column, copied
        to the host; else copies on the device, which take no host time
        in the window), and those columns' indices."""
        p, r = drv.state.p[:n], drv.state.r[:n]
        if judged is None:
            return done, p.to("cpu", copy=True), r.to("cpu", copy=True), np.arange(s)
        return done, p.index_select(1, cols_t), r.index_select(1, cols_t), judged

    slide_ms, slide_rounds, kept = [], [], []
    failed = 0
    deadline = cell.open_window([drv.round_graphs]) + cell.seconds
    while True:
        if drv.steps_available < 1:
            raise SystemExit(f"the stream ran out after {len(slide_ms)} slides of the window: "
                             f"raise stream_headroom in benchmark/workloads/{cell.name}.json")
        cell.marks.phase = "slide"
        t0 = time.perf_counter()
        stats = next(drv.run(1))
        cell.sync()
        t1 = time.perf_counter()
        slide_ms.append((t1 - t0) * 1e3)
        slide_rounds.append(stats.rounds)
        failed += stats.rounds >= pcfg.max_rounds
        done += 1
        if t1 >= deadline:
            break
        if (len(slide_ms) + offset) % every == 0:
            kept.append(keep(cols))
    cell.close_window()
    cell.note(f"window closed after {len(slide_ms)} slides")
    kept = [(at, p.cpu(), r.cpu(), judged) for at, p, r, judged in kept] + [keep(None)]
    del drv
    cell.free()

    win_src, win_dst = exact.window_edges(base_src, base_dst, w + b * done, w)
    cell.probe({"n": n, "s": s, "src": win_src, "dst": win_dst})

    # the plain reference, on each window it works out from the stream. An
    # edge applied wrong leaves its gap in the invariant for good, so the
    # last state answers for every slide before it.
    found = {"inv_gap": 0.0, "fresh": 0.0}
    for at, p, r, judged in kept:
        wsrc, wdst = exact.window_edges(base_src, base_dst, w + b * at, w)
        gap = reverse.inv_gap_reverse(reverse.transition(wsrc, wdst, n, cell.device), p, r,
                                      targets[judged], alpha)
        fresh = reverse.fresh_reverse(r, n, cfg["eps"])
        cell.note(f"after {at} slides, {len(judged)} targets: inv_gap {gap!r}, fresh {fresh!r}")
        found["inv_gap"] = max(found["inv_gap"], gap)
        found["fresh"] = max(found["fresh"], fresh)

    cell.note("reference checked")
    metrics = {"updates_per_s": perf.updates_per_s(len(slide_ms), b, cell.window_s),
               "slide_p95_ms": p95(slide_ms)}
    cell.record["slides"] = [{"ms": m, "rounds": rd} for m, rd in zip(slide_ms, slide_rounds)]
    return Outcome(metrics, len(slide_ms), int(failed), found)
