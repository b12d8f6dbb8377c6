"""Traffic kind ``stream``: a sliding window over the frozen power-law edge
stream, slid in a closed loop by ``FastStreamDriver`` (the wl2 engine), with
an optional read every ``read_every`` slides.

The mix (``benchmark/traffic/<traffic>.json``): ``slide`` (b, edges in and
out per slide), ``read_every`` (0: no reads), ``read_eps`` (a read refines
the whole state to it, the CLI ``serve`` event mode) and ``k`` (the top-k a
read copies to the host). The configuration gives N, the window W, the
sources S, alpha, eps, the stream's exponent and the precision of the state
and of the scan rounds' delivery (``state``, ``delivery``: float32, or
bfloat16 delivery, the program's ``bf16d``); ``rebuild_every`` is the
headline runner's rule, ``max(1, min(8, W // (6 b)))``.

The base stream, ``base_windows * W`` edges, is drawn once on the device from
the configuration's ``graph_seed`` (``powerlaw.py``) and its vertices
relabeled by a permutation drawn from the run's seed, so that every seed
gives the same work in another order; the sources are its vertices 0..S-1
(the headline runner's), relabeled alike. The driver slides over the base
stream repeated end to end, as long as the cell's file says
(``stream_headroom`` times ``edges_per_s`` times the window's seconds, past
the warm-up). Set-up warms every shape the window uses: the seed push,
``rebuild_every + 2`` slides (the first rebuild included) and, with reads,
one read. Each slide is timed from the call that hands its batch to the
driver until one device sync after it; each read from its refine until the
top-k ids are on the host. With reads the window ends on a read, so the
last read saw the state that the check compares; every ``check_every``-th
read is kept for the check too.
"""

from __future__ import annotations

import math
import time

import numpy as np

from benchmark.harness import Cell, Outcome, p95
from benchmark.reference import checks, exact, perf
from benchmark.traffic.powerlaw import powerlaw_edges

RELABEL, CHECK_READS = 1, 4  # seed tags


def run(cell: Cell) -> Outcome:
    import torch

    from pprx_torch.config import PprConfig, StreamConfig
    from pprx_torch.graph import fast_stream
    from pprx_torch.retrieve import topk

    cfg, mix, par = cell.config, cell.traffic, cell.params
    n, w, s, alpha = cfg["n"], cfg["window"], cfg["sources"], cfg["alpha"]
    b, k = mix["slide"], mix["k"]
    read_every = mix["read_every"]
    rebuild_every = max(1, min(8, w // (6 * b)))
    warm = rebuild_every + 2

    if cfg["state"] != "float32" or cfg["delivery"] not in ("float32", "bfloat16"):
        raise SystemExit(f"the fast driver runs a float32 state with float32 or bfloat16 "
                         f"delivery, not {cfg['state']} and {cfg['delivery']}")

    # one stream for every seed, its vertices relabeled by the seed: the same
    # work in another order (the sources are the headline's, vertices 0..S-1)
    relabel = torch.from_numpy(cell.rng(RELABEL).permutation(n).astype(np.int32)).to(cell.device)
    base = powerlaw_edges(n, round(cfg["base_windows"] * w), cfg["graph_seed"], cfg["exponent"],
                          cell.device)
    base_src, base_dst = (relabel.index_select(0, e).cpu().numpy() for e in base)
    sources = relabel[:s].cpu().numpy()
    del base, relabel
    cell.note(f"stream of {base_src.shape[0]} edges drawn")
    need = w + (warm + 1) * b + math.ceil(par["stream_headroom"] * par["edges_per_s"]
                                          * cell.seconds)
    src, dst = np.resize(base_src, need), np.resize(base_dst, need)
    pcfg = PprConfig(alpha=alpha, eps=cfg["eps"], max_rounds=cfg["max_rounds"])
    drv = fast_stream.FastStreamDriver(
        src, dst, n, sources.tolist(), pcfg, StreamConfig(window=w, slide=b),
        rebuild_every=rebuild_every, bf16d=cfg["delivery"] == "bfloat16", device=cell.device)
    del src, dst
    cell.note("driver built")

    def read():
        st = drv.refine(mix["read_eps"])
        with cell.marks.span("top-k"):
            _, ids = topk.topk_candidates(drv.state.p, k)
        return st, ids.cpu().numpy().astype(np.int32)

    drv.seed()
    done = sum(1 for _ in drv.run(warm))
    if done != warm:
        raise SystemExit(f"the stream holds fewer than {warm} warm-up slides")
    if read_every:
        read()
    cell.note(f"seeded and {warm} slides warmed")

    def keep(ids):
        """What the check judges of the state now: the slides done, ``p``,
        ``r`` and the read's ids (``None`` after a slide)."""
        return (done, drv.state.p[:n].to("cpu", copy=True).numpy(),
                drv.state.r[:n].to("cpu", copy=True).numpy(), ids)

    # reads the check takes besides the last: every check_every-th, from an
    # offset drawn from the seed, copied after the read's clock has stopped
    offset = int(cell.rng(CHECK_READS).integers(par.get("check_every", 1)))
    slide_ms, slide_rounds, read_ms, read_rounds, kept = [], [], [], [], []
    ids = None
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
        if read_every and len(slide_ms) % read_every == 0:
            cell.marks.phase = "read"
            t2 = time.perf_counter()
            st, ids = read()
            t1 = time.perf_counter()
            read_ms.append((t1 - t2) * 1e3)
            read_rounds.append(st.rounds)
            failed += st.rounds >= pcfg.max_rounds
            if t1 < deadline and (len(read_ms) + offset) % par["check_every"] == 0:
                kept.append(keep(ids))
        if t1 >= deadline and (not read_every or len(slide_ms) % read_every == 0):
            break
    cell.close_window()
    cell.note(f"window closed after {len(slide_ms)} slides and {len(read_ms)} reads")
    kept.append(keep(ids))
    del drv
    cell.free()

    win_src, win_dst = exact.window_edges(base_src, base_dst, w + b * done, w)
    cell.probe({"n": n, "s": s, "src": win_src, "dst": win_dst})

    # the plain reference, on each window it works out from the stream; every
    # source. An edge applied wrong leaves its gap in the invariant for good,
    # so the last state answers for every slide before it.
    dev = cell.device
    eps = mix["read_eps"] if read_every else cfg["eps"]
    found = {"inv_gap": 0.0, "fresh": 0.0}
    for at, p, r, read_ids in kept:
        wsrc, wdst = exact.window_edges(base_src, base_dst, w + b * at, w)
        found["inv_gap"] = max(found["inv_gap"], checks.inv_gap(
            exact.transition_t(wsrc, wdst, n, dev), p, r, sources, alpha))
        found["fresh"] = max(found["fresh"], checks.fresh(r, exact.out_degree(wsrc, n), eps))
        if read_ids is not None:
            found["topk_ties"] = max(found.get("topk_ties", 0.0),
                                     checks.topk_ties(p.astype(np.float64), read_ids, k))

    cell.note("reference checked")
    window_s = cell.window_s
    metrics = {"updates_per_s": perf.updates_per_s(len(slide_ms), b, window_s),
               "slide_p95_ms": p95(slide_ms)}
    if read_ms:
        metrics["read_p95_ms"] = p95(read_ms)
    cell.record.update(
        slides=[{"ms": m, "rounds": rd} for m, rd in zip(slide_ms, slide_rounds)],
        reads=[{"ms": m, "rounds": rd} for m, rd in zip(read_ms, read_rounds)])
    return Outcome(metrics, len(slide_ms) + len(read_ms), int(failed), found)
