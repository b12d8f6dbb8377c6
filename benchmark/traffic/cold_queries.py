"""Traffic kind ``cold_queries``: one client sends requests back to back,
each of ``sources`` new query vertices over a static graph; a request is a
cold dense push to eps (``push_to_convergence`` with the one held
``RoundGraphs``), then the top-k of every source copied to the host.

The graph (the configuration's N and edges) is drawn once on the device
from the configuration's ``graph_seed`` (``powerlaw.py``), and request i's
sources from it and i, without repeats; the run's seed relabels the vertices
of both, so that every seed gives the same work in another order. The
configuration's ``state`` and ``delivery`` have to be float32, the dense
engine's one precision. Between requests the one held state is reset in place
(``p`` to zero, ``r`` to the new sources' unit vectors): the captured loop
reads it where it lies. A request is timed from that reset until its ids
are on the host; the end-to-end metric is the window's seconds over the
requests it completed. Set-up warms one request.

The check takes the last request's state and ids, and ``check_sources``
columns of the state and ids of every ``check_every``-th request (from an
offset drawn from the seed), copied to the host after that request's clock
has stopped.
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness import Cell, Outcome
from benchmark.reference import checks, exact
from benchmark.traffic.powerlaw import powerlaw_edges

RELABEL, REQUESTS, CHECK_SOURCES = 1, 2, 3  # seed tags


def run(cell: Cell) -> Outcome:
    import torch

    from pprx_torch.config import PprConfig
    from pprx_torch.engine import push
    from pprx_torch.engine.graphs import RoundGraphs
    from pprx_torch.engine.state import FORWARD, init_state
    from pprx_torch.graph.dynamic import WindowGraph, delivery_view
    from pprx_torch.retrieve import topk

    cfg, mix, par = cell.config, cell.traffic, cell.params
    n, m, s, alpha, k = cfg["n"], cfg["edges"], cfg["sources"], cfg["alpha"], mix["k"]
    dev = cell.device
    if (cfg["state"], cfg["delivery"]) != ("float32", "float32"):
        raise SystemExit(f"the dense engine runs float32 only, not {cfg['state']} state "
                         f"and {cfg['delivery']} delivery")
    # one graph and one sequence of requests for every seed, the vertices
    # relabeled by the seed: the same work in another order
    relabel = cell.rng(RELABEL).permutation(n)
    at = torch.from_numpy(relabel.astype(np.int32)).to(dev)
    src, dst = (at.index_select(0, e) for e in powerlaw_edges(
        n, m, cfg["graph_seed"], cfg["exponent"], dev))
    del at

    def sources(i: int) -> np.ndarray:
        return relabel[np.random.default_rng([cfg["graph_seed"], REQUESTS, i]).choice(
            n, size=s, replace=False)]

    pcfg = PprConfig(alpha=alpha, eps=cfg["eps"], max_rounds=cfg["max_rounds"])
    window = WindowGraph(src=src, dst=dst, deg=torch.bincount(src, minlength=n + 1).int())
    view = delivery_view(window, FORWARD)
    state = init_state(n, sources(0), mode=FORWARD, device=dev)
    graphs = RoundGraphs(n, 1, dev)
    lanes = torch.arange(s, device=dev)

    def request(q: np.ndarray):
        with cell.marks.span("reset"):
            at = torch.from_numpy(q).to(dev)
            state.p.zero_()
            state.r.zero_()
            state.r[at, lanes] = 1.0
        _, st = push.push_to_convergence(state, window, pcfg, graphs, view)
        with cell.marks.span("top-k"):
            _, ids = topk.topk_candidates(state.p, k)
        return st, ids.cpu().numpy().astype(np.int32)

    cell.note(f"graph of {m} edges drawn, its view sorted")
    request(sources(0))
    cell.note("one request warmed")

    rng = cell.rng(CHECK_SOURCES)
    cols = rng.choice(s, size=min(par["check_sources"], s), replace=False)
    at_cols = torch.from_numpy(cols).to(dev)
    offset = int(rng.integers(par["check_every"]))

    def keep(q, ids):
        """What the check judges of a request: its sampled sources, their
        columns of the state and their ids."""
        return (q[cols], state.p[:n, at_cols].cpu().numpy(), state.r[:n, at_cols].cpu().numpy(),
                ids[cols])

    req_ms, req_rounds, kept = [], [], []
    failed = 0
    deadline = cell.open_window([graphs]) + cell.seconds
    cell.marks.phase = "request"
    while True:
        q = sources(len(req_ms) + 1)
        t0 = time.perf_counter()
        st, ids = request(q)
        t1 = time.perf_counter()
        req_ms.append((t1 - t0) * 1e3)
        req_rounds.append(st.rounds)
        failed += st.rounds >= pcfg.max_rounds
        if t1 >= deadline:
            break
        if (len(req_ms) + offset) % par["check_every"] == 0:
            kept.append(keep(q, ids))
    cell.close_window()
    cell.note(f"window closed after {len(req_ms)} requests")
    kept.append(keep(q, ids))
    deg = exact.out_degree(src, n)
    fresh = checks.fresh(state.r[:n], deg, cfg["eps"])
    del state, graphs, window, view
    cell.free()
    cell.probe({"n": n, "s": s, "src": src, "dst": dst})

    # the plain reference, on the graph it drew itself
    asked = np.concatenate([c[0] for c in kept])
    p = np.concatenate([c[1] for c in kept], axis=1)
    r = np.concatenate([c[2] for c in kept], axis=1)
    ids = np.concatenate([c[3] for c in kept])
    pt = exact.transition_t(src, dst, n, dev)
    del src, dst
    found = {
        "inv_gap": checks.inv_gap(pt, p, r, asked, alpha),
        "fresh": max(fresh, checks.fresh(r, deg, cfg["eps"])),
        "topk_ties": checks.topk_ties(p.astype(np.float64), ids, k),
    }

    cell.note("reference checked")
    cell.record["requests"] = [{"ms": ms, "rounds": rd} for ms, rd in zip(req_ms, req_rounds)]
    return Outcome({"request_ms": cell.window_s * 1e3 / len(req_ms)}, len(req_ms), int(failed),
                   found)
