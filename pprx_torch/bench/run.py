"""The milestone configs 1-4 as scripted runs (port of ``pprx.bench.run``).

Each config runs on the synthetic power-law stand-in for its dataset (the
same stream as the reference's for the same seed), with the reference's
arguments, and returns the reference's keys plus ``"device"``: the card's
name, or ``"cpu"``. ``device=None`` is the card. ``graph=`` runs a config
on a packed edge file instead (``pprx_torch.graph.io.load_packed``; the
``convert`` subcommand writes one). Config 5 runs the sharded engines on
this process's shard of the mesh (``pprx_torch.dist``): a mesh of one on
one card, or one process per shard started by ``torchrun``.

Configs 1 and 4 push on the dense engine: on the card its loop is one
conditional CUDA graph (``pprx_torch.engine.push``), captured inside the
timed push, as the reference's jit compile is inside its timing.
``graphs=`` (not in the reference) hands them the ``RoundGraphs`` to push
through, whose ``summary()`` the caller reads afterwards.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.device import device_name, resolve_device
from pprx_torch.engine.graphs import RoundGraphs
from pprx_torch.engine.push import push_to_convergence
from pprx_torch.engine.state import FORWARD, REVERSE, init_state
from pprx_torch.eval.metrics import l1_error
from pprx_torch.eval.perf import summarize
from pprx_torch.graph.dynamic import WindowGraph
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.io import load_packed, synthetic_powerlaw_stream
from pprx_torch.ref.exact import exact_ppr
from pprx_torch.retrieve.topk import topk_candidates
from pprx_torch.sync import sync


def _stream(graph: str | None, n: int, need: int, seed: int):
    """Edge stream for a config: the packed ``.npz`` ``graph`` (``n`` from
    the file) where one is given, else the synthetic power-law stand-in. A
    file shorter than the ``need`` edges the config slides over is tiled
    cyclically (the window stays exact; edges repeat). Returns (src, dst,
    n)."""
    if graph is None:
        return synthetic_powerlaw_stream(n, need, seed=seed)
    src, dst, n_file = load_packed(graph)
    if src.shape[0] < need:
        reps = -(-need // src.shape[0])
        src, dst = np.tile(src, reps), np.tile(dst, reps)
    return src[:need], dst[:need], n_file


def config1_static_forward(scale: int = 1, check_exact: bool = True,
                           graph: str | None = None,
                           device: torch.device | str | None = None,
                           graphs: RoundGraphs | None = None) -> dict:
    """Single-source forward push on a static wiki-Vote-like graph, accuracy
    against exact PPR (f64 power iteration on the same device)."""
    device = resolve_device(device)
    n, m = 1000 * scale, 100_000 * scale
    src, dst, n = _stream(graph, n, m, seed=1)
    m = src.shape[0]
    cfg = PprConfig(alpha=0.15, eps=1e-6)
    window = WindowGraph.from_coo(src, dst, n, device=device)
    queries = [0]
    state = init_state(n, queries, mode=FORWARD, device=device)
    sync(device)
    t0 = time.perf_counter()
    state, stats = push_to_convergence(state, window, cfg, graphs)
    sync(device)
    out = {
        "config": 1,
        "n": n,
        "edges": m,
        "rounds": stats.rounds,
        "wall_s": round(time.perf_counter() - t0, 4),
        "l1_bound": cfg.eps * m,
        "device": device_name(device),
    }
    if check_exact and n <= 4000:
        pis = exact_ppr(src, dst, n, queries, cfg.alpha, device=device)
        p_host = state.p.cpu().double().numpy()
        out["l1_error"] = [l1_error(p_host[:n, j], pi) for j, pi in enumerate(pis)]
        out["within_bound"] = all(e < out["l1_bound"] for e in out["l1_error"])
    return out


def _timed_stream(drv: FastStreamDriver, warm: int, steps: int) -> dict:
    """Seed, warm up past the first snapshot rebuild, then time ``steps``
    slides (host clock between device syncs)."""
    drv.seed()
    for _ in drv.run(warm):
        pass
    sync(drv.device)
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    sync(drv.device)
    wall = time.perf_counter() - t0
    return summarize(stats, wall, edges_per_step=2 * drv.scfg.slide).as_dict()


def config2_sliding_window(scale: int = 1, graph: str | None = None,
                           w: int = 0, b: int = 0, steps: int = 10,
                           device: torch.device | str | None = None) -> dict:
    """Incremental PPR under sliding-window batches (soc-LiveJournal-like)."""
    device = resolve_device(device)
    n = 200_000 * scale
    w = w or 2_000_000 * scale
    b = b or 20_000 * scale
    rebuild_every = max(1, min(8, w // (6 * b)))
    warm = rebuild_every + 2  # past the first snapshot rebuild
    src, dst, n = _stream(graph, n, w + (steps + warm + 1) * b, seed=2)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    drv = FastStreamDriver(
        src, dst, n, list(range(16)), cfg, StreamConfig(window=w, slide=b),
        rebuild_every=rebuild_every, device=device,
    )
    rep = _timed_stream(drv, warm, steps)
    return {"config": 2, "n": n, "window": w, "slide": b, **rep,
            "device": device_name(device)}


def config3_reverse_dynamic(scale: int = 1, graph: str | None = None,
                            w: int = 0, b: int = 0, steps: int = 10,
                            s: int = 8,
                            device: torch.device | str | None = None) -> dict:
    """Reverse-push contribution vectors maintained under the stream; ``s``
    co-batches that many reverse targets in one engine."""
    device = resolve_device(device)
    n = 100_000 * scale
    w = w or 1_000_000 * scale
    b = b or 10_000 * scale
    rebuild_every = max(1, min(8, w // (6 * b)))
    warm = rebuild_every + 2
    src, dst, n = _stream(graph, n, w + (steps + warm + 1) * b, seed=3)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    drv = FastStreamDriver(
        src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b),
        mode=REVERSE, rebuild_every=rebuild_every, device=device,
    )
    rep = _timed_stream(drv, warm, steps)
    return {"config": 3, "n": n, "window": w, "slide": b, "sources": s, **rep,
            "device": device_name(device)}


def config4_retrieval(scale: int = 1, s: int = 512, k: int = 100,
                      graph: str | None = None,
                      device: torch.device | str | None = None,
                      check_exact: int = 0, graphs: RoundGraphs | None = None) -> dict:
    """Multi-source batched retrieval: a cold dense push of S sources, then
    the top-k read from the converged reserve. ``check_exact`` (not in the
    reference) holds that many evenly spaced sources of the pushed state to
    exact PPR (f64 power iteration on the same device): the push keeps
    ``pi_s = p + r M`` and the rows of M sum to 1, so a source's L1 error is
    at most its residual's L1 norm, and ``p`` and ``r`` sum to 1. Both are
    allowed 1e-4 for the state's f32 roundings."""
    device = resolve_device(device)
    n, m = 500_000 * scale, 5_000_000 * scale
    src, dst, n = _stream(graph, n, m, seed=4)
    m = src.shape[0]
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    rng = np.random.default_rng(0)
    queries = rng.integers(0, n, size=s).tolist()
    window = WindowGraph.from_coo(src, dst, n, device=device)
    state = init_state(n, queries, mode=FORWARD, device=device)
    sync(device)
    t0 = time.perf_counter()
    state, stats = push_to_convergence(state, window, cfg, graphs)
    sync(device)
    cold_s = time.perf_counter() - t0

    def lat(exact: bool) -> float:
        topk_candidates(state.p, k=k, exact=exact)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(20):
            topk_candidates(state.p, k=k, exact=exact)
        sync(device)
        return (time.perf_counter() - t0) / 20 * 1e3

    out = {
        "config": 4,
        "n": n,
        "edges": m,
        "batch": s,
        "k": k,
        "cold_push_s": round(cold_s, 3),
        "push_rounds": stats.rounds,
        "retrieval_ms_exact": round(lat(True), 3),
        # torch has no approximate top-k: this is the exact head's time again
        "retrieval_ms_approx": round(lat(False), 3),
        "device": device_name(device),
    }
    if check_exact:
        cols = np.unique(np.linspace(0, s - 1, min(check_exact, s)).astype(int))
        pis = exact_ppr(src, dst, n, [queries[j] for j in cols], cfg.alpha, tol=1e-10,
                        device=device)
        at = torch.from_numpy(cols).to(device)
        p_host = state.p[:n, at].double().cpu().numpy()
        r_host = state.r[:n, at].double().cpu().numpy()
        out["l1_error"] = [l1_error(p_host[:, j], pi) for j, pi in enumerate(pis)]
        out["residual_l1"] = np.abs(r_host).sum(0).tolist()
        out["mass_error"] = np.abs(p_host.sum(0) + r_host.sum(0) - 1.0).tolist()
        out["within_bound"] = (
            all(e <= rl + 1e-4 for e, rl in zip(out["l1_error"], out["residual_l1"]))
            and max(out["residual_l1"]) <= cfg.eps * m
            and max(out["mass_error"]) <= 1e-4
        )
    return out


def config5_run(
    n_rows: int = 0,
    n_srcs: int = 1,
    engine: str = "wl",
    n: int = 0,
    w: int = 0,
    b: int = 0,
    s: int = 0,
    steps: int = 5,
    graph: str | None = None,
    scale: int = 1,
    ccap: int = 0,
    e_top: int = 0,
    fring: int = 0,
    bf16d: bool = False,
    mode: str = "forward",
    device: torch.device | str | None = None,
    extra_slides: int = 0,
):
    """Config 5 (``config5_sharded``) and the driver it ran, for callers that
    go on to check the state: (report, driver). The driver has one slide of
    stream left, and ``extra_slides`` more that repeat the stream's first
    edges (the run's own slides are config 5's whatever their number)."""
    from pprx_torch.dist.mesh import make_row_mesh
    from pprx_torch.dist.stream import ShardedStreamDriver

    device = resolve_device(device)
    if n_rows == 0:
        world = dist.get_world_size() if dist.is_initialized() else 1
        n_rows = max(1, world // n_srcs)
    mesh = make_row_mesh(n_rows, n_srcs)
    n = n or 200_000 * scale
    w = w or 2_000_000 * scale
    b = b or 160_000 * scale
    s = s or 128
    src, dst, n = _stream(graph, n, w + (steps + 4) * b, seed=5)
    spare = extra_slides * b
    src, dst = np.concatenate([src, src[:spare]]), np.concatenate([dst, dst[:spare]])
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    chips = n_rows * n_srcs
    # ccap/e_top tuning lives in ShardedWlEngine's defaults
    drv = ShardedStreamDriver(
        src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b), mesh,
        mode=REVERSE if mode == "reverse" else FORWARD, engine=engine, ccap=ccap or None,
        e_top=e_top or None, fring=fring or None, bf16d=bf16d, device=device,
    )
    drv.seed()
    for _ in drv.run(3):
        pass
    sync(device)
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    sync(device)
    wall = time.perf_counter() - t0
    return {
        "config": 5,
        "mesh": f"{n_rows}x{n_srcs}",
        "engine": engine,
        "mode": mode,
        "n": n,
        "window": w,
        "slide": b,
        "sources": s,
        "steps": steps,
        "wall_s": round(wall, 4),
        "updates_per_sec": round(2 * b * steps / wall, 1),
        "updates_per_sec_per_chip": round(2 * b * steps / wall / chips, 1),
        "rounds": sum(st["rounds"] for st in stats),
        "wl_rounds": sum(st.get("wl_rounds", 0) for st in stats),
        "device": device_name(device),
    }, drv


def config5_sharded(**kw) -> dict:
    """The row-sharded slide step at the headline shapes (N=200k, W=2M,
    b=160k, S=128; stream seed 5): seed, 3 warm-up and ``steps`` timed
    slides on this process's shard. ``n_rows=0`` is the world's size (one
    shard per process; 1 without a process group). Engines: 'wl' (the
    default, compact-frontier rounds), 'wlp' (its memory-proportional
    carry and drain rounds) and 'dense' (reduce-scatter rounds); ``mode``
    'forward' or 'reverse'. Pass small n/w/b/s for a CPU run."""
    return config5_run(**kw)[0]


CONFIGS = {
    1: config1_static_forward,
    2: config2_sliding_window,
    3: config3_reverse_dynamic,
    4: config4_retrieval,
    5: config5_sharded,
}


def run_config(idx: int, **kw) -> dict:
    return CONFIGS[idx](**kw)
