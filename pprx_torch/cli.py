"""Command line of the port (counterpart of ``pprx.cli``):

    python -m pprx_torch.cli <subcommand> ...      (console script: pprx-torch)

  convert   edge-list text -> packed .npz stream (renumbered)
  static    forward/reverse push on a static graph, accuracy and timing
  stream    sliding-window maintenance, one JSONL record per slide
  retrieve  multi-source batched top-k candidates
  serve     bounded-stall serving loop: maintain, refine within a budget of
            rounds each slide, and read the top-k every few slides
  bench     the headline updates/s benchmark, or one of configs 1-5

The subcommands, flags and JSON keys are the reference's. Every subcommand
that computes takes ``--device`` (default: the card; ``cpu`` runs the plain
versions, as the tests do) and names it under ``"device"`` in its summary.
``stream --engine sharded|sharded-wl|sharded-wlp`` and ``bench --config 5``
run one shard per process (``pprx_torch.dist``): a ``--mesh 1,1`` in one
process, or one process per shard, started by torchrun or given
``--coordinator``, ``--num-processes`` and ``--process-id``; only rank 0
prints, and ``--checkpoint`` writes the reference's sharded file. As in the
reference, ``retrieve --from-checkpoint`` refuses a sharded file.

The fast engine delivers through the segment-sum kernel, which takes f32
or bf16, and the dense engine (``static``, a cold ``retrieve``, ``stream
--engine dense``), the hybrid engine's dense scan and the sharded dense
engine in a world of one shard run their rounds on the segment sum and the
row passes, which take f32: ``--f64`` with any of them on a CUDA device
exits before any work. On the CPU every engine runs in f64 too, and so
does the sharded dense engine across several shards, whose rounds run
plain torch ops.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SHARDED_ENGINES = ("sharded", "sharded-wl", "sharded-wlp")


def _add_common(p):
    p.add_argument("--alpha", type=float, default=0.15)
    p.add_argument("--eps", type=float, default=1e-6)
    p.add_argument("--max-rounds", type=int, default=10_000)
    p.add_argument("--mode", choices=["fwd", "rev"], default="fwd")
    p.add_argument("--queries", type=str, default="0", help="comma-separated query vertex ids")
    p.add_argument("--f64", action="store_true", help="float64 state (CPU/testing)")
    _add_device(p)


def _add_device(p):
    p.add_argument("--device", type=str, default=None,
                   help="torch device to run on (default: the first CUDA card)")


def _device(args) -> torch.device:
    from pprx_torch.device import resolve_device

    return resolve_device(args.device)


def _load(args):
    from pprx_torch.graph.io import load_edge_list, load_packed

    if args.graph.endswith(".npz"):
        return load_packed(args.graph)
    return load_edge_list(args.graph)


def _queries(args, n: int) -> list[int]:
    """``--queries`` as vertex ids, each checked against ``[0, n)``: id n is
    the phantom row, which must stay zero, and ids past it do not exist."""
    queries = [int(q) for q in args.queries.split(",")]
    for q in queries:
        if not 0 <= q < n:
            raise SystemExit(f"--queries: vertex id {q} is outside [0, n) for n = {n}")
    return queries


def _cfg(args):
    from pprx_torch.config import PprConfig

    return PprConfig(alpha=args.alpha, eps=args.eps, max_rounds=args.max_rounds)


def _mode(args) -> int:
    from pprx_torch.engine.state import FORWARD, REVERSE

    return FORWARD if args.mode == "fwd" else REVERSE


def _dtype(args) -> torch.dtype:
    return torch.float64 if args.f64 else torch.float32


# what each engine's kernels take on a card
_KERNEL_TYPES = {
    "fast": "the fast engine's segment-sum kernel takes f32 or bf16 only",
    "dense": "the dense engine's kernels (the segment sum, the row pass) take f32 only",
    "hybrid": "the hybrid engine's kernels (the segment sum, the row passes) take f32 only",
    "sharded": "the sharded dense engine's kernels in a world of one shard (the segment sum, "
               "the row pass) take f32 only",
}


def _kernel_dtype(args, device: torch.device, what: str, engine: str = "fast") -> None:
    """Exit before any work where an engine would meet a dtype its kernels
    do not take."""
    if args.f64 and device.type == "cuda":
        raise SystemExit(f"{what}: --f64 on {device}: {_KERNEL_TYPES[engine]}; drop --f64, "
                         "or run on --device cpu")


def _device_key(device: torch.device) -> dict:
    from pprx_torch.device import device_name

    return {"device": device_name(device)}


def cmd_convert(args):
    from pprx_torch.graph.io import load_edge_list, save_packed

    src, dst, n = load_edge_list(args.graph)
    save_packed(args.out, src, dst, n)
    print(json.dumps({"n": n, "edges": int(src.shape[0]), "out": args.out}))


def cmd_static(args):
    from pprx_torch.engine.push import push_to_convergence
    from pprx_torch.engine.state import FORWARD, init_state
    from pprx_torch.graph.dynamic import WindowGraph
    from pprx_torch.sync import sync

    device = _device(args)
    _kernel_dtype(args, device, "static", "dense")
    src, dst, n = _load(args)
    queries = _queries(args, n)
    graph = WindowGraph.from_coo(src, dst, n, device=device)
    state = init_state(n, queries, mode=_mode(args), dtype=_dtype(args), device=device)
    sync(device)
    t0 = time.perf_counter()
    state, stats = push_to_convergence(state, graph, _cfg(args))
    sync(device)
    wall = time.perf_counter() - t0
    out = {
        "n": n,
        "edges": int(src.shape[0]),
        "queries": queries,
        "rounds": int(stats.rounds),
        "pushes": float(stats.pushes),
        "edge_pushes": float(stats.edge_pushes),
        "wall_s": round(wall, 4),
    }
    if args.check_exact:
        from pprx_torch.eval.metrics import l1_error
        from pprx_torch.ref.exact import exact_ppr, exact_ppr_columns

        # rows (forward) or columns (reverse) of M by f64 power iteration,
        # to an L1 step of 1e-14: within 1e-13 of the fixed point
        exact = exact_ppr if _mode(args) == FORWARD else exact_ppr_columns
        tgt = exact(src, dst, n, queries, args.alpha, tol=1e-14, device=device)
        p = state.p[:n].double().cpu().numpy()
        out["l1_error"] = [l1_error(p[:, j], tgt[j]) for j in range(len(queries))]
        out["l1_bound"] = args.eps * src.shape[0]
    print(json.dumps({**out, **_device_key(device)}))


def _make_stream_driver(args, src, dst, n, queries, scfg, device, mesh=None):
    """The engine ``--engine`` names: the fast (wl2), the hybrid or the dense
    driver, or, on a ``mesh``, this process's shard of a sharded one."""
    from pprx_torch.graph.fast_stream import FastStreamDriver
    from pprx_torch.graph.hybrid_stream import HybridStreamDriver
    from pprx_torch.graph.stream import StreamDriver

    common = dict(mode=_mode(args), dtype=_dtype(args), device=device)
    if mesh is not None:
        from pprx_torch.dist.stream import ShardedStreamDriver

        engine = {"sharded-wl": "wl", "sharded-wlp": "wlp"}.get(args.engine, "dense")
        return ShardedStreamDriver(src, dst, n, queries, _cfg(args), scfg, mesh, ecap=args.ecap,
                                   engine=engine, **common)
    ctor = {"fast": FastStreamDriver, "hybrid": HybridStreamDriver,
            "dense": StreamDriver}[args.engine]
    return ctor(src, dst, n, queries, _cfg(args), scfg, **common)


def _sharded_mesh(args):
    """The process group and the ``--mesh`` (rows,srcs; by default one row
    per process) of a sharded run, built as the reference builds them:
    ``--coordinator``, ``--num-processes`` and ``--process-id``, or
    torchrun's variables. Exits where the world cannot hold the mesh."""
    from pprx_torch.dist.init import init_distributed
    from pprx_torch.dist.mesh import make_row_mesh

    init_distributed(args.coordinator, args.num_processes, args.process_id, device=args.device)
    rows, srcs = (int(x) for x in args.mesh.split(",")) if args.mesh else (_world(), 1)
    try:
        return make_row_mesh(rows, srcs)
    except ValueError as err:
        raise SystemExit(f"--engine {args.engine}: {err}; start one process per shard "
                         "(torchrun, or --coordinator/--num-processes/--process-id)") from err


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _rank() -> int:
    """This process's rank (0 without a process group): only rank 0 prints."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _shard_device(args) -> torch.device:
    """The device of this process's shard: in a multi-process run on the
    card, the card ``init_distributed`` gave this rank."""
    device = _device(args)
    if device.type == "cuda" and _world() > 1:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _as_push_stats(rec):
    """A sharded driver's record (a dict) as the ``PushStats`` the summary sums."""
    from pprx_torch.engine.state import PushStats

    return PushStats(rounds=rec["rounds"], pushes=rec["pushes"],
                     edge_pushes=rec["edge_pushes"], wl_rounds=rec.get("wl_rounds", 0))


def cmd_stream(args):
    import os

    from pprx_torch.config import StreamConfig
    from pprx_torch.eval.perf import summarize
    from pprx_torch.io.checkpoint import save_checkpoint, save_sharded_checkpoint
    from pprx_torch.logging import JsonlLogger
    from pprx_torch.sync import sync

    sharded = args.engine in SHARDED_ENGINES
    mesh = _sharded_mesh(args) if sharded else None
    device = _shard_device(args)
    kernels = {"fast": "fast", "dense": "dense", "hybrid": "hybrid", "sharded-wl": "fast",
               "sharded-wlp": "fast"}
    if args.engine == "sharded" and mesh.size == 1:
        kernels["sharded"] = "sharded"
    if args.engine in kernels:
        _kernel_dtype(args, device, f"stream --engine {args.engine}", kernels[args.engine])
    src, dst, n = _load(args)
    queries = _queries(args, n)
    scfg = StreamConfig(window=args.window, slide=args.slide)
    drv = _make_stream_driver(args, src, dst, n, queries, scfg, device, mesh)
    stats_of = _as_push_stats if sharded else (lambda s: s)
    rank = _rank()
    with JsonlLogger(args.log if rank == 0 else os.devnull) as log:
        seed_stats = stats_of(drv.seed())
        log.log("seed", rounds=int(seed_stats.rounds), pushes=float(seed_stats.pushes))
        t0 = time.perf_counter()
        stats_list = []
        for i, s in enumerate(drv.run(args.steps)):
            s = stats_of(s)
            stats_list.append(s)
            log.log(
                "slide",
                step=i,
                rounds=int(s.rounds),
                pushes=float(s.pushes),
                edge_pushes=float(s.edge_pushes),
            )
            if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
                (save_sharded_checkpoint if sharded else save_checkpoint)(args.checkpoint, drv)
                log.log("checkpoint", step=i, path=args.checkpoint)
        sync(device)
        wall = time.perf_counter() - t0
        rep = {**summarize(stats_list, wall, edges_per_step=2 * args.slide,
                           n_chips=mesh.size if sharded else 1).as_dict(),
               **_device_key(device)}
        log.log("summary", **rep)
    if rank == 0:
        print(json.dumps(rep))


def _checkpoint_kind(path: str) -> str | None:
    """The ``kind`` a checkpoint's metadata names (``"sharded"`` for the
    reference's sharded driver), or ``None``."""
    try:
        with np.load(path) as z:
            return json.loads(bytes(z["meta"]).decode()).get("kind")
    except (OSError, KeyError, ValueError):
        return None


def cmd_retrieve(args):
    from pprx_torch.engine.push import push_to_convergence
    from pprx_torch.engine.state import init_state
    from pprx_torch.graph.dynamic import WindowGraph
    from pprx_torch.retrieve.topk import topk_candidates
    from pprx_torch.sync import sync

    device = _device(args)
    if args.from_checkpoint and args.refine_eps:
        _kernel_dtype(args, device, "retrieve --refine-eps")
    elif not args.from_checkpoint:
        _kernel_dtype(args, device, "retrieve", "dense")
    src, dst, n = _load(args)
    refine_info = {}
    if args.from_checkpoint:
        # serve from a maintained stream state: the checkpoint holds the
        # converged reserve, optionally refined to a tighter eps before the
        # top-k read (the retrieval precision policy)
        from pprx_torch.io.checkpoint import load_checkpoint

        if _checkpoint_kind(args.from_checkpoint) == "sharded":
            raise SystemExit(
                "this is a SHARDED checkpoint; serve it through the sharded driver "
                "(pprx_torch.io.checkpoint.load_sharded_checkpoint + "
                "pprx_torch.dist.retrieve.make_sharded_topk), not `retrieve --from-checkpoint`")
        drv = load_checkpoint(args.from_checkpoint, src, dst, device=device)
        if args.refine_eps:
            if not hasattr(drv, "refine"):
                raise SystemExit(
                    "--refine-eps needs a fast-engine checkpoint "
                    f"(got {type(drv).__name__})"
                )
            if device.type == "cuda" and drv.state.p.dtype != torch.float32:
                raise SystemExit(
                    f"retrieve --refine-eps: the checkpoint's state is {drv.state.p.dtype}; "
                    f"the segment-sum kernel on {device} takes f32 or bf16 only")
            t0 = time.perf_counter()
            rstats = drv.refine(args.refine_eps)
            sync(device)
            refine_info = {
                "refine_eps": args.refine_eps,
                "refine_ms": round((time.perf_counter() - t0) * 1e3, 3),
                "refine_rounds": int(rstats.rounds),
            }
        state = drv.state
        queries = getattr(drv, "_queries", None)
        n_batch = state.p.shape[1]
        push_rounds = 0  # the push work happened in the stream
    else:
        rng = np.random.default_rng(0)
        if args.queries == "random":
            queries = rng.integers(0, n, size=args.batch).tolist()
        else:
            queries = _queries(args, n)
        graph = WindowGraph.from_coo(src, dst, n, device=device)
        state = init_state(n, queries, mode=0, dtype=_dtype(args), device=device)
        state, stats = push_to_convergence(state, graph, _cfg(args))
        n_batch = len(queries)
        push_rounds = int(stats.rounds)
    # a first read before the timed one (the allocator's first use; the
    # reference warms its compile the same way)
    scores, ids = topk_candidates(state.p, k=args.k, exact=not args.approx)
    sync(device)
    t0 = time.perf_counter()
    scores, ids = topk_candidates(state.p, k=args.k, exact=not args.approx)
    sync(device)
    retr_ms = (time.perf_counter() - t0) * 1e3
    print(
        json.dumps(
            {
                "n": n,
                "batch": n_batch,
                "queries_known": queries is not None,
                "k": args.k,
                "push_rounds": push_rounds,
                "retrieval_ms": round(retr_ms, 3),
                **refine_info,
                "top1": [int(i) for i in ids[: min(8, n_batch), 0].cpu()],
                **_device_key(device),
            }
        )
    )


def cmd_serve(args):
    """Bounded-stall serving loop: maintain the stream at --eps, spend up to
    --refine-budget push rounds per slide refining toward --eps-retrieve
    (the push invariant holds wherever a refine stops), and serve top-k
    reads from the current state every --serve-every slides.
    --refine-budget 0 is the event mode: one full refine before each read.

    A slide's wall is the slide, its budgeted refine and one device sync;
    ``updates_per_sec_incl_refine`` is 2 * slide * steps over the sum of
    those walls, so it means the same at any budget. Event refines and
    top-k reads are outside it; ``updates_per_sec_end_to_end`` divides by
    the whole loop's wall instead."""
    from pprx_torch.config import StreamConfig
    from pprx_torch.engine.state import FORWARD
    from pprx_torch.graph.fast_stream import FastStreamDriver
    from pprx_torch.logging import JsonlLogger
    from pprx_torch.retrieve.topk import topk_candidates
    from pprx_torch.sync import sync

    if args.mode != "fwd":
        raise SystemExit("serve: forward mode only (source-personalized top-k)")
    device = _device(args)
    _kernel_dtype(args, device, "serve")
    src, dst, n = _load(args)
    queries = _queries(args, n)
    scfg = StreamConfig(window=args.window, slide=args.slide)
    drv = FastStreamDriver(src, dst, n, queries, _cfg(args), scfg, mode=FORWARD,
                           dtype=_dtype(args), device=device)
    budget = args.refine_budget
    with JsonlLogger(args.log) as log:
        seed_stats = drv.seed()
        log.log("seed", rounds=int(seed_stats.rounds))
        if budget:
            # ramp-up: converge to eps_retrieve once, so that steady slides
            # only maintain it
            st = drv.refine(args.eps_retrieve)
            log.log("ramp_refine", rounds=int(st.rounds))
        steps = args.steps if args.steps is not None else drv.steps_available
        slide_ms = []
        retr_ms = []
        served = 0
        sync(device)
        t0 = time.perf_counter()
        for i in range(steps):
            t1 = time.perf_counter()
            ran = False
            for _ in drv.run(1):
                ran = True
            if not ran:
                break
            if budget:
                st = drv.refine(args.eps_retrieve, rounds=budget)
                sync(device)
                w = (time.perf_counter() - t1) * 1e3
                log.log("slide", step=i, wall_ms=round(w, 1), refine_rounds=int(st.rounds))
            else:
                sync(device)
                w = (time.perf_counter() - t1) * 1e3
                log.log("slide", step=i, wall_ms=round(w, 1))
            slide_ms.append(w)
            if (i + 1) % args.serve_every == 0:
                if not budget:
                    t2 = time.perf_counter()
                    st = drv.refine(args.eps_retrieve)
                    sync(device)
                    log.log("event_refine", step=i, rounds=int(st.rounds),
                            wall_ms=round((time.perf_counter() - t2) * 1e3, 1))
                t2 = time.perf_counter()
                scores, ids = topk_candidates(drv.state.p, k=args.k, exact=False)
                sync(device)
                ms = (time.perf_counter() - t2) * 1e3
                retr_ms.append(ms)
                served += 1
                rec = {"step": i, "k": args.k, "latency_ms": round(ms, 2),
                       "batch": len(queries)}
                if args.emit_ids:
                    rec["ids"] = ids[: args.emit_ids].cpu().tolist()
                log.log("serve", **rec)
        wall = time.perf_counter() - t0
        done = len(slide_ms)
        rep = {
            "mode": "serve",
            "steps": done,
            "serve_events": served,
            "updates_per_sec_incl_refine": round(2 * args.slide * done / (sum(slide_ms) / 1e3), 1)
            if done else 0.0,
            "updates_per_sec_end_to_end": round(2 * args.slide * done / wall, 1)
            if done else 0.0,
            "slide_ms_worst": round(max(slide_ms), 1) if slide_ms else None,
            "slide_ms_mean": round(float(np.mean(slide_ms)), 1) if slide_ms else None,
            "retrieval_ms_mean": round(float(np.mean(retr_ms)), 2) if retr_ms else None,
            "refine_budget_rounds": budget,
            "serve_every": args.serve_every,
            "eps_maintain": args.eps,
            "eps_retrieve": args.eps_retrieve,
            **_device_key(device),
        }
        log.log("summary", **rep)
    print(json.dumps(rep))


def cmd_bench(args):
    if args.config == 5:
        from pprx_torch.dist.init import init_distributed

        # one shard per process under torchrun; a mesh of one otherwise
        init_distributed(device=args.device)
    device = _shard_device(args)
    if args.config:
        from pprx_torch.bench.run import run_config

        kw = {}
        if args.graph:
            kw["graph"] = args.graph
        if args.scale != 1:
            kw["scale"] = args.scale
        out = run_config(args.config, device=device, **kw)
        if _rank() == 0:
            print(json.dumps(out))
        return
    from pprx_torch.bench import headline

    print(json.dumps(headline.run(device)))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="pprx-torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("convert", help="edge-list text -> packed npz")
    p.add_argument("graph")
    p.add_argument("out")
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("static", help="static push query")
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--check-exact", action="store_true")
    p.set_defaults(fn=cmd_static)

    p = sub.add_parser("stream", help="sliding-window dynamic maintenance")
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--window", type=int, required=True)
    p.add_argument("--slide", type=int, required=True)
    p.add_argument(
        "--engine",
        choices=["fast", "hybrid", "dense", *SHARDED_ENGINES],
        default="fast",
        help="fast = compact-frontier wl2 engine (default); hybrid = CSR "
        "snapshot + signed overlay with worklist rounds; dense = rounds over "
        "the whole COO window; sharded, sharded-wl = the row-sharded dense and "
        "compact-frontier engines; sharded-wlp = sharded-wl with the "
        "memory-proportional carry and drain rounds",
    )
    p.add_argument("--mesh", type=str, default=None,
                   help="sharded engines: rows,srcs (default: one row per process)")
    p.add_argument("--coordinator", type=str, default=None,
                   help="sharded engines: host:port of process 0 (or torchrun's variables)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--ecap", type=int, default=None,
                   help="sharded engines: edge slots per shard (default: the window)")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--log", type=str, default=None, help="JSONL log path (default stdout)")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--checkpoint-every", type=int, default=100)
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("retrieve", help="multi-source top-k candidates")
    p.add_argument(
        "--from-checkpoint",
        default=None,
        help="serve from a stream checkpoint's maintained state instead of "
        "pushing from scratch (the graph arg supplies the stream file)",
    )
    p.add_argument(
        "--refine-eps",
        type=float,
        default=0.0,
        help="refine the maintained state to this tighter eps before "
        "reading top-k (retrieval precision policy; fast engine only)",
    )
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--approx", action="store_true",
                   help="accepted for the reference's command line; the head is exact")
    p.set_defaults(fn=cmd_retrieve)

    p = sub.add_parser(
        "serve",
        help="bounded-stall serving: maintain + budgeted refine + top-k reads",
    )
    p.add_argument("graph")
    _add_common(p)
    p.add_argument("--window", type=int, required=True)
    p.add_argument("--slide", type=int, required=True)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--k", type=int, default=100)
    p.add_argument("--eps-retrieve", type=float, default=5e-8)
    p.add_argument(
        "--refine-budget", type=int, default=6,
        help="max refinement push rounds per slide (0 = full refine at "
        "each serve event instead: the event mode)",
    )
    p.add_argument("--serve-every", type=int, default=4,
                   help="serve a top-k batch every N slides")
    p.add_argument(
        "--emit-ids", type=int, default=0,
        help="log top-k ids for the first N queries at each serve event",
    )
    p.add_argument("--log", type=str, default=None,
                   help="JSONL log path (default stdout)")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", help="headline updates/s benchmark")
    p.add_argument(
        "--config",
        type=int,
        choices=[1, 2, 3, 4, 5],
        default=0,
        help="run one of the milestone configs 1-5 instead (5: the sharded slide step on "
        "this process's shard)",
    )
    p.add_argument(
        "--graph",
        default=None,
        help="packed .npz edge stream (convert's output) to run the "
        "config on instead of the synthetic power-law stand-in",
    )
    p.add_argument("--scale", type=int, default=1)
    _add_device(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
