"""Worlds of processes for the sharded port's CPU tests (tests/test_torch_dist*.py).

``World(shape, cases, tmp)`` starts a ``rows x srcs`` world of the port:
one process per shard, started with ``torch.multiprocessing`` (spawn), on
gloo over a ``FileStore`` in ``tmp`` (no ports), every process on one
thread. Each process runs every case of ``cases`` in order, and rank 0
writes each case's results to ``tmp/<case>.npz``. A world of one runs in
its own process with no process group. The group's init has a 60 s timeout,
and the parent waits for the world until a deadline, then kills it: a hung
collective fails its tests with the workers' stderr instead of running the
suite into its limit. ``worlds`` starts a test module's worlds together.

Cases are functions of this module, ``case(mesh, **kw) -> dict`` of
arrays; the inputs are made from seeds with NumPy, so a test builds the
same ones for the JAX package. This module imports ``torch`` and
``pprx_torch`` only, never ``jax`` or ``pprx``.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

WORLD_DEADLINE_S = 240.0
INIT_TIMEOUT_S = 60.0


# ---------------------------------------------------------------- inputs
def random_multigraph(rng, n, m):
    """Random directed multigraph COO without self-loops (tests/conftest.py's)."""
    src = rng.integers(0, n, size=m)
    dst = (src + 1 + rng.integers(0, n - 1, size=m)) % n
    return src.astype(np.int64), dst.astype(np.int64)


def graph(kind: str, seed: int = 0, n: int = 50, m: int = 300):
    """(src, dst, n): ``random`` multigraph, ``dangling`` (the same with the
    out-edges of every fifth vertex dropped), or the ``star`` (hub 3 fans
    out to every spoke and back)."""
    if kind == "star":
        hub = 3
        src = np.concatenate([np.full(n - 1, hub), np.arange(1, n) % n])
        dst = np.concatenate([np.arange(1, n), np.full(n - 1, hub)])
        return src, dst, n
    src, dst = random_multigraph(np.random.default_rng(seed), n, m)
    if kind == "dangling":
        keep = src % 5 != 0
        src, dst = src[keep], dst[keep]
    return src, dst, n


def threshold_state(n: int, n_pad: int, src, s: int, eps: float, forward: bool, seed: int):
    """A push state with work at every row's threshold (``eps * max(deg,
    1)`` forward, ``eps`` reverse; ``deg`` the out-degrees of ``src``):
    ``|r|`` uniform below twice it at both signs, an eighth of the entries
    exactly at it (not active), ``p`` in [0, 1e-3), the padding rows zero.
    Returns (p, r), global ``[n_pad, s]`` f64."""
    rng = np.random.default_rng(seed)
    deg = np.bincount(np.asarray(src, np.int64), minlength=n_pad)[:n_pad]
    th = eps * np.maximum(deg, 1).astype(np.float64) if forward else np.full(n_pad, eps)
    th = np.broadcast_to(th[:, None], (n_pad, s))
    r = rng.uniform(-2.0, 2.0, (n_pad, s)) * th
    at = rng.random((n_pad, s)) < 0.125
    r[at] = np.where(r[at] < 0, -th[at], th[at])
    p = rng.random((n_pad, s)) * 1e-3
    p[n:] = r[n:] = 0.0
    return p, r


def stream(seed: int, n: int = 40, total: int = 500):
    from pprx_torch.graph.io import synthetic_powerlaw_stream

    return synthetic_powerlaw_stream(n, total, seed=seed)


def topk_matrix(n: int, s: int, n_pad: int, seed: int, ties: bool, poison: bool):
    rng = np.random.default_rng(seed)
    p = np.zeros((n_pad, s))
    p[:n] = rng.random((n, s))
    if ties:  # lowest global id wins among equal scores
        p[10, :] = p[20, :] = p[30, :] = 0.999
    if poison:  # padding rows must never be retrieved
        p[n:] = 100.0
    return p


# ---------------------------------------------------------------- cases
def _cfg(eps: float = 1e-8):
    from pprx_torch.config import PprConfig

    return PprConfig(alpha=0.15, eps=eps, max_rounds=10_000)


def _dtype(name: str):
    return {"f64": torch.float64, "f32": torch.float32}[name]


def mesh_facts(mesh):
    """The mesh's view of the world and a second ``init_distributed`` call."""
    from pprx_torch.dist.init import init_distributed

    again = init_distributed(None, None, None, device="cpu")
    return {"rank": mesh.rank, "row": mesh.row, "src": mesh.src, "size": mesh.size,
            "row_ranks": np.asarray(mesh.row_ranks), "init_again": again,
            "jax_loaded": "jax" in sys.modules or "pprx" in sys.modules}


def collectives(mesh):
    """Each wrapper once on the world's row and world groups."""
    from pprx_torch.dist import mesh as M

    k, rank = mesh.n_rows, mesh.rank
    x = torch.arange(k * 3 * 2, dtype=torch.float64).reshape(k * 3, 2) + 100 * rank
    ids = torch.arange(k * 2, dtype=torch.int32).reshape(k, 2) + 10 * rank
    b16 = (torch.arange(k * 2, dtype=torch.float32).reshape(k, 2) / 3 + rank).to(torch.bfloat16)
    rs = M.reduce_scatter_rows(x, mesh.row_group)
    a2a = M.all_to_all_rows(ids, mesh.row_group)
    a2b = M.all_to_all_rows(b16, mesh.row_group)
    stats = M.gather_stats([torch.tensor(rank), 7, torch.tensor(True)], mesh.world,
                           torch.device("cpu"))
    out = {"rs": rs.numpy(), "a2a": a2a.numpy(), "a2b": a2b.float().numpy(), "stats": stats}
    # every rank's, for the test to read all of them
    return {key: M.all_gather_rows(torch.from_numpy(np.ascontiguousarray(v)), mesh.world).numpy()
            for key, v in out.items()}


def _assembled(mesh, p, r, **extra):
    from pprx_torch.dist.stream import assemble

    return {"p": assemble(p, mesh), "r": assemble(r, mesh), **extra}


def dense_push(mesh, mode: int, exchange: str = "dense_rs", ccap: int = 1024, kind="random",
               seed: int = 0, n: int = 50, m: int = 300, queries=(0, 7, 13, 25, 31, 44, 7, 2),
               eps: float = 1e-8):
    """ShardedEngine.push from the one-hot state."""
    from pprx_torch.dist.sharded import ShardedEngine

    src, dst, n = graph(kind, seed, n, m)
    eng = ShardedEngine(mesh, n, len(queries), ecap=src.size, bcap=8, cfg=_cfg(eps), mode=mode,
                        dtype=torch.float64, exchange=exchange, ccap=ccap, device="cpu")
    p, r = eng.init_state(queries)
    deg, egl, eog, eva, counts = eng.device_graph(src, dst)
    p, r, rounds, pushes, epushes = eng.push(p, r, deg, egl, eog, eva)
    return _assembled(mesh, p, r, rounds=rounds, pushes=pushes, epushes=epushes,
                      counts=counts, n_local=eng.n_local)


def _driver(mesh, engine: str, mode: int, seed: int, queries, dtype="f64", eps=1e-8,
            window=300, slide=25, **kw):
    from pprx_torch.config import StreamConfig
    from pprx_torch.dist.stream import ShardedStreamDriver

    src, dst, n = stream(seed)
    return ShardedStreamDriver(src, dst, n, list(queries), _cfg(eps), StreamConfig(window, slide),
                               mesh, mode=mode, dtype=_dtype(dtype), engine=engine,
                               device="cpu", **kw)


def slides(mesh, engine: str, mode: int = 0, seed: int = 2, steps: int = 6,
           queries=(0, 5, 11, 33), dtype: str = "f64", eps: float = 1e-8, heavy_ew=None,
           sort_bucket_min=None, **kw):
    """A sliding stream through ShardedStreamDriver: seed, then ``steps``
    slides; per-slide rounds and the final state. ``heavy_ew`` replaces the
    wl engine's stats-skip threshold; ``sort_bucket_min`` the module's
    SORT_BUCKET_MIN."""
    import pprx_torch.dist.wl as wl

    old = wl.SORT_BUCKET_MIN
    if sort_bucket_min is not None:
        wl.SORT_BUCKET_MIN = sort_bucket_min
    try:
        drv = _driver(mesh, engine, mode, seed, queries, dtype, eps, **kw)
        if heavy_ew is not None:
            drv.eng.heavy_ew = heavy_ew
        st = [drv.seed()] + list(drv.run(steps))
    finally:
        wl.SORT_BUCKET_MIN = old
    return {"p": drv.host_p(), "r": drv.host_r(), "deg": drv.host_deg(), "head": drv.head,
            "rounds": np.asarray([s["rounds"] for s in st]),
            "wl_rounds": np.asarray([s.get("wl_rounds", -1) for s in st]),
            "pushes": np.asarray([s["pushes"] for s in st]),
            "heavy_ew": getattr(drv.eng, "heavy_ew", -1)}


def wl_push(mesh, mode: int, ccap=64, kind="random", seed: int = 0, n: int = 50, m: int = 300,
            queries=(0, 7, 13, 25, 31, 44, 7, 2), dtype: str = "f64", eps: float = 1e-8,
            bf16d: bool = False, seeded: bool = False, sort_bucket_min=None, e_top=None,
            fring=None, heavy_ew=None, proportional: bool = False, state_seed=None):
    """ShardedWlEngine.push_wl from the one-hot state (with ``state_seed``:
    from ``threshold_state``'s); ``seeded``: with the query rows as the
    first candidate list; ``heavy_ew`` replaces the stats-skip threshold;
    ``proportional``: the wlp loop. Round kinds are counted."""
    import pprx_torch.dist.wl as wl

    src, dst, n = graph(kind, seed, n, m)
    eng = wl.ShardedWlEngine(mesh, n, len(queries), ecap=src.size, bcap=8, cfg=_cfg(eps),
                             mode=mode, dtype=_dtype(dtype), ccap=ccap, bf16d=bf16d,
                             e_top=e_top, fring=fring, proportional=proportional, device="cpu")
    if heavy_ew is not None:
        eng.heavy_ew = heavy_ew
    p, r = eng.init_state(queries)
    if state_seed is not None:
        block = (slice(eng.row0, eng.row0 + eng.n_local), slice(eng.col0, eng.col0 + eng.s_loc))
        p, r = (torch.from_numpy(np.ascontiguousarray(a[block])).to(_dtype(dtype)) for a in
                threshold_state(n, eng.n_pad, src, len(queries), eps, mode == 0, state_seed))
    deg, egl, eog, eva, counts, snap = eng.device_graph_wl(src, dst)
    cand0, ok0 = None, 0
    if seeded:
        rows = np.full((eng.n_rows, eng.wcarry), eng.n_local, np.int32)
        for q in sorted(set(queries)):
            k, loc = divmod(q, eng.n_local)
            rows[k][int((rows[k] != eng.n_local).sum())] = loc
        cand0, ok0 = eng.cand0_rows(rows), 1
    old = wl.SORT_BUCKET_MIN
    if sort_bucket_min is not None:
        wl.SORT_BUCKET_MIN = sort_bucket_min
    try:
        p, r, rounds, pushes, epushes, wl_rounds = eng.push_wl(p, r, deg, snap, cand0, ok0)
    finally:
        wl.SORT_BUCKET_MIN = old
    return _assembled(mesh, p, r, rounds=rounds, pushes=pushes, epushes=epushes,
                      wl_rounds=wl_rounds, n_local=eng.n_local, ccaps=np.asarray(eng.ccaps),
                      **{f"{kind}_rounds": c for kind, c in eng.round_kinds.items()})


def rowsum_sweeps(mesh, s: int = 8, seed: int = 2, steps: int = 6, fring: int = 60):
    """A reverse wl stream of ``s`` targets (the stream's vertices in turn):
    on every slide, the row-sum sweep the slide is about to run (its local
    part plus the row group's remote parts), assembled over the world."""
    from pprx_torch.dist.mesh import reduce_scatter_rows
    from pprx_torch.dist.stream import assemble

    queries = [i % 40 for i in range(s)]
    drv = _driver(mesh, "wl", 1, seed, queries, ccap=64, fring=fring)
    eng, sweeps = drv.eng, []
    slide = eng.slide_wl

    def recording(p, r, deg, egl, eog, eva, snap, *rest):
        s_loc, acc = eng.rowsum_sweep(p, snap)
        s_old = s_loc if acc is None else s_loc + reduce_scatter_rows(acc, mesh.row_group)
        sweeps.append(assemble(s_old, mesh))
        return slide(p, r, deg, egl, eog, eva, snap, *rest)

    eng.slide_wl = recording
    st = [drv.seed()] + list(drv.run(steps))
    return {"s_old": np.stack(sweeps), "rounds": np.asarray([x["rounds"] for x in st]),
            "p": drv.host_p()}


def membound(mesh, proportional: bool, reverse_slide: bool = False, seed: int = 1,
             ecap: int = 1600):
    """The largest float tensor an op returns on this shard: in push_wl from
    a dense round or rescan (then the push's state), or in a reverse slide
    of an empty batch (``reverse_slide``), on a 4,000-vertex graph with 8
    sources; and the sizes it is held to."""
    from pprx_torch.dist.wl import ShardedWlEngine
    from pprx_torch.eval.membound import max_float_temp_size

    src, dst, n = graph("random", seed, 4000, 6000)
    queries = list(range(8))
    eng = ShardedWlEngine(mesh, n, len(queries), ecap=ecap, bcap=8, cfg=_cfg(), mode=int(
        reverse_slide), dtype=torch.float64, ccap=128, proportional=proportional, device="cpu")
    p, r = eng.init_state(queries)
    deg, egl, eog, eva, _, snap = eng.device_graph_wl(src, dst)
    out = {"n_local": eng.n_local, "n_pad": eng.n_pad, "s": len(queries),
           "ccarry": getattr(eng, "ccarry", 0)}
    if reverse_slide:
        tail = eng.slide_tail((0, 0, 0), None, snap)
        pack = torch.cat([torch.zeros(6 * eng.bcap, dtype=torch.int32), torch.from_numpy(tail)])
        out["biggest"] = max_float_temp_size(eng.slide_wl, p, r, deg, egl, eog, eva, snap, pack,
                                             None, (0, 0, 0))
        return out
    cand0 = torch.full((eng.wcarry,), eng.n_local, dtype=torch.int32)
    out["biggest"] = max_float_temp_size(eng.push_wl, p.clone(), r.clone(), deg, snap, cand0, 0)
    p, r, rounds, *_ = eng.push_wl(p, r, deg, snap)
    return _assembled(mesh, p, r, rounds=rounds, **out)


def sharded_resume(mesh, engine: str, mode: int, out_dir: str, before: int = 2, after: int = 4,
                   jax_file: str | None = None):
    """A sharded stream (fring 60: a rebuild every 2 slides) seeded and run
    ``before`` slides, saved to ``out_dir``, run ``after`` more; the file
    loaded (with this mesh) and run ``after`` slides beside it. With
    ``jax_file``: that file loaded, saved again at once, and run ``after``
    slides."""
    from pprx_torch.io.checkpoint import load_sharded_checkpoint, save_sharded_checkpoint

    tag = f"{engine}-{mode}-{mesh.n_rows}x{mesh.n_srcs}"
    kw = {} if engine == "dense" else dict(ccap=64, fring=60)
    src, dst, _ = stream(11)
    a = _driver(mesh, engine, mode, 11, (0, 5, 9, 17), **kw)
    a.seed()
    list(a.run(before))
    path = os.path.join(out_dir, f"port-{tag}.npz")
    save_sharded_checkpoint(path, a)
    rounds_a = [x["rounds"] for x in a.run(after)]
    b = load_sharded_checkpoint(path, src, dst, mesh, device="cpu")
    res = {"head_b": b.head, "rounds_b": np.asarray([x["rounds"] for x in b.run(after)]),
           "rounds_a": np.asarray(rounds_a),
           "same": all(torch.equal(getattr(a, k), getattr(b, k)) for k in ("p", "r", "deg")),
           "pa": a.host_p(), "ra": a.host_r(), "deg": a.host_deg(), "pb": b.host_p()}
    if jax_file is not None:
        c = load_sharded_checkpoint(jax_file, src, dst, mesh, device="cpu")
        save_sharded_checkpoint(os.path.join(out_dir, f"again-{tag}.npz"), c)
        res.update(rounds_c=np.asarray([x["rounds"] for x in c.run(after)]), pc=c.host_p(),
                   rc=c.host_r())
    return res


def topk(mesh, n: int, s: int, k: int, seed: int, ties: bool = False, poison: bool = False):
    """make_sharded_topk on this shard's block of a seeded matrix."""
    from pprx_torch.dist.mesh import all_gather_rows
    from pprx_torch.dist.retrieve import make_sharded_topk

    n_local = -(-(n + 1) // mesh.n_rows)
    p = topk_matrix(n, s, n_local * mesh.n_rows, seed, ties, poison)
    s_loc = s // mesh.n_srcs
    block = p[mesh.row * n_local:(mesh.row + 1) * n_local,
              mesh.src * s_loc:(mesh.src + 1) * s_loc]
    sc, ids = make_sharded_topk(mesh, n, n_local, k)(torch.from_numpy(np.ascontiguousarray(block)))
    # every rank's [S_loc, k] (the ranks of one src must agree)
    return {"scores": all_gather_rows(sc, mesh.world).numpy(),
            "ids": all_gather_rows(ids, mesh.world).numpy(), "n_local": n_local}


# ---------------------------------------------------------------- worlds
def run_cases(mesh, cases: dict, out_dir: str, write: bool) -> None:
    for name, (fn, kw) in cases.items():
        res = globals()[fn](mesh, **kw)
        if write:
            np.savez(os.path.join(out_dir, f"{name}.npz"), **res)


def _worker(rank: int, world: int, shape: tuple, cases: dict, tmp: str) -> None:
    """One rank: its stderr into ``tmp/rank<k>.err`` (a failing case's
    traceback lands there and the process exits 1), the group, the cases."""
    err = os.open(os.path.join(tmp, f"rank{rank}.err"), os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err, 2)
    sys.stderr = os.fdopen(2, "w", buffering=1)
    torch.set_num_threads(1)
    from pprx_torch.dist.init import init_distributed
    from pprx_torch.dist.mesh import make_row_mesh

    # a world of one has no process group, as on one card
    if world > 1 and not init_distributed(f"file://{os.path.join(tmp, 'store')}", world, rank,
                                          device="cpu", timeout_s=INIT_TIMEOUT_S):
        raise RuntimeError("the process group was already started")
    mesh = make_row_mesh(*shape)
    run_cases(mesh, cases, tmp, rank == 0)
    if world > 1:
        torch.distributed.destroy_process_group()


def _stderr(tmp: str, world: int) -> str:
    out = []
    for rank in range(world):
        path = os.path.join(tmp, f"rank{rank}.err")
        text = open(path).read() if os.path.exists(path) else "(no stderr file)"
        out.append(f"--- rank {rank} ---\n{text[-4000:]}")
    return "\n".join(out)


class World:
    """A ``shape`` world running ``cases`` (name -> (case function name,
    kwargs)), started at construction; ``result()`` waits for it and returns
    name -> the case's arrays. Raises RuntimeError with the workers' stderr
    if a worker fails or the world outlives its deadline."""

    def __init__(self, shape: tuple[int, int], cases: dict, tmp: str,
                 deadline_s: float = WORLD_DEADLINE_S):
        self.shape, self.cases, self.tmp = shape, cases, tmp
        self.size = shape[0] * shape[1]
        self.end = time.monotonic() + deadline_s
        self.deadline_s = deadline_s
        self.procs = []
        self.done = None
        os.makedirs(tmp, exist_ok=True)
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_worker, args=(rank, self.size, shape, cases, tmp),
                                  daemon=True) for rank in range(self.size)]
        for proc in self.procs:
            proc.start()

    def result(self) -> dict[str, dict]:
        if self.done is None:
            self.done = self._wait()
        if isinstance(self.done, RuntimeError):
            raise self.done
        return self.done

    def _wait(self):
        for proc in self.procs:
            proc.join(max(0.0, self.end - time.monotonic()))
        hung = [rank for rank, proc in enumerate(self.procs) if proc.is_alive()]
        for proc in self.procs:
            if proc.is_alive():
                proc.kill()
                proc.join(10)
        codes = [proc.exitcode for proc in self.procs]
        if hung or any(codes):
            why = (f"ranks {hung} still running after {self.deadline_s} s" if hung
                   else f"exit codes {codes}")
            return RuntimeError(f"world {self.shape}: {why}\n{_stderr(self.tmp, self.size)}")
        return {name: dict(np.load(os.path.join(self.tmp, f"{name}.npz"))) for name in self.cases}


def worlds(shapes, cases_of, tmp_factory, tag: str):
    """Start every shape's world at once (``cases_of(shape)`` gives its
    cases; they run beside each other and beside the caller's own work) and
    return ``get(shape)``, which waits for one."""
    started = {sh: World(sh, cases_of(sh), str(tmp_factory.mktemp(f"{tag}{sh[0]}x{sh[1]}")))
               for sh in shapes}
    return lambda shape: started[shape].result()
