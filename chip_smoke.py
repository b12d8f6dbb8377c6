"""Smoke run of the PyTorch/CUDA port (pprx_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path — the headline stream that bench.py times for
the JAX package — once on the card, and checks it. Phases, one line each:

1. device: the card's name, count and nvidia-smi name/power limit;
2. build: the segment-sum kernels from pprx_torch/csrc (seconds, ptxas lines);
3. kernel: both entries (``segsum_add_`` and ``segsum_gather_add_``, the
   gather fused in) against their plain PyTorch versions at the shapes the
   stream gives them (R=200,001 rows, S=128: a window scan of 2.0M sorted
   power-law edges under random int32 indices into a ``[200,001, 128]``
   table; a fresh-view scan of 320k edges; a compact round of 458,752
   lanes under the int64 order of a sort) and on uniform rows, f32 and bf16;
   two launches on the same inputs must agree bit for bit; then, in turns,
   each kernel's time, its plain version's, the library call's, the pair
   the fused entry replaces, and each kernel's bound from the byte counts;
4. stream f32: FastStreamDriver at N=200k, W=2M, b=160k, S=128, eps=1e-6,
   alpha=0.15 (bench.py's shapes): seed, warm-up, 8 timed slides; then two
   more slides under ``torch.profiler`` (a ``profile`` line: the device's
   busy and idle shares and the kernels that took the most device time);
5. stream bf16: the same segment with bf16 delivery;
6. serve: refine to eps=5e-8 (timed on the second call), top-100, and the
   exact-PPR contract on 16 sampled sources (f64 power iteration on the
   card, ``pprx_torch.ref.exact``);
7. parity: a small stream on the card in f32 against the CPU in f64.

Then a JSON line of the kernels (launches counted on the main path, phases
4 to 6, which must launch at least one entry), the nvidia-smi line, and
last ``{"ok": true, "device": {...}}``. Any failure raises: the exit code is
not 0 and the last line is not printed. There is no CPU path. Nothing of
JAX or of the JAX package ``pprx`` is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pprx_torch import _ext
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.device import require_cuda
from pprx_torch.engine import segsum
from pprx_torch.engine.segsum import (
    row_offsets,
    segment_ids,
    segsum_add_,
    segsum_add_plain,
    segsum_gather_add_,
    segsum_gather_add_plain,
)
from pprx_torch.engine.state import PprState
from pprx_torch.eval.metrics import l1_error, precision_at_k
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream
from pprx_torch.ref.exact import exact_ppr
from pprx_torch.retrieve.topk import topk_candidates
from pprx_torch.sync import sync

KERNEL_TOL = 1e-4  # rtol = atol: f32 sums of up to ~4e4 terms in [0, 1)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same sheet


def log(phase: str, **kw) -> None:
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean ms per call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the peak rate outside the tensor
    cores (NVIDIA's data sheet for the H100 SXM), and which of the two."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def in_turns(fns: dict, rounds: int = 2) -> dict:
    """Mean ms of each function, timed in turns: every one once, then every
    one again."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn))
    return {k: float(np.mean(v)) for k, v in times.items()}


def held_to_plain(tag: str, kernel, plain_f64: torch.Tensor, rin: torch.Tensor) -> float:
    """Run ``kernel`` twice on copies of ``rin``: the results must agree
    with the plain version's f64 sum within KERNEL_TOL and with each other
    bit for bit. Returns the largest absolute difference."""
    out, again = kernel(rin.clone()), kernel(rin.clone())
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"kernel {tag}: two launches on the same inputs differ")
    err = float((out.double() - plain_f64).abs().max())
    if not torch.allclose(out.double(), plain_f64, rtol=KERNEL_TOL, atol=KERNEL_TOL):
        raise AssertionError(f"kernel {tag} disagrees with the plain version: max abs err {err}")
    return err


def check_layout(layout: str, rin, row_off, table, gat, contrib=None) -> dict:
    """One edge layout: the gather entry (and ``segsum_add_`` where
    ``contrib`` is given) against the plain version's f64 sum of the same
    values, f32 and bf16 sources, repeat launches bit for bit. Then the
    times, in turns: each kernel; the plain version; the library call
    (``index_add_`` on ids prebuilt from the offsets; for the gather entry a
    CSR sparse product ``torch.sparse.addmm`` with unit values, which for a
    bf16 table needs ``table.float()`` first, timed with it: two calls);
    and for the gather entry the pair it replaces (``table[gat]``, then
    ``segsum_add_``) and ``index_add_`` of ``table[gat]``. Bounds from this
    layout's byte and operation counts: the edges the offsets cover, the
    table rows they name, ``rin`` read and written. Keys:
    ``<layout><entry>_<dtype>_<what>``."""
    rows, s = rin.shape
    lo, hi = int(row_off[0]), int(row_off[-1])
    used = hi - lo  # edges this run's offsets cover
    ids = segment_ids(row_off)
    res = {
        f"{layout}edges": gat.shape[0], f"{layout}edges_used": used,
        f"{layout}gat": str(gat.dtype).split(".")[-1],
        f"{layout}chunk": segsum.chunk_for(gat.shape[0]),
        f"{layout}max_row_edges": int(row_off.diff().max()),
    }
    rin_bytes = 2 * rows * s * 4 + (rows + 1) * 4
    table_rows = int(gat[lo:hi].unique().numel())
    csr = torch.sparse_csr_tensor((row_off - lo).to(gat.dtype), gat[lo:hi],
                                  torch.ones(used, device=rin.device),
                                  size=(rows, table.shape[0]))
    for dt in ("f32", "bf16"):
        tb = table if dt == "f32" else table.to(torch.bfloat16)
        add, gather = f"{layout}add_{dt}", f"{layout}gather_{dt}"
        ref = segsum_gather_add_plain(rin.double(), tb.double(), gat, row_off)
        res[f"{gather}_max_abs_err"] = held_to_plain(
            gather, lambda r: segsum_gather_add_(r, tb, gat, row_off), ref, rin)
        del ref
        acc = rin.clone()
        fns = {
            f"{gather}_library_ms": lambda: torch.sparse.addmm(acc, csr, tb.float()),
            f"{gather}_ms": lambda: segsum_gather_add_(acc, tb, gat, row_off),
            f"{gather}_plain_ms": lambda: segsum_gather_add_plain(acc, tb, gat, row_off),
            f"{gather}_pair_ms": lambda: segsum_add_(acc, tb[gat], row_off),
            f"{gather}_index_add_ms": lambda: acc.index_add_(0, ids, tb[gat[lo:hi]].to(acc.dtype)),
        }
        entries = [gather]
        if contrib is not None:
            c = contrib if dt == "f32" else contrib.to(torch.bfloat16)
            ref = segsum_add_plain(rin.double(), c.double(), row_off)
            res[f"{add}_max_abs_err"] = held_to_plain(
                add, lambda r: segsum_add_(r, c, row_off), ref, rin)
            del ref
            fns[f"{add}_library_ms"] = lambda: acc.index_add_(0, ids, c[lo:hi].to(acc.dtype))
            fns[f"{add}_ms"] = lambda: segsum_add_(acc, c, row_off)
            fns[f"{add}_plain_ms"] = lambda: segsum_add_plain(acc, c, row_off)
            res[f"{add}_bound_ms"], res[f"{add}_bound_by"] = bound_ms(
                used * s * c.element_size() + rin_bytes, used * s)
            entries.append(add)
        res.update(in_turns(fns))
        res[f"{gather}_bound_ms"], res[f"{gather}_bound_by"] = bound_ms(
            table_rows * s * tb.element_size() + used * gat.element_size() + rin_bytes,
            used * s)
        for k in entries:
            res[f"{k}_share_of_bound"] = res[f"{k}_bound_ms"] / res[f"{k}_ms"]
    return res


SHORT_EDGES = 320_000  # a full fresh view of the headline stream (2 slides)
COMPACT_LANES = 458_752  # the top tier's compact round: 131,072 + 262,144 + 65,536


def check_kernel(dev, n: int, n_edges: int, s: int) -> dict:
    """Both entries at the shapes the main path gives them (``check_layout``
    each): a window scan (``n_edges`` power-law sorted edges, int32 ``gat``
    into a ``[n+1, s]`` table), a fresh-view scan (320k edges, cut into
    smaller chunks), and a big compact round (gather entry only: the
    round's ``vals`` as the table, the int64 order of a stable
    ``torch.sort`` of its keys as ``gat``, a third of the lanes on the
    phantom row past ``row_off[n]``, ``rin`` a view of ``n`` rows); and, to
    show what skew costs, uniformly drawn rows."""
    _, dst, _ = synthetic_powerlaw_stream(n, n_edges, seed=7)
    rows = n + 1
    gen = torch.Generator(device=dev).manual_seed(0)
    contrib = torch.rand((n_edges, s), generator=gen, device=dev)
    table = torch.rand((rows, s), generator=gen, device=dev)
    gat = torch.randint(0, rows, (n_edges,), generator=gen, device=dev, dtype=torch.int32)
    rin = torch.rand((rows, s), generator=gen, device=dev)
    powerlaw = torch.from_numpy(np.sort(dst)).to(dev)
    uniform = torch.randint(0, n, (n_edges,), generator=gen, device=dev,
                            dtype=torch.int32).sort().values
    short = powerlaw[::n_edges // SHORT_EDGES][:SHORT_EDGES].contiguous()
    res = {"rows": rows, "s": s}
    res.update(check_layout("", rin, row_offsets(powerlaw, rows), table, gat, contrib))
    res.update(check_layout("uniform_", rin, row_offsets(uniform, rows), table, gat, contrib))
    res.update(check_layout("short_", rin, row_offsets(short, rows), table,
                            gat[:SHORT_EDGES].contiguous(),
                            contrib[:SHORT_EDGES].contiguous()))
    del contrib, table, gat
    keys = torch.from_numpy(dst[:COMPACT_LANES].astype(np.int64)).to(dev)
    masked = torch.rand(COMPACT_LANES, generator=gen, device=dev) < 1 / 3
    keys_s, order = torch.sort(torch.where(masked, n, keys), stable=True)
    vals = torch.rand((COMPACT_LANES, s), generator=gen, device=dev)
    res.update(check_layout("compact_", rin[:n], row_offsets(keys_s, n), vals, order))
    return res


def run_stream(drv: FastStreamDriver, warmup: int, steps: int) -> dict:
    """Seed, warm up, then time ``steps`` slides (host clock around a
    device sync) and summarise the per-slide push statistics."""
    dev = drv.device
    t0 = time.perf_counter()
    seed = drv.seed()
    sync(dev)
    seed_s = time.perf_counter() - t0
    for _ in drv.run(warmup):
        pass
    sync(dev)
    launched = segsum.LAUNCHES
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    sync(dev)
    wall = time.perf_counter() - t0
    launched = segsum.LAUNCHES - launched
    if len(stats) != steps:
        raise AssertionError(f"stream ran {len(stats)} of {steps} slides")
    b = drv.scfg.slide

    def per_slide(f):
        return sum(f(st) for st in stats) / steps

    return {
        "updates_per_s": 2 * b * steps / wall,
        "wall_s": wall,
        "seed_s": seed_s,
        "seed_rounds": seed.rounds,
        "rounds_per_slide": per_slide(lambda st: st.rounds),
        "wl_rounds_per_slide": per_slide(lambda st: st.wl_rounds),
        "scan_rounds_per_slide": per_slide(lambda st: st.scan_rounds),
        "syncs_per_slide": per_slide(lambda st: st.syncs),
        "kernel_launches_per_slide": launched / steps,
        "edge_pushes_per_s": sum(st.edge_pushes for st in stats) / wall,
    }


def profile_slides(drv: FastStreamDriver, steps: int, top: int = 10) -> dict:
    """``steps`` slides under ``torch.profiler``: wall time on the host
    clock, device busy time as the sum of the device-side kernel and copy
    times (one stream, so they do not overlap), and the ``top`` of them."""
    dev = drv.device
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = list(drv.run(steps))
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    on_dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # a profiler that sees no device activity measures nothing: say so
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 if on_dev else None
    return {
        "slides": steps, "rounds": [st.rounds for st in stats], "wall_ms": wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                for e in on_dev[:top]],
    }


def serve_check(drv: FastStreamDriver, eps_r: float, k: int) -> dict:
    """Refine twice from the same state (the second call is timed), then
    read the top-k."""
    dev = drv.device
    p0, r0 = drv.state.p.clone(), drv.state.r.clone()
    drv.refine(eps_r)
    sync(dev)
    drv.state = PprState(p=p0, r=r0, mode=drv.state.mode)
    t0 = time.perf_counter()
    st = drv.refine(eps_r)
    sync(dev)
    refine_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, ids = topk_candidates(drv.state.p, k)
    sync(dev)
    topk_ms = (time.perf_counter() - t0) * 1e3
    return {"refine_ms": refine_ms, "refine_rounds": st.rounds, "topk_ms": topk_ms,
            "ids": ids.cpu().numpy()}


def exact_contract(drv: FastStreamDriver, ids: np.ndarray, k: int, n_check: int,
                   l1_bound: float) -> dict:
    """Hold ``n_check`` sampled sources to the exact-PPR contract: L1 within
    the bound, mass conserved, mean precision@k >= 0.95. Exact PPR is a
    power iteration in f64 on the driver's device."""
    n = drv.n
    p = drv.state.p.cpu().double().numpy()
    r = drv.state.r.cpu().double().numpy()
    if not (np.isfinite(p).all() and np.isfinite(r).all()):
        raise AssertionError("non-finite state")
    cols = np.linspace(0, p.shape[1] - 1, n_check).astype(int)
    t0 = time.perf_counter()
    pis = exact_ppr(drv.hsrc, drv.hdst, n, [drv._queries[si] for si in cols],
                    drv.cfg.alpha, tol=1e-10, device=drv.device)
    exact_s = time.perf_counter() - t0
    precs, l1s, mass = [], [], []
    for si, pi in zip(cols, pis):
        precs.append(precision_at_k(ids[si], pi, k))
        l1s.append(l1_error(p[:n, si], pi))
        mass.append(abs(p[:n, si].sum() + r[:n, si].sum() - 1.0))
    res = {"sources": n_check, "precision_at_k": float(np.mean(precs)),
           "l1_max": max(l1s), "l1_mean": float(np.mean(l1s)), "l1_bound": l1_bound,
           "mass_err_max": max(mass), "exact_s": exact_s}
    if res["l1_max"] > l1_bound or res["mass_err_max"] > 1e-3 or res["precision_at_k"] < 0.95:
        raise AssertionError(f"exact-PPR contract failed: {res}")
    return res


def parity_small(dev) -> dict:
    """tests/test_torch_fast_stream.py's stream on ``dev`` in f32 against
    the CPU in f64."""
    n = 35
    src, dst, _ = synthetic_powerlaw_stream(n, 500, seed=11)
    cfg = PprConfig(alpha=0.2, eps=1e-8, max_rounds=10_000)
    scfg = StreamConfig(window=250, slide=25)
    kw = dict(rebuild_every=3, e_top=64, n_tiers=3)
    ref = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, dtype=torch.float64,
                           device="cpu", **kw)
    dut = FastStreamDriver(src, dst, n, [0, 6, 17], cfg, scfg, dtype=torch.float32,
                           device=dev, **kw)
    rounds = []
    for d in (ref, dut):
        d.seed()
        rounds.append([st.rounds for st in d.run(10)])
    err = float((dut.state.p.cpu().double() - ref.state.p).abs().max())
    if err > 1e-5:
        raise AssertionError(f"card f32 vs cpu f64: max |dp| = {err}")
    return {"max_abs_dp": err, "rounds_cpu_f64": rounds[0], "rounds_dev_f32": rounds[1]}


def kernel_entry(name: str, key: str, kern: dict, launches: dict) -> dict:
    """One entry of the kernels line from phase 3's numbers: the window
    scan's f32 figures (power-law rows) under the plain names; bf16, the
    other layouts (uniform rows, the short fresh view, and for the gather
    entry the compact round with int64 ``gat``) beside them."""
    layouts = ["", "uniform_", "short_"] + (["compact_"] if key == "gather" else [])
    whats = ["ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "share_of_bound"]
    if key == "gather":
        whats += ["pair_ms", "index_add_ms"]
    out = {
        "name": name,
        "route": "cuda",
        "source": "pprx_torch/csrc/segsum.cu",
        "replaces": "pprx/engine/segsum.py:184",
        "launches": launches[name],
        "max_abs_err": max(kern[f"{lay}{key}_{dt}_max_abs_err"]
                           for lay in layouts for dt in ("f32", "bf16")),
        "library_call": ("torch.sparse.addmm on a unit-valued CSR (a bf16 table through "
                         "table.float() first, timed with it: two calls)"
                         if key == "gather" else "index_add_ on prebuilt ids"),
    }
    for lay in layouts:
        out[f"{lay}chunk"] = kern[f"{lay}chunk"]
        for what in whats:
            out[f"{lay}{what}"] = kern[f"{lay}{key}_f32_{what}"]
            out[f"{lay}bf16_{what}"] = kern[f"{lay}{key}_bf16_{what}"]
    return out


def main() -> None:
    dev = require_cuda()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log("1 device", name=name, count=count, nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    built = _ext.build("segsum")
    _ext.load("segsum")
    ptxas = sorted({ln.split(":", 1)[1].strip() for ln in built.log.splitlines() if "Used" in ln})
    log("2 build", seconds=built.seconds, library=built.path.name, ptxas=ptxas)

    n, w, b, s = 200_000, 2_000_000, 160_000, 128
    kern = check_kernel(dev, n, w, s)
    log("3 kernel", **kern)
    torch.cuda.empty_cache()

    steps = 8
    rebuild_every = max(1, min(8, w // (6 * b)))
    warmup = rebuild_every + 2
    prof_steps = 2
    need = w + (steps + warmup + prof_steps + 1) * b
    src, dst, n = synthetic_powerlaw_stream(n, need, seed=7)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    scfg = StreamConfig(window=w, slide=b)
    queries = list(range(s))

    # the main path: every launch from here to the top-k read counts
    segsum.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    drv = FastStreamDriver(src, dst, n, queries, cfg, scfg, dtype=torch.float32,
                           rebuild_every=rebuild_every, device=dev)
    f32 = run_stream(drv, warmup, steps)
    f32["launches"] = segsum.LAUNCHES
    if f32["launches"] <= 0:
        raise AssertionError("the f32 stream never launched the segment-sum kernel")
    f32["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("4 stream f32", n=n, window=w, slide=b, sources=s, rebuild_every=rebuild_every,
        tiers=[list(t) for t in drv.tiers], **f32)
    log("4 profile", **profile_slides(drv, prof_steps))

    drv16 = FastStreamDriver(src, dst, n, queries, cfg, scfg, dtype=torch.float32,
                             rebuild_every=rebuild_every, bf16d=True, device=dev)
    l0 = segsum.LAUNCHES
    bf16 = run_stream(drv16, warmup, steps)
    bf16["launches"] = segsum.LAUNCHES - l0
    log("5 stream bf16", **bf16)
    del drv16
    torch.cuda.empty_cache()

    k = 100
    serve = serve_check(drv, eps_r=5e-8, k=k)
    launches = segsum.LAUNCHES
    by_entry = dict(segsum.LAUNCHES_BY_ENTRY)
    if launches <= 0 or sum(by_entry.values()) != launches:
        raise AssertionError(f"the main path never launched a segment-sum kernel: {by_entry}")
    contract = exact_contract(drv, serve.pop("ids"), k, 16, l1_bound=cfg.eps * w)
    log("6 serve", eps_retrieve=5e-8, k=k, **serve, **contract, launches_total=launches,
        launches_by_entry=by_entry)

    parity = parity_small(dev)
    log("7 parity", **parity)

    if "jax" in sys.modules or "pprx" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
    print(json.dumps({"kernels": [
        kernel_entry("segsum_add", "add", kern, by_entry),
        kernel_entry("segsum_gather_add", "gather", kern, by_entry),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


if __name__ == "__main__":
    main()
