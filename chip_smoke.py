"""Smoke run of the PyTorch/CUDA port (pprx_torch) on one NVIDIA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --turns [--out FILE] [--shapes TAG,...] ROOT [ROOT ...]

Drives the port's paths once on the card, and checks them: the main path
(the headline forward stream that bench.py times for the JAX package), the
reverse stream, the static configs on the dense engine, and a checkpoint
round trip. Phases, one line each:

1. device: the card's name, count and nvidia-smi name/power limit;
2. build: the three kernel sources of pprx_torch/csrc, the segment sum, the
   row passes and the loop's control, one ``nvcc`` each, started together
   (seconds, ptxas lines);
3. kernel: both entries (``segsum_add_`` and ``segsum_gather_add_``, the
   gather fused in) against their plain PyTorch versions at the shapes the
   stream gives them (R=200,001 rows, S=128: a window scan of 2.0M sorted
   power-law edges under random int32 indices into a ``[200,001, 128]``
   table; a fresh-view scan of 320k edges; a compact round of 458,752
   lanes under the int64 order of a sort) and on uniform rows, f32 and bf16;
   two launches on the same inputs must agree bit for bit; then, in turns,
   each kernel's time, its plain version's, the library call's, the pair
   the fused entry replaces, and each kernel's bound from the byte counts
   (device times: the calls are queued behind a spinning kernel; ``call_ms``
   is the same calls back to back with their host side);
   then the scaled form of both entries (``row_scale``, what reverse scans
   launch) at the window and fresh layouts, and both at S=8 (1.0M power-law
   edges, R=100,001: config 3's width), with ``torch.sparse.addmm`` on a
   CSR whose values are ``row_scale[row]`` as the library call; and, held
   to the plain version without timing, every other layout config 3's
   stream launches: window and fresh view (80k edges), scaled and not, at
   S=8 and at S=128, and its 140,000-lane compact round (int64 ``gat``);
   and the gather entry at config 4's dense rounds (R=500,001, S=512, the
   5M-edge window in its forward delivery view), timed beside its bound,
   its plain version, the library call and the parent's round's delivery
   (the gather, then ``index_add_`` in edge blocks; ``check_kernel_config4``);
3b. row passes: ``scan_pass_`` (K2, a scan round's elementwise work) and
   ``frontier_rows`` (K3, the rescan) against their plain versions, bit for
   bit with equal counts, at the headline's (R=200,001, S=128), config 2's
   (S=16), config 3's (R=100,001, S=8) and config 4's (R=500,001, S=512)
   shapes, both modes, K2 with f32
   and bf16 ``moving``, on states with entries exactly at the threshold and
   dangling rows; two launches bit for bit; in turns each kernel's device
   time, its time with the host side, its plain version's and its bound
   from the bytes this run moves (``check_rowpass``);
3c. loop control: K4 (``pprx_torch/csrc/loop.cu``: the convergence loop's
   three one-warp steps, prime, turn and after_scan) against its plain
   steps on every case of ``K4_CASES`` (a table of carries that covers
   every rule of the loop), each through the kernel the loop graph
   launches for it (``k4_launch``: a decision or a tally is a turn), whole
   carries equal; each kernel's device time, its plain step's and its
   bound; the CUDA driver's and runtime's versions; and a loop graph of
   fill-kernel branches timed by its rounds: what the WHILE, the SWITCH
   and a turn add to a round, and what a kernel node costs inside a loop's
   body (``check_k4``); the table's ``sharded_*`` cases run under the
   sharded wl engine's rule, its ``dense_*`` cases under the dense
   engine's, its ``prop_*`` cases under the proportional rule and its
   ``hybrid_*`` and ``nowl_*`` cases under the hybrid rule, with and
   without a worklist (``k4_table``), and one-arm loop graphs of the dense
   rule (0 active at the start, one round, stopped at the cap) leave the
   host loop's carry (``dense_loop_check``), as do loop graphs of the
   proportional and the hybrid rules' fill-kernel arms
   (``prop_loop_check``, ``hybrid_loop_check``). From
   here on every loop graph logs its rounds (``graphs.LOG_SINK``),
   and each phase's line replays the rounds of the loops run since the
   line before through the plain ``decide`` and ``after_scan`` on the
   counts each round logged (``round_logs``): the branches must be equal
   (a loop logs its first ``loop.LOG_CAP`` rounds: ``rounds_not_logged``
   counts the rest, which are not checked);
4. stream f32: FastStreamDriver at N=200k, W=2M, b=160k, S=128, eps=1e-6,
   alpha=0.15 (bench.py's shapes): seed, warm-up, 8 timed slides, with the
   driver's captured graphs (``graphs``: graphs and loop graphs held,
   captures and their seconds; in the timed slides the graph launches a
   slide, one a slide and a second where it rebuilds, and the rounds run
   eagerly, which should be 0); then two more slides under
   ``torch.profiler`` (a ``profile`` line: the device's busy and idle
   shares, the kernels that took the most device time, kernels inside
   launched graphs among them, and the host's launch calls a slide by API:
   ``cudaGraphLaunch`` the loops and rebuilds, the rest eager launches and
   copies) and two with a sync where the loop starts (a ``prologue`` line:
   the slide's prologue, itself one captured graph, replayed apart from its
   loop's graph);
5. stream bf16: the same segment with bf16 delivery;
6. serve: refine to eps=5e-8 (timed on the second call), top-100, and the
   exact-PPR contract on 16 sampled sources (f64 power iteration on the
   card, ``pprx_torch.ref.exact``);
7. parity: a small stream on the card in f32 against the CPU in f64;
8. reverse stream through ``FastStreamDriver(mode=REVERSE)``: config 3's
   shapes (N=100k, W=1M, b=10k, ``rebuild_every=8``, 10 warm-up and 10
   timed slides) at S=8 and at its S=128 co-batch, and bench.py's headline
   shapes in reverse (N=200k, W=2M, b=160k, S=128, ``rebuild_every=2``, 4
   warm-up and 8 timed slides, then 2 under the profiler; the captured
   rounds as in phase 4); each then
   refines to eps=5e-8 and is held to the reverse contract on up to 16
   sampled targets (``max_v |p[v, j] - M[v, t_j]| <= 2 eps`` against
   columns of M by f64 iteration on the card), with the f32 share of the
   error measured: the invariant gap ``max |p + M r - M e_t|``, the
   rounding of one slide's corrections against f64, and a cold control
   (seed and refine on the final window, no slides) that must meet
   ``2 eps``; each must launch the scaled entry and the scan pass;
9. static: ``run_config(1)`` (with its exact check) and ``run_config(4)``
   (cold dense push of 512 sources on 5M edges, top-100, 16 sampled
   sources held to exact PPR) at scale 1, on the dense engine: each push
   one launch of its loop graph and one read, its rounds K2 then K1, its
   first count K3, K4 steering (``static_check``: rounds, the loop's
   captures and their seconds, the launches by entry, peak memory);
10. checkpoint: the f32 forward driver saved mid-stream and loaded; both
   step one slide and are held to the exact-PPR contract and to each other
   (in ``p + alpha r``, which does not depend on which residuals at their
   threshold a run happened to push);
11. config 2 at its full shapes (forward, N=200k, W=2M, b=20k, S=16,
   ``rebuild_every=8``, seed 2; 10 warm-up and 10 timed slides, and 2 more
   under the profiler in the f32 run; the captured rounds as in phase 4),
   with f32 and with bf16 delivery:
   the forward contract at eps=1e-6, a refine to 5e-8, top-100, and the
   contract again with precision@100 (bf16 delivery does not conserve
   mass, on any device: that run's mass is held within 1e-4 to the same
   stream through the port on the CPU, where no kernel runs); each run
   must launch the segment sum and the scan pass;
12. dense driver: ``StreamDriver`` in both modes on a small window, with
   slides of 100 edges and of 1 edge, held to exact PPR; each loop (the
   seed's, each slide's) one loop graph launch and one read, and K1, K2,
   K3 and K4 launched (``DENSE_ENTRIES``);
13. the command line (``pprx_torch.cli.main`` called in this process, its
   output captured; ``cli_phase``) at bench.py's headline shapes: 13a
   ``convert`` of the headline stream written as text, held to the port's
   ``renumber`` of it, with the native and the Python parsers held to each
   other on its first 200k lines; 13b ``serve`` in budget mode and 13c in
   event mode on the converted file, the last read's 16 id rows held to
   exact PPR of the final window (precision@100 >= 0.95); 13d ``stream``
   with a checkpoint, ``retrieve --from-checkpoint --refine-eps``, and on
   small graphs ``static --check-exact``, a cold ``retrieve`` and ``stream
   --engine dense``; 13e ``bench`` (the headline runner at its defaults:
   precision@100 >= 0.95, L1 mean <= eps * W) and ``bench --config 2`` on
   the converted file; 13f ``python3 -m pprx_torch.cli static`` in a
   subprocess. Each run through the fast driver must launch the gather
   entry, and the static, cold and dense runs each of ``DENSE_ENTRIES``. Then
   ``serve_split``: the budget-mode loop with the slide, the budgeted
   refine and the top-k read each timed apart, with the driver's default
   ``rebuild_every`` (8, as ``serve`` runs) and with bench.py's rule (2);
14. the sharded engines (``pprx_torch.dist``) at mesh 1x1, where every
   collective is absent: 14a config 5 (``run_config(5)``'s run: N=200k,
   W=2M, b=160k, S=128, the compact-frontier engine, stream seed 5; seed, 3
   warm-up and 5 timed slides), f32 and with bf16 delivery, each held to
   exact PPR on 16 sampled sources (L1 within eps * W; mass within 1e-3 in
   f32, and in bf16 within 1e-4 of the same run through the port on the
   CPU) and its sharded top-100 to the single-device head's; each run's
   dense rounds must each launch the scan pass once and the rescan at most
   once (``14a dense rounds``);
   the wl engine's loops run as loop graphs on the card, K4 steering them
   under the sharded rule: one loop graph launch and one read of the carry
   a loop (the seed's and each slide's), no loop on the host (``graphs``),
   and K4 launched on every wl path; the loops' round logs replay;
   14b the sharding tax: ``FastStreamDriver`` on the same stream and shapes,
   timed the same way; 14c the dense sharded engine in both modes on phase
   12's stream, held to exact PPR, launching nothing; 14e ``stream --engine
   sharded-wl --mesh 1,1`` on phase 13's file and ``bench --config 5``;
   14d: each collective wrapper once through a process group of one on
   NCCL (a ``FileStore``), held to its K=1 meaning. Every run through the
   compact-frontier engine must launch the gather entry (its dense rounds'
   local-first delivery);
15. the rest of the sharded engines at mesh 1x1 on config 5's stream and
   shapes: 15a the wl engine in reverse (``config5_run(mode="reverse")``,
   with 6 slides to spare, the stream's first edges again): updates/s,
   rounds, one slide under
   the profiler, the gather entry's scaled and unscaled launches (the
   rounds' receiver 1/d_out, the row-sum sweep), the dense rounds' row
   passes as 14a holds them, peak memory, the
   reverse contract on 16 sampled
   targets, and ``FastStreamDriver`` in reverse on the same stream timed
   the same way (the reverse sharding tax); 15b anomaly (ii): on 3 slides
   the sweep through the kernel against its plain version in f64 on the
   same views (1e-5 relative to max |s|, bit for bit on repeat); 15c
   ``wlp``, forward (``config5_run(engine="wlp")``): rates, round kinds,
   its last slide under the profiler with that slide's peak memory beside
   14a's wl engine's, the exact-PPR
   contract, K1's launches by call site (both modes must run its group sum
   there), and K1 at the shape of the largest group sum of one more slide
   (its loops on the host, so that each arm's first run is eager and its
   inputs recorded: ``slide_deliveries``; its values drawn anew in
   [0, 1), ``refilled``), held to the f64 plain sum and timed beside its
   bound, its plain version and ``index_add_``; 15d a
   sharded checkpoint of 15a's driver: save and load timed apart, both
   stepped 2 slides and held to each other as phase 10 holds its pair,
   and to the reverse contract, the loaded engine's loops graphs of its
   own; 15e ``stream --engine sharded-wl --mode rev`` and ``stream
   --engine sharded-wlp`` (``--mesh 1,1``) on phase 13's file. Each path
   must launch the gather entry;
16. the hybrid engine (``HybridStreamDriver``: CSR snapshot, signed overlay,
   worklist and scan rounds; each loop one conditional graph under K4's
   hybrid rule, its scans counted by K3, its dense scans K2 then K1): 16a
   the headline runner with ``PPRX_BENCH_ENGINE=hybrid`` (its maintained
   precision@100 reported, not held: bench.py refines only the fast
   driver), then the driver forward at its defaults (``rebuild_every=4``)
   on that stream: 6 warm-up and 8 timed slides (updates/s, rounds a slide by kind, scans by
   reason, counts of the frontier and host reads a slide, rebuilds), peak
   memory, one slide under the
   profiler, the exact-PPR contract on 16 sampled sources, and
   ``FastStreamDriver`` timed the same way on the same stream (both rates
   and their ratio; at one head the two states within 1e-5 settled, and
   each one's maintained precision@100); 16d a checkpoint round trip of that driver (the
   writer's tuning carried, both stepped 2 slides, within 1e-5 settled,
   both held to the contract); 16b reverse at the headline shapes (2
   warm-up and 3 timed slides) held to the reverse contract; 16c
   ``worklist=False`` on a small stream (N=20k, W=200k, b=4k, S=16) whose
   scan rounds run sparse, held to the contract and to the worklist
   driver, then K1 at the shapes of its sparse scan and of the worklist
   driver's top and smallest tiers, from one more slide of each, as 16f;
   16e ``stream --engine hybrid`` in both modes on phase 13's file and
   ``retrieve --from-checkpoint`` on the forward stream's file (no loop:
   it reads the loaded state's top-k); 16f one more slide of 16a's driver,
   its loops on the host so that each arm's first run is eager and its
   deliveries recorded (``slide_deliveries``): K1 at the shapes of
   its top and smallest worklist tiers' deliveries (their values drawn
   anew in [0, 1)), held to the f64 plain sum and timed beside its bound,
   its plain version and ``index_add_``. Every hybrid
   loop on the card must be one loop graph launch and one read of its
   carry (``loop_tally``, the host loop refused), K1 launched once at the
   worklist or sparse-scan site for each worklist round or sparse scan the
   carries count, and every path that runs loops must launch K4's prime
   and turn, and K3 where a scan or a count ran, K1 and K2 where a dense
   scan ran (``check_hybrid_launched``); 16c's loops without a worklist
   must run a sparse scan arm, as their carries count.

Then a JSON line of the kernels, the segment sum's two entries (the
gather entry's also at the shapes 15c, 16c and 16f recorded, and its
launches by call site on the hybrid and ``wlp`` paths), the two
row passes and K4's three steps (``launches``: the main path's, phases 4 to
6, which must launch the gather entry, both row passes and every K4 step;
``launches_by_path``: every path's, each counted with the counts set to 0
before it: the main path, each of the three reverse runs of phase 8, each
config of phase 9, phase 10, each run of phase 11, phase 12, each command
of phase 13, each config 5 run and sharded command of phases 14
and 15, each hybrid run and command of phase 16), the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure
raises: the exit code is not 0 and the last line is not printed. There is no CPU path. Nothing of
JAX or of the JAX package ``pprx`` is imported.

``--turns`` compares trees on one card instead: each ROOT (the root of a
checkout of this repository) is a turn, one process started there that
imports that root's ``chip_smoke`` and ``pprx_torch`` and runs this file's
``turn_record`` over the shapes of its phases 4, 5, 8, 11, 14a and 15a
(``turn_shapes``: the headline forward in f32 and with bf16 delivery, the
headline in reverse, config 2, config 3 at S=8 on ``FastStreamDriver``
through that root's ``run_stream`` and ``profile_slides``, then 2 slides
with CUDA events around every graph launch (the device's time inside
graphs a slide, which ``torch.profiler`` misreads inside a loop graph's
conditional bodies), each then refined to 5e-8 twice from the same state,
the first call capturing the new eps's rounds; and config 5 forward in f32
and in reverse,
``config5_f32`` and ``config5_rev``, the sharded wl engine at mesh 1x1,
its spare slide profiled with its peak memory), or those ``--shapes``
names; ``--shapes`` also takes ``loop_control`` (phase 3c), ``config4``
(phase 9's cold push, twice), ``dense_driver`` (phase 12's driver,
timed), ``hybrid_small_worklist`` (16c's stream with a worklist) and
``delivery_forms`` (one root: ``delivery_forms_turn``, a recorded
slide's hybrid deliveries in both forms, sorted and scattered, at the
headline's and 16c's shapes), which no default
run drives. One summary line a shape goes to
stdout, each whole record, with the card's name and power limit, to
``--out`` (JSON lines). Compare two trees only inside one run, in turns
(A, B, B, A).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import inspect
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from pprx_torch import _ext, cli
from pprx_torch.bench import headline
from pprx_torch.bench.run import config5_run, run_config
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.device import require_cuda
from pprx_torch.dist.mesh import all_to_all_rows, gather_stats, make_row_mesh, reduce_scatter_rows
from pprx_torch.dist.retrieve import make_sharded_topk
from pprx_torch.dist.stream import ShardedStreamDriver
from pprx_torch.dist import wl as dist_wl
from pprx_torch.engine import graphs, loop, rowpass, segsum, sparse
from pprx_torch.engine.graphs import RoundGraphs, copy_into_
from pprx_torch.engine.segsum import (
    row_offsets,
    segment_ids,
    segsum_add_,
    segsum_add_plain,
    segsum_gather_add_,
    segsum_gather_add_plain,
)
from pprx_torch.engine.rowpass import (
    frontier_rows,
    frontier_rows_plain,
    scan_pass_,
    scan_pass_plain,
)
from pprx_torch.engine.sparse import arm_kinds
from pprx_torch.engine.state import FORWARD, REVERSE, PprState, settled_distance
from pprx_torch.engine.update import apply_edge_batch, edge_blocks
from pprx_torch.engine.wl2 import loop_table
from pprx_torch.eval.metrics import l1_error, precision_at_k
from pprx_torch.graph import fast_stream
from pprx_torch.graph.dynamic import WindowGraph, delivery_view
from pprx_torch.graph.fast_stream import FastStreamDriver, window_row_sums
from pprx_torch.graph import native_io
from pprx_torch.graph.hybrid_stream import TUNING as HYBRID_TUNING
from pprx_torch.graph.hybrid_stream import HybridStreamDriver
from pprx_torch.graph.io import (
    load_edge_list,
    load_packed,
    renumber,
    save_packed,
    synthetic_powerlaw_stream,
)
from pprx_torch.graph.stream import StreamDriver
from pprx_torch.io.checkpoint import (
    load_checkpoint,
    load_sharded_checkpoint,
    save_checkpoint,
    save_sharded_checkpoint,
)
from pprx_torch.ref.exact import (
    exact_ppr,
    exact_ppr_columns,
    ppr_matrix_times,
    reverse_invariant_gap,
)
from pprx_torch.retrieve.topk import topk_candidates
from pprx_torch.sync import sync

# the streams' shapes: phases 4-6 (the headline), 8 (config 3 and the
# headline in reverse) and 11 (config 2; its S is C2_S, below)
HEADLINE = dict(n=200_000, w=2_000_000, b=160_000, s=128, steps=8, prof_steps=2, seed=7)
CONFIG3 = dict(n=100_000, w=1_000_000, b=10_000, rebuild_every=8, warmup=10, steps=10, seed=3)
CONFIG2 = dict(n=200_000, w=2_000_000, b=20_000, rebuild_every=8, warmup=10, steps=10, seed=2)


def headline_schedule(w: int, b: int) -> tuple[int, int]:
    """(rebuild_every, warm-up slides) of the headline stream."""
    rebuild_every = max(1, min(8, w // (6 * b)))
    return rebuild_every, rebuild_every + 2


KERNEL_TOL = 1e-4  # rtol = atol: f32 sums of up to ~4e4 terms in [0, 1)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, same sheet


def log(phase: str, **kw) -> None:
    """One phase's line; where loops were logged since the last line
    (``graphs.LOG_SINK``), their rounds replayed first (``round_logs``)."""
    if graphs.LOG_SINK:
        kw["round_logs"] = check_round_logs()
    print(f"[{phase}] " + json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, primed: bool = True, host_paced: list | None = None) -> float:
    """Mean ms per call from CUDA events, after a warm-up. ``primed``: the
    calls are queued behind a few ms of spinning on the device, so that the
    events see the device's time even where the host takes longer to issue
    a call than the device to run it (a narrow state: tens of microseconds
    of wrapper against a kernel of ten). Without: calls back to back as a
    caller issues them, the larger of the host's and the device's time.
    ``host_paced`` gets a True where the device had already run the last
    call when the host had issued it (the spinning did not cover the
    issuing, or ``fn`` waits for the device itself): that time is not the
    device's alone."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if primed:
        torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    if host_paced is not None:
        host_paced.append(end.query())
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the f32 operations over the peak rate outside the tensor
    cores (NVIDIA's data sheet for the H100 SXM), and which of the two."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def in_turns(fns: dict, rounds: int = 2, primed: bool = True,
             host_paced: set | None = None) -> dict:
    """Mean ms of each function (``cuda_ms``), timed in turns: every one
    once, then every one again. ``host_paced`` gets the names of those
    whose time was, in any turn, not the device's alone."""
    times = {k: [] for k in fns}
    paced = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            times[k].append(cuda_ms(fn, primed=primed, host_paced=paced[k]))
    if host_paced is not None:
        host_paced.update(k for k, v in paced.items() if any(v))
    return {k: float(np.mean(v)) for k, v in times.items()}


NARROW_CHUNKS = (32, 64, 128, 256, 512)


def chunk_sweep(fns: dict) -> dict:
    """Device ms of each kernel call with the wrapper's choice of chunk
    replaced by each of ``NARROW_CHUNKS`` (``segsum.chunk_for``, as the card
    tests replace it to force a split), all in turns: the sweep behind
    ``segsum.CHUNK_NARROW``. ``<name>_ms_by_chunk``: chunk -> ms."""
    own = segsum.chunk_for

    def forced(chunk, fn):
        def call():
            segsum.chunk_for = lambda n_edges, s: chunk
            fn()
        return call

    try:
        ms = in_turns({(k, c): forced(c, fn) for k, fn in fns.items() for c in NARROW_CHUNKS})
    finally:
        segsum.chunk_for = own
    return {f"{k}_ms_by_chunk": {c: ms[k, c] for c in NARROW_CHUNKS} for k in fns}


def held_to_plain(tag: str, kernel, plain_f64: torch.Tensor, rin: torch.Tensor) -> float:
    """Run ``kernel`` twice on copies of ``rin``: the results must agree
    with the plain version's f64 sum within KERNEL_TOL and with each other
    bit for bit. Returns the largest absolute difference."""
    out, again = kernel(rin.clone()), kernel(rin.clone())
    sync(out.device)
    if not torch.equal(out, again):
        raise AssertionError(f"kernel {tag}: two launches on the same inputs differ")
    err = float((out.double() - plain_f64).abs().max())
    if not torch.allclose(out.double(), plain_f64, rtol=KERNEL_TOL, atol=KERNEL_TOL):
        raise AssertionError(f"kernel {tag} disagrees with the plain version: max abs err {err}")
    return err


def check_layout(layout: str, rin, row_off, table, gat, contrib=None, row_scale=None,
                 timed: bool = True, touched_rows: bool = False) -> dict:
    """One edge layout: the gather entry (and ``segsum_add_`` where
    ``contrib`` is given) against the plain version's f64 sum of the same
    values, f32 and bf16 sources, repeat launches bit for bit. Then the
    times, in turns: each kernel; the plain version; the library call
    (``index_add_`` on ids prebuilt from the offsets; for the gather entry a
    CSR sparse product ``torch.sparse.addmm`` with unit values, which for a
    bf16 table needs ``table.float()`` first, timed with it: two calls);
    and for the gather entry the pair it replaces (``table[gat]``, then
    ``segsum_add_``) and ``index_add_`` of ``table[gat]``. With
    ``row_scale`` (f32 ``[rows]``) every one of them computes the scaled
    sum; the library call is then one ``torch.sparse.addmm`` for either
    entry, on a CSR whose values are ``row_scale[row]`` (columns ``gat``, or
    the edge's own position for ``segsum_add_``), and the pair and
    ``index_add_`` figures are left out. Bounds from this layout's byte and
    operation counts: the edges the offsets cover, the table rows they
    name, ``rin`` read and written (with ``touched_rows`` only its rows
    that hold an edge: the kernel touches no other, and a group sum's
    ``rin`` has a row a lane), the scale read. ``timed=False`` holds
    the entries to the plain version and times nothing. The times are the
    device's (``cuda_ms`` primed); ``*_call_ms`` are each kernel's and its
    library call's with the calls issued back to back, host side included;
    a narrow state's kernels are also timed at forced chunks (``chunk_sweep``).
    ``<layout>host_paced`` names the timed calls whose time is not the
    device's alone (the plain versions read two offsets back, so they wait
    for the device in every call).
    Keys:
    ``<layout><entry>_<dtype>_<what>``."""
    rows, s = rin.shape
    lo, hi = int(row_off[0]), int(row_off[-1])
    used = hi - lo  # edges this run's offsets cover
    ids = segment_ids(row_off)
    res = {
        f"{layout}edges": gat.shape[0], f"{layout}edges_used": used,
        f"{layout}gat": str(gat.dtype).split(".")[-1],
        f"{layout}chunk": segsum.chunk_for(gat.shape[0], s),
        f"{layout}max_row_edges": int(row_off.diff().max()),
    }
    scaled = row_scale is not None
    rw_rows = int((row_off.diff() > 0).sum()) if touched_rows else rows
    rin_bytes = 2 * rw_rows * s * 4 + (rows + 1) * 4 + scaled * rows * 4
    if timed:
        table_rows = int(gat[lo:hi].unique().numel())
        values = row_scale[ids] if scaled else torch.ones(used, device=rin.device)
        crow = (row_off - lo).to(gat.dtype)
        csr = torch.sparse_csr_tensor(crow, gat[lo:hi], values, size=(rows, table.shape[0]))
    scale64 = row_scale.double() if scaled else None
    host_paced = set()  # timed calls that the spinning did not cover
    for dt in ("f32", "bf16"):
        tb = table if dt == "f32" else table.to(torch.bfloat16)
        add, gather = f"{layout}add_{dt}", f"{layout}gather_{dt}"
        ref = segsum_gather_add_plain(rin.double(), tb.double(), gat, row_off, scale64)
        res[f"{gather}_max_abs_err"] = held_to_plain(
            gather, lambda r: segsum_gather_add_(r, tb, gat, row_off, row_scale), ref, rin)
        del ref
        if contrib is not None:
            c = contrib if dt == "f32" else contrib.to(torch.bfloat16)
            ref = segsum_add_plain(rin.double(), c.double(), row_off, scale64)
            res[f"{add}_max_abs_err"] = held_to_plain(
                add, lambda r: segsum_add_(r, c, row_off, row_scale), ref, rin)
            del ref
        if not timed:
            continue
        acc = rin.clone()
        fns = {
            f"{gather}_library_ms": lambda: torch.sparse.addmm(acc, csr, tb.float()),
            f"{gather}_ms": lambda: segsum_gather_add_(acc, tb, gat, row_off, row_scale),
            f"{gather}_plain_ms": lambda: segsum_gather_add_plain(acc, tb, gat, row_off, row_scale),
        }
        if not scaled:
            fns[f"{gather}_pair_ms"] = lambda: segsum_add_(acc, tb[gat], row_off)
            fns[f"{gather}_index_add_ms"] = lambda: acc.index_add_(
                0, ids, tb[gat[lo:hi]].to(acc.dtype))
        entries = [gather]
        if contrib is not None:
            if scaled:
                own = torch.sparse_csr_tensor(
                    crow, torch.arange(used, device=rin.device, dtype=gat.dtype), values,
                    size=(rows, used))
                fns[f"{add}_library_ms"] = lambda: torch.sparse.addmm(acc, own, c[lo:hi].float())
            else:
                fns[f"{add}_library_ms"] = lambda: acc.index_add_(0, ids, c[lo:hi].to(acc.dtype))
            fns[f"{add}_ms"] = lambda: segsum_add_(acc, c, row_off, row_scale)
            fns[f"{add}_plain_ms"] = lambda: segsum_add_plain(acc, c, row_off, row_scale)
            res[f"{add}_bound_ms"], res[f"{add}_bound_by"] = bound_ms(
                used * s * c.element_size() + rin_bytes, used * s)
            entries.append(add)
        res.update(in_turns(fns, host_paced=host_paced))
        if segsum.lanes_for(s)[1] < segsum.WARP:
            res.update(chunk_sweep({k: fns[f"{k}_ms"] for k in entries}))
        # the same calls back to back, host side included
        res.update(in_turns({f"{k}{what}call_ms": fns[f"{k}{what}ms"] for k in entries
                             for what in ("_", "_library_")}, primed=False))
        res[f"{gather}_bound_ms"], res[f"{gather}_bound_by"] = bound_ms(
            table_rows * s * tb.element_size() + used * gat.element_size() + rin_bytes,
            used * s)
        for k in entries:
            res[f"{k}_share_of_bound"] = res[f"{k}_bound_ms"] / res[f"{k}_ms"]
    if timed:
        res[f"{layout}host_paced"] = sorted(host_paced)
    return res


def launch_floor(rows: int, s: int, dev) -> dict:
    """ms of each entry's call when both launches run and move nothing: an
    edge array of two of its chunks under offsets that cover no edge, so
    every warp returns at once. ``*_launch_floor_ms`` is the device's time
    for the two launches; ``*_call_floor_ms`` the same calls back to back,
    with the wrapper and the scratch's allocation: what the host needs to
    issue one call. No call at this width can take less than either."""
    n_edges = 2 * segsum.chunk_for(1, s)
    off = torch.zeros(rows + 1, dtype=torch.int32, device=dev)
    rin = torch.zeros((rows, s), device=dev)
    contrib = torch.zeros((n_edges, s), device=dev)
    gat = torch.zeros(n_edges, dtype=torch.int32, device=dev)
    before = dict(segsum.LAUNCHES)
    fns = {"add": lambda: segsum_add_(rin, contrib, off),
           "gather": lambda: segsum_gather_add_(rin, contrib, gat, off)}
    res = in_turns({f"{k}_launch_floor_ms": fn for k, fn in fns.items()})
    res.update(in_turns({f"{k}_call_floor_ms": fn for k, fn in fns.items()}, primed=False))
    if segsum.launches(since=before) != 2 * 2 * 2 * 23 or bool(rin.any()):
        raise AssertionError("the launch floor's calls did not launch, or moved something")
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
    # the scaled form, as reverse scans launch it: one 1/d_out per row
    scale = 1.0 / torch.randint(1, 200, (rows,), generator=gen, device=dev).float()
    res.update(check_layout("scaled_", rin, row_offsets(powerlaw, rows), table, gat, contrib,
                            row_scale=scale))
    res.update(check_layout("scaled_short_", rin, row_offsets(short, rows), table,
                            gat[:SHORT_EDGES].contiguous(),
                            contrib[:SHORT_EDGES].contiguous(), row_scale=scale))
    del contrib, table, gat
    keys = torch.from_numpy(dst[:COMPACT_LANES].astype(np.int64)).to(dev)
    masked = torch.rand(COMPACT_LANES, generator=gen, device=dev) < 1 / 3
    keys_s, order = torch.sort(torch.where(masked, n, keys), stable=True)
    vals = torch.rand((COMPACT_LANES, s), generator=gen, device=dev)
    res.update(check_layout("compact_", rin[:n], row_offsets(keys_s, n), vals, order))
    return res


# config 3: N=100k, W=1M, and 8 slides of 10k edges in a full fresh view
C3_ROWS, C3_EDGES, C3_FRESH = 100_001, 1_000_000, 80_000
C3_COMPACT_LANES = 140_000  # its top tier's compact round at S=128: 40,000 + 80,000 + 20,000
# config 2: N=200k, W=2M, and 8 slides of 20k edges in a full fresh view
C2_ROWS, C2_EDGES, C2_FRESH, C2_S = 200_001, 2_000_000, 160_000, 16
OTHER_WIDTHS = (1, 3, 4, 32, 64, 100)  # held, not timed


def check_kernel_config3(dev) -> dict:
    """The entries at every layout config 3's reverse stream gives them, at
    S=8 (``s8_*``) and at its S=128 co-batch (``c3_*``): the window view
    (1.0M power-law edges sorted by ``src``, where reverse mode delivers)
    and a full fresh view (80k edges, smaller chunks), each with the per-row
    scale (a scan's delivery) and without (the row sums of the corrections);
    and at S=128 the top tier's compact round (140,000 lanes under the int64
    order of a stable sort, a third on the phantom row, ``rin`` a view of
    ``n`` rows; at S=8 that round has 71,680 lanes, under the sorted
    delivery's threshold). At S=8 two lanes cover an edge and a warp step
    takes 16 edges: all four layouts are timed there, both entries, with the
    launch floor; at S=128 they are held to the plain version only. Then,
    untimed, the window view with the scale (both entries) and the fresh
    view without at S = 1, 3, 4, 32, 64 and 100: the other lanes-per-edge
    counts, a width of one column a lane, and widths whose last lane is
    idle."""
    n = C3_ROWS - 1
    src, _, _ = synthetic_powerlaw_stream(n, C3_EDGES, seed=3)
    gen = torch.Generator(device=dev).manual_seed(1)
    window = torch.from_numpy(np.sort(src)).to(dev)
    fresh = window[::C3_EDGES // C3_FRESH][:C3_FRESH].contiguous()
    off, fresh_off = row_offsets(window, C3_ROWS), row_offsets(fresh, C3_ROWS)
    gat = torch.randint(0, C3_ROWS, (C3_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    fresh_gat = gat[:C3_FRESH].contiguous()
    scale = 1.0 / torch.randint(1, 200, (C3_ROWS,), generator=gen, device=dev).float()
    res = {}
    for s, tag in ((8, "s8_"), (128, "c3_")) + tuple((s, f"s{s}_") for s in OTHER_WIDTHS):
        contrib = torch.rand((C3_EDGES, s), generator=gen, device=dev)
        table = torch.rand((C3_ROWS, s), generator=gen, device=dev)
        rin = torch.rand((C3_ROWS, s), generator=gen, device=dev)
        fresh_contrib = contrib[:C3_FRESH].contiguous() if s == 8 else None
        res.update(check_layout(tag, rin, off, table, gat, contrib, row_scale=scale,
                                timed=s == 8))
        res.update(check_layout(f"{tag}fresh_unscaled_", rin, fresh_off, table, fresh_gat,
                                fresh_contrib, timed=s == 8))
        if s in OTHER_WIDTHS:
            continue
        res.update(check_layout(f"{tag}unscaled_", rin, off, table, gat, contrib, timed=s == 8))
        res.update(check_layout(f"{tag}fresh_", rin, fresh_off, table, fresh_gat,
                                fresh_contrib, row_scale=scale, timed=s == 8))
        if s == 8:
            res.update({f"{tag}{k}": v for k, v in launch_floor(C3_ROWS, s, dev).items()})
            continue
        del contrib, table
        keys = torch.from_numpy(src[:C3_COMPACT_LANES].astype(np.int64)).to(dev)
        masked = torch.rand(C3_COMPACT_LANES, generator=gen, device=dev) < 1 / 3
        keys_s, order = torch.sort(torch.where(masked, n, keys), stable=True)
        vals = torch.rand((C3_COMPACT_LANES, s), generator=gen, device=dev)
        res.update(check_layout("c3_compact_", rin[:n], row_offsets(keys_s, n), vals, order,
                                timed=False))
    return res


def check_kernel_config2(dev) -> dict:
    """The entries at the layouts config 2's forward stream gives them
    (``s16_*``: S=16, four lanes an edge, eight edges a warp step; no
    scale): the window view (2.0M power-law edges sorted by ``dst``, where
    forward mode delivers) and a full fresh view (160k edges), both entries,
    f32 and bf16, timed, with the launch floor."""
    n, s = C2_ROWS - 1, C2_S
    _, dst, _ = synthetic_powerlaw_stream(n, C2_EDGES, seed=2)
    gen = torch.Generator(device=dev).manual_seed(2)
    window = torch.from_numpy(np.sort(dst)).to(dev)
    fresh = window[::C2_EDGES // C2_FRESH][:C2_FRESH].contiguous()
    gat = torch.randint(0, C2_ROWS, (C2_EDGES,), generator=gen, device=dev, dtype=torch.int32)
    contrib = torch.rand((C2_EDGES, s), generator=gen, device=dev)
    table = torch.rand((C2_ROWS, s), generator=gen, device=dev)
    rin = torch.rand((C2_ROWS, s), generator=gen, device=dev)
    res = check_layout("s16_", rin, row_offsets(window, C2_ROWS), table, gat, contrib)
    res.update(check_layout("s16_fresh_", rin, row_offsets(fresh, C2_ROWS), table,
                            gat[:C2_FRESH].contiguous(), contrib[:C2_FRESH].contiguous()))
    res.update({f"s16_{k}": v for k, v in launch_floor(C2_ROWS, s, dev).items()})
    return res


# config 4: N=500k, 5M edges, S=512 (the dense engine's static push)
C4_N, C4_EDGES, C4_S, C4_SEED = 500_000, 5_000_000, 512, 4
C4_REF_BLOCK = 1 << 19  # edges of the f64 reference's gathered rows at once


def check_kernel_config4(dev, n: int = C4_N, n_edges: int = C4_EDGES, s: int = C4_S) -> dict:
    """The gather entry at the shape config 4's dense rounds give it
    (``c4_*``): R = n + 1 rows, S = 512, the window of ``n_edges``
    power-law edges (config 4's graph, stream seed 4) in its forward
    delivery view (sorted by ``dst``, ``gat`` its ``src``,
    ``pprx_torch.graph.dynamic.delivery_view``), ``rin`` the ``n`` real
    rows of ``r``, a random f32 table for ``moving``. Held to the plain
    sum in f64 (summed in edge blocks) within KERNEL_TOL, two launches bit
    for bit; then, in turns, device times of the kernel, its plain version
    (``segsum_gather_add_plain``), the library call
    (``torch.sparse.addmm`` on a unit CSR, as phase 3) and the parent's
    round's delivery (``parent_ms``: the gather then ``index_add_`` in edge
    blocks over the ring as it lies, ``push_round``'s forward delivery),
    the kernel's and the library call's with the host side, and the bound
    from this run's bytes (each table row the edges name, ``gat``, ``rin``
    read and written, the offsets) and its f32 additions."""
    src, dst, n = synthetic_powerlaw_stream(n, n_edges, seed=C4_SEED)
    window = WindowGraph.from_coo(src, dst, n, device=dev)
    view = delivery_view(window, FORWARD)
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = n + 1
    table = torch.rand((rows, s), generator=gen, device=dev)
    rin = torch.rand((n, s), generator=gen, device=dev)
    gat, off = view.gat, view.off
    used = int(off[-1] - off[0])
    tag = "c4_gather_f32"
    res = {"c4_rows": rows, "c4_s": s, "c4_edges": n_edges, "c4_edges_used": used,
           "c4_chunk": segsum.chunk_for(gat.shape[0], s),
           "c4_max_row_edges": int(off.diff().max())}
    ids = segment_ids(off)
    ref = rin.double()
    for lo in range(0, used, C4_REF_BLOCK):
        hi = min(lo + C4_REF_BLOCK, used)
        ref.index_add_(0, ids[lo:hi], table[gat[lo:hi]].double())
    res[f"{tag}_max_abs_err"] = held_to_plain(
        tag, lambda r: segsum_gather_add_(r, table, gat, off), ref, rin)
    del ref
    acc = rin.clone()
    csr = torch.sparse_csr_tensor(off.to(torch.int32), gat[:used], torch.ones(used, device=dev),
                                  size=(n, rows))
    ring_src, ring_dst = window.src, window.dst
    row_bytes = s * 4

    def parent():
        for lo, hi in edge_blocks(n_edges, row_bytes):
            acc.index_add_(0, ring_dst[lo:hi], table[ring_src[lo:hi]])

    fns = {f"{tag}_ms": lambda: segsum_gather_add_(acc, table, gat, off),
           f"{tag}_plain_ms": lambda: segsum_gather_add_plain(acc, table, gat, off),
           f"{tag}_library_ms": lambda: torch.sparse.addmm(acc, csr, table),
           f"{tag}_parent_ms": parent}
    res.update(in_turns(fns))
    res.update(in_turns({f"{tag}_call_ms": fns[f"{tag}_ms"],
                         f"{tag}_library_call_ms": fns[f"{tag}_library_ms"]}, primed=False))
    table_rows = int(gat[:used].unique().numel())
    res[f"{tag}_bound_ms"], res[f"{tag}_bound_by"] = bound_ms(
        table_rows * s * 4 + used * 4 + 2 * n * s * 4 + rows * 4, used * s)
    res[f"{tag}_share_of_bound"] = res[f"{tag}_bound_ms"] / res[f"{tag}_ms"]
    res["c4_table_rows_read"] = table_rows
    return res


# phase 3b: the row passes at the streams' shapes: (tag, rows, S, stream
# seed, window) of the headline, config 2, config 3 and config 4
ROWPASS_SHAPES = (("headline", HEADLINE["n"] + 1, HEADLINE["s"], HEADLINE["seed"], HEADLINE["w"]),
                  ("config2", C2_ROWS, C2_S, CONFIG2["seed"], CONFIG2["w"]),
                  ("config3", C3_ROWS, 8, CONFIG3["seed"], CONFIG3["w"]),
                  ("config4", C4_N + 1, C4_S, C4_SEED, C4_EDGES))
ROWPASS_EPS, ROWPASS_ALPHA = 1e-6, 0.15
ROWPASS_AT_THRESHOLD = 1000  # entries set exactly at the threshold: not active


def window_degrees(dev, rows: int, seed: int, w: int) -> torch.Tensor:
    """int32 out-degrees of a stream's first window of ``w`` edges, the
    phantom row's 0."""
    src, _, _ = synthetic_powerlaw_stream(rows - 1, w, seed=seed)
    deg = torch.from_numpy(np.bincount(src, minlength=rows).astype(np.int32)).to(dev)
    deg[-1:].fill_(0)
    return deg


def rowpass_inputs(deg: torch.Tensor, s: int, seed: int, forward: bool) -> dict:
    """A state at a scan round's start on the degrees ``deg`` (dangling
    rows among them): ``p`` in [0, 1e-3), ``|r|`` uniform below twice each
    row's push threshold (about half of the pairs active, at both signs),
    ``ROWPASS_AT_THRESHOLD`` entries exactly at it, the phantom row zero;
    ``row_len`` the degrees, ``f_len`` a few fresh edges a row."""
    dev, rows = deg.device, deg.shape[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    th = ROWPASS_EPS * deg.clamp(min=1).float() if forward else torch.full(
        (rows,), ROWPASS_EPS, device=dev)
    r = (torch.rand((rows, s), generator=gen, device=dev) * 4 - 2) * th[:, None]
    at = torch.randint(0, (rows - 1) * s, (ROWPASS_AT_THRESHOLD,), generator=gen, device=dev)
    r.view(-1)[at] = th.repeat_interleave(s)[at] * torch.sign(r.view(-1)[at])
    r[-1] = 0.0
    p = torch.rand((rows, s), generator=gen, device=dev) * 1e-3
    p[-1] = 0.0
    f_len = torch.randint(0, 4, (rows,), generator=gen, device=dev, dtype=torch.int32)
    return {"p": p, "r": r, "deg": deg, "row_len": deg.clone(), "f_len": f_len,
            "dangling_rows": int((deg[:-1] == 0).sum())}


def _scan_outputs(fn, inp: dict, forward: bool, mdt) -> list:
    """``fn`` (``scan_pass_`` or its plain version) on copies of the state:
    p, r, moving, counts and (reverse) each row's count."""
    p, r = inp["p"].clone(), inp["r"].clone()
    moving = torch.empty(r.shape, dtype=mdt, device=r.device)
    counts = torch.zeros(2, dtype=torch.int64, device=r.device)
    row_act = None if forward else torch.empty(r.shape[0], dtype=torch.int32, device=r.device)
    fn(p, r, inp["deg"], moving, counts, row_act, eps=ROWPASS_EPS, alpha=ROWPASS_ALPHA,
       forward=forward)
    return [p, r, moving, counts] + ([] if forward else [row_act])


def bit_for_bit(tag: str, got: list, again: list, plain: list) -> float:
    """Two launches must give the same bits, and the plain version's: every
    output, floats and counts. Returns the largest absolute difference from
    the plain version (0 where the bits agree)."""
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: two launches on the same inputs differ")
    err = max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, plain))
    for a, b in zip(got, plain):
        if a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"{tag}: the kernel's bits are not the plain version's "
                                 f"(max abs err {err}; {a.dtype} against {b.dtype})")
    return err


def check_rowpass(dev) -> dict:
    """Phase 3b: ``scan_pass_`` (K2) and ``frontier_rows`` (K3) against
    their plain versions on the card, bit for bit with equal counts, at the
    headline's, config 2's and config 3's shapes, both modes, K2 with f32
    and with bf16 ``moving``; two launches bit for bit. Then, in turns, each
    kernel's device time (``ms``, calls queued behind a spinning kernel),
    the same calls back to back with their host side (``call_ms``), the
    plain version's time, and the bound from this run's bytes: K2 reads
    ``r``, ``p`` and ``deg`` and writes ``r``, ``p``, ``moving`` (and in
    reverse ``row_act``); K3 reads ``r`` (and forward ``deg``), the two
    lengths of the rows it finds active, and writes one byte a row. No
    single PyTorch call computes either: ``library_ms`` is null. Keys:
    ``<shape>_<fwd|rev>_<scan_pass_f32|scan_pass_bf16|frontier_rows>_<what>``."""
    res = {}
    for shape, rows, s, seed, w in ROWPASS_SHAPES:
        deg = window_degrees(dev, rows, seed, w)
        for forward in (True, False):
            inp = rowpass_inputs(deg, s, seed, forward)
            pre = f"{shape}_{'fwd' if forward else 'rev'}_"
            res[f"{pre}rows"], res[f"{pre}s"] = rows, s
            res[f"{pre}dangling_rows"] = inp["dangling_rows"]
            elems = rows * s
            for mdt, dt in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
                tag = f"{pre}scan_pass_{dt}"
                got = _scan_outputs(scan_pass_, inp, forward, mdt)
                again = _scan_outputs(scan_pass_, inp, forward, mdt)
                plain = _scan_outputs(scan_pass_plain, inp, forward, mdt)
                res[f"{tag}_max_abs_err"] = bit_for_bit(tag, got, again, plain)
                res[f"{tag}_active_pairs"] = int(got[3][0])
                del got, again, plain
                p, r = inp["p"].clone(), inp["r"].clone()
                moving = torch.empty(r.shape, dtype=mdt, device=dev)
                counts = torch.zeros(2, dtype=torch.int64, device=dev)
                row_act = None if forward else torch.empty(rows, dtype=torch.int32, device=dev)
                kw = dict(eps=ROWPASS_EPS, alpha=ROWPASS_ALPHA, forward=forward)
                args = (p, r, inp["deg"], moving, counts, row_act)
                fns = {f"{tag}_ms": lambda: scan_pass_(*args, **kw),
                       f"{tag}_plain_ms": lambda: scan_pass_plain(*args, **kw)}
                res.update(in_turns(fns))
                res.update(in_turns({f"{tag}_call_ms": fns[f"{tag}_ms"]}, primed=False))
                n_bytes = elems * (4 * 4 + moving.element_size()) + rows * 4 * (1 + (not forward))
                res[f"{tag}_bound_ms"], res[f"{tag}_bound_by"] = bound_ms(n_bytes, 8 * elems)
                res[f"{tag}_share_of_bound"] = res[f"{tag}_bound_ms"] / res[f"{tag}_ms"]
                del p, r, moving, args, fns
            tag = f"{pre}frontier_rows"
            view = (inp["r"][:-1], inp["deg"][:-1], inp["row_len"][:-1], inp["f_len"][:-1])
            kw = dict(eps=ROWPASS_EPS, forward=forward)
            plain = frontier_rows_plain(*view, **kw)
            got, again = frontier_rows(*view, **kw), frontier_rows(*view, **kw)
            res[f"{tag}_max_abs_err"] = bit_for_bit(tag, list(got), list(again), list(plain))
            res[f"{tag}_rows_active"] = n_hit = int(got[1])
            fns = {f"{tag}_ms": lambda: frontier_rows(*view, **kw),
                   f"{tag}_plain_ms": lambda: frontier_rows_plain(*view, **kw)}
            res.update(in_turns(fns))
            res.update(in_turns({f"{tag}_call_ms": fns[f"{tag}_ms"]}, primed=False))
            n = rows - 1
            n_bytes = n * s * 4 + forward * n * 4 + n_hit * 8 + n
            res[f"{tag}_bound_ms"], res[f"{tag}_bound_by"] = bound_ms(n_bytes, 2 * n * s)
            res[f"{tag}_share_of_bound"] = res[f"{tag}_bound_ms"] / res[f"{tag}_ms"]
            del inp, view, got, again, plain, fns
        torch.cuda.empty_cache()
    return res


# ---- K4, the loop's control (pprx_torch/csrc/loop.cu), held to its plain
# steps (pprx_torch/engine/loop.py) on a table of carries that covers every
# rule of the loop. The ladder: three tiers, none of which reseeds by a
# rescan at n = 1000, so each emits its next tier's width (64, 256, 256);
# a scan is heavy above STATS_GUARD * (2048 + 64) = 4224 edge work.
K4_TABLE = loop_table(((8, 32, 4), (64, 512, 16), (256, 2048, 64)), 1000)
# every case starts from this carry (a loop two rounds in, one compact and
# one scan, at most 6 rounds), then sets its own slots
K4_BASE = {loop.ROUNDS: 2, loop.MAX_ROUNDS: 6, loop.C0OK: 1, loop.OK: 1, loop.CN: 1,
           loop.FED: 1, loop.FRE: 1, loop.NA: 3, loop.EW: 40, loop.PUSHES: 100,
           loop.EDGE_PUSHES: 1000, loop.WL_ROUNDS: 1, loop.SCANS_CAND: 1,
           loop.EXECS: 1, loop.EXECS + 3: 1}
_Z = (0, 0, 0, 0, 0)
_Z6 = _Z + (0,)
# the sharded wl engine's rule on the same ladder (pprx_torch.dist.wl in a
# world of one shard): every tier emits the candidate buffer's width, n + 1
K4_SHARDED = dataclasses.replace(K4_TABLE, emit=(1001,) * 3, rule=loop.SHARDED)
# the memory-proportional rule (wlp in a world of one shard) on the same
# ladder, whose top tier takes any list: arms the tiers 0-2, the drain 3 and
# the rescan 4; no stats-skip
K4_PROPORTIONAL = dataclasses.replace(K4_SHARDED, heavy_ew=0, rule=loop.PROPORTIONAL)
# the hybrid rule (the hybrid engine's worklist loop) on the same ladder:
# arms the tiers 0-2, the scan tiers 3-5, the dense scan 6 and the count 7;
# a sparse scan is worth it where its frontier's edges are at most
# 10,000 / 2 - 100 = 4900
K4_HYBRID = loop.hybrid_table(K4_TABLE.tiers, ((8, 32), (64, 512), (1001, 8192)), 100, 10_000)
# and its loop without a worklist: the scan 0, the dense scan 1, the count 2
K4_NOWL = loop.hybrid_table((), ((1001, 8192),), 100, 10_000)
# (name, step, the case's slots, counts: cn, fed, fre, n_active, edge_work)
# under K4_TABLE; the sharded_* cases under K4_SHARDED, the dense_* cases
# under loop.DENSE_TABLE, the prop_* cases under K4_PROPORTIONAL, the
# hybrid_* cases under K4_HYBRID and the nowl_* cases under K4_NOWL
# (k4_table)
K4_CASES = (
    # prime: an invalid list, an empty valid one, a valid one, no rounds
    ("prime_invalid_list", "prime", {loop.C0OK: 0}, (5, 10, 1, 0, 0)),
    ("prime_empty_list", "prime", {loop.C0OK: 1}, _Z),
    ("prime_valid_list", "prime", {loop.C0OK: 1}, (3, 9, 2, 0, 0)),
    ("prime_no_rounds", "prime", {loop.C0OK: 0, loop.MAX_ROUNDS: 0}, (3, 9, 2, 0, 0)),
    # decide: an invalid list; each count on and past each tier's border
    ("decide_invalid_list", "decide", {loop.OK: 0}, _Z),
    ("decide_tier0_border", "decide", {loop.CN: 8, loop.FED: 32, loop.FRE: 4}, _Z),
    ("decide_cn_past_tier0", "decide", {loop.CN: 9, loop.FED: 32, loop.FRE: 4}, _Z),
    ("decide_fed_past_tier0", "decide", {loop.CN: 8, loop.FED: 33, loop.FRE: 4}, _Z),
    ("decide_fre_past_tier0", "decide", {loop.CN: 8, loop.FED: 32, loop.FRE: 5}, _Z),
    ("decide_tier1_border", "decide", {loop.CN: 64, loop.FED: 512, loop.FRE: 16}, _Z),
    ("decide_cn_past_tier1", "decide", {loop.CN: 65, loop.FED: 512, loop.FRE: 16}, _Z),
    ("decide_fed_skips_tier1", "decide", {loop.CN: 9, loop.FED: 600, loop.FRE: 0}, _Z),
    ("decide_top_border", "decide", {loop.CN: 256, loop.FED: 2048, loop.FRE: 64}, _Z),
    ("decide_cn_past_top", "decide", {loop.CN: 257, loop.FED: 0, loop.FRE: 0}, _Z),
    ("decide_fed_past_top", "decide", {loop.CN: 0, loop.FED: 2049, loop.FRE: 0}, _Z),
    ("decide_fre_past_top", "decide", {loop.CN: 0, loop.FED: 0, loop.FRE: 65}, _Z),
    ("decide_skip_sentinel", "decide", {loop.CN: loop.BIG, loop.FED: loop.BIG,
                                        loop.FRE: loop.BIG}, _Z),
    ("decide_past_the_log", "decide", {loop.ROUNDS: loop.LOG_CAP}, _Z),
    # after_scan: light and heavy scans, no active pair, the last round
    ("after_scan_light", "after_scan", {loop.BRANCH: 3}, (0, 0, 0, 7, 4224)),
    ("after_scan_heavy", "after_scan", {loop.BRANCH: 3}, (0, 0, 0, 7, 4225)),
    ("after_scan_no_active", "after_scan", {loop.BRANCH: 3}, (0, 0, 0, 0, 10)),
    ("after_scan_last_round", "after_scan", {loop.BRANCH: 3, loop.ROUNDS: 5}, (0, 0, 0, 7, 10)),
    ("after_scan_next_to_last", "after_scan", {loop.BRANCH: 3, loop.ROUNDS: 4},
     (0, 0, 0, 7, 10)),
    ("after_scan_after_a_tier", "after_scan", {loop.BRANCH: 1}, (0, 0, 0, 7, 10)),
    # tally: a tier's list within and past its emit width; light scans with
    # and without their stats, after an invalid list and over the top
    # tier's edges; a heavy scan; the round cap; no active pair
    ("tally_tier_fits_emit", "tally", {loop.BRANCH: 0}, (64, 100, 3, 12, 400)),
    ("tally_tier_past_emit", "tally", {loop.BRANCH: 0}, (65, 100, 3, 12, 400)),
    ("tally_top_tier", "tally", {loop.BRANCH: 2}, (300, 100, 3, 12, 400)),
    ("tally_light_scan_stats", "tally", {loop.BRANCH: 3, loop.STATS: 1, loop.OK: 0,
                                         loop.FED: 3000, loop.FRE: 70}, (40, 50, 6, 9, 100)),
    ("tally_light_scan_no_stats", "tally", {loop.BRANCH: 3, loop.FED: 10, loop.FRE: 1},
     (40, 50, 6, 0, 100)),
    ("tally_heavy_scan", "tally", {loop.BRANCH: 3, loop.HEAVY: 1, loop.FED: loop.BIG,
                                   loop.FRE: loop.BIG, loop.OK: 0}, (40, 50, 6, 9, 5000)),
    ("tally_reaches_max_rounds", "tally", {loop.BRANCH: 0, loop.ROUNDS: 5}, (1, 1, 1, 9, 10)),
    ("tally_goes_on", "tally", {loop.BRANCH: 0, loop.ROUNDS: 4}, (1, 1, 1, 9, 10)),
    ("tally_no_active", "tally", {loop.BRANCH: 1}, (1, 1, 1, 0, 0)),
    # turn: a round pending (tallied) and the next one decided, or the
    # loop's end (no decision; the SWITCH's value past its arms); nothing
    # pending (the loop's first turn: a decision alone)
    ("turn_tier_then_tier", "turn", {loop.PENDING: 1, loop.BRANCH: 0}, (64, 100, 3, 12, 400)),
    ("turn_heavy_scan_then_scan", "turn", {loop.PENDING: 1, loop.BRANCH: 3, loop.HEAVY: 1,
                                           loop.FED: loop.BIG, loop.FRE: loop.BIG, loop.OK: 0},
     (40, 50, 6, 9, 5000)),
    ("turn_light_scan_stats_then_tier", "turn", {loop.PENDING: 1, loop.BRANCH: 3, loop.STATS: 1,
                                                 loop.OK: 0, loop.FED: 3000, loop.FRE: 70},
     (40, 50, 6, 9, 100)),
    ("turn_reaches_max_rounds", "turn", {loop.PENDING: 1, loop.BRANCH: 0, loop.ROUNDS: 5},
     (1, 1, 1, 9, 10)),
    ("turn_no_active", "turn", {loop.PENDING: 1, loop.BRANCH: 1}, (1, 1, 1, 0, 0)),
    ("turn_nothing_pending", "turn", {loop.GO: 1, loop.CN: 8, loop.FED: 32, loop.FRE: 4}, _Z),
    # the sharded rule (K4_SHARDED; counts: cn, fed, fre, n_active,
    # edge_work, ewr): the first round runs from any list, but at no rounds
    ("sharded_prime_empty_list", "prime", {loop.C0OK: 1}, _Z6),
    ("sharded_prime_valid_list", "prime", {loop.C0OK: 1}, (3, 9, 2, 0, 0, 0)),
    ("sharded_prime_no_rounds", "prime", {loop.C0OK: 1, loop.MAX_ROUNDS: 0}, _Z6),
    ("sharded_decide_top_border", "decide", {loop.CN: 256, loop.FED: 2048, loop.FRE: 64},
     _Z6),
    # the heavy test reads ewr, not the edge work; no stats where no round
    # follows
    ("sharded_after_scan_light_ewr", "after_scan", {loop.BRANCH: 3}, (0, 0, 0, 7, 9999, 4224)),
    ("sharded_after_scan_heavy_ewr", "after_scan", {loop.BRANCH: 3}, (0, 0, 0, 7, 10, 4225)),
    ("sharded_after_scan_last_round", "after_scan", {loop.BRANCH: 3, loop.ROUNDS: 5},
     (0, 0, 0, 7, 10, 10)),
    # a tier's list is always valid (its emit width is the buffer's); a
    # heavy scan logs the ewr it read
    ("sharded_tally_tier_list", "tally", {loop.BRANCH: 0}, (65, 100, 3, 12, 400, 0)),
    ("sharded_tally_heavy_scan", "tally", {loop.BRANCH: 3, loop.HEAVY: 1, loop.FED: loop.BIG,
                                           loop.FRE: loop.BIG, loop.OK: 0},
     (40, 50, 6, 9, 5000, 4300)),
    # a tier's list past wl2's emit width stays valid, and the next round
    # is a tier where wl2's would scan
    ("sharded_turn_tier_list_then_tier", "turn", {loop.PENDING: 1, loop.BRANCH: 0},
     (65, 100, 3, 12, 400, 0)),
    # the dense rule (loop.DENSE_TABLE; counts: n_active and edge pushes in
    # their slots, 3 and 4): prime stops a loop from 0 active at the start
    # or at no rounds, and reads nothing of a list
    ("dense_prime_converged", "prime", {loop.C0OK: 1}, _Z),
    ("dense_prime_active", "prime", {loop.C0OK: 1}, (5, 10, 1, 7, 0)),
    ("dense_prime_no_rounds", "prime", {loop.MAX_ROUNDS: 0}, (0, 0, 0, 7, 0)),
    # one arm: the round, whatever the counts
    ("dense_decide", "decide", {}, _Z),
    # a round's tally goes on while it found an active pair, to the cap
    ("dense_tally_goes_on", "tally", {loop.BRANCH: 0}, (0, 0, 0, 9, 40)),
    ("dense_tally_empty_round", "tally", {loop.BRANCH: 0}, _Z),
    ("dense_tally_reaches_max_rounds", "tally", {loop.BRANCH: 0, loop.ROUNDS: 5},
     (0, 0, 0, 9, 40)),
    # turns: a round then the next, a reverse round (its edge pushes, the
    # in-degree work, below its active pairs), the loop's end at an empty
    # round and at the cap, and the loop's first turn
    ("dense_turn_round_then_round", "turn", {loop.PENDING: 1, loop.BRANCH: 0},
     (0, 0, 0, 9, 40)),
    ("dense_turn_reverse_round", "turn", {loop.PENDING: 1, loop.BRANCH: 0}, (0, 0, 0, 12, 3)),
    ("dense_turn_empty_round_ends", "turn", {loop.PENDING: 1, loop.BRANCH: 0}, _Z),
    ("dense_turn_reaches_max_rounds", "turn", {loop.PENDING: 1, loop.BRANCH: 0,
                                               loop.ROUNDS: 5}, (0, 0, 0, 9, 40)),
    ("dense_turn_nothing_pending", "turn", {loop.GO: 1}, _Z),
    # the proportional rule (K4_PROPORTIONAL; counts: cn, fed, fre, n_active,
    # edge_work, the pending carry): the first round runs from any list, a
    # carry the corrections left is pending, no round at no rounds
    ("prop_prime_valid_list", "prime", {loop.C0OK: 1}, (3, 9, 2, 0, 0, 0)),
    ("prop_prime_first_round_forced", "prime", {loop.C0OK: 1}, _Z6),
    ("prop_prime_carry_pending", "prime", {loop.C0OK: 1}, (3, 9, 2, 0, 0, 5)),
    ("prop_prime_no_rounds", "prime", {loop.C0OK: 0, loop.MAX_ROUNDS: 0}, _Z6),
    # a pending carry drains over a valid list; an invalid list rescans; a
    # valid one takes its tier, and past the top tier's border still the top
    ("prop_decide_drain_over_valid_list", "decide", {loop.PEND: 4, loop.CN: 8, loop.FED: 32,
                                                     loop.FRE: 4}, _Z6),
    ("prop_decide_rescan", "decide", {loop.OK: 0}, _Z6),
    ("prop_decide_tier0_border", "decide", {loop.CN: 8, loop.FED: 32, loop.FRE: 4}, _Z6),
    ("prop_decide_past_the_top_border", "decide", {loop.CN: 257, loop.FED: 0, loop.FRE: 0},
     _Z6),
    # a round's count or a pending carry goes on; a drain counts whether it
    # left a list and keeps the list's validity; a rescan makes it valid
    ("prop_tally_tier_goes_on", "tally", {loop.BRANCH: 0}, (65, 100, 3, 12, 400, 0)),
    ("prop_tally_tier_leaves_carry", "tally", {loop.BRANCH: 1}, (10, 20, 2, 0, 0, 3)),
    ("prop_tally_drain_goes_on", "tally", {loop.BRANCH: 3, loop.PEND: 2}, (5, 6, 1, 0, 0, 0)),
    ("prop_tally_drain_ends_loop", "tally", {loop.BRANCH: 3, loop.PEND: 2, loop.OK: 0}, _Z6),
    ("prop_tally_rescan", "tally", {loop.BRANCH: 4, loop.OK: 0}, (40, 50, 6, 9, 100, 0)),
    ("prop_tally_reaches_max_rounds", "tally", {loop.BRANCH: 0, loop.ROUNDS: 5},
     (1, 1, 1, 9, 10, 0)),
    # turns: a tier round that leaves a carry, then the drain; a drain that
    # ends the loop (the SWITCH's value past its five arms); the cap; the
    # loop's first turn from an invalid list
    ("prop_turn_tier_then_drain", "turn", {loop.PENDING: 1, loop.BRANCH: 0},
     (65, 100, 3, 12, 400, 7)),
    ("prop_turn_drain_ends", "turn", {loop.PENDING: 1, loop.BRANCH: 3, loop.PEND: 2}, _Z6),
    ("prop_turn_reaches_max_rounds", "turn", {loop.PENDING: 1, loop.BRANCH: 0, loop.ROUNDS: 5},
     (1, 1, 1, 9, 10, 0)),
    ("prop_turn_nothing_pending", "turn", {loop.GO: 1, loop.OK: 0}, _Z6),
    # the hybrid rule (K4_HYBRID; counts: cn, fed, fre, n_active, edge_work,
    # the first list's validity on the device): a valid list goes while it
    # has a candidate; without one the prologue's count (rows, edges in
    # the n_active and edge_work slots) is the first scan's; a list that
    # overflowed its buffer is counted first
    ("hybrid_prime_valid_list", "prime", {loop.C0OK: 1}, (3, 9, 2, 0, 0, 1)),
    ("hybrid_prime_empty_list", "prime", {loop.C0OK: 1}, (0, 0, 0, 0, 0, 1)),
    ("hybrid_prime_counted", "prime", {loop.C0OK: 0}, (0, 0, 0, 5, 70, 0)),
    ("hybrid_prime_counted_converged", "prime", {loop.C0OK: 0}, _Z6),
    ("hybrid_prime_list_overflowed", "prime", {loop.C0OK: 1}, (256, 900, 30, 0, 0, 0)),
    ("hybrid_prime_no_rounds", "prime", {loop.C0OK: 1, loop.MAX_ROUNDS: 0},
     (3, 9, 2, 0, 0, 1)),
    # a valid list that fits takes its tier; a scan counts first where the
    # frontier is not known (XN -1), else takes the smallest scan tier
    # that holds it where worth it, else the dense scan
    ("hybrid_decide_tier0", "decide", {loop.CN: 8, loop.FED: 32, loop.FRE: 4, loop.XN: -1},
     _Z6),
    ("hybrid_decide_fed_skips_tier1", "decide", {loop.CN: 9, loop.FED: 600, loop.FRE: 0,
                                                 loop.XN: -1}, _Z6),
    ("hybrid_decide_count_past_top", "decide", {loop.CN: 257, loop.XN: -1}, _Z6),
    ("hybrid_decide_count_invalid_list", "decide", {loop.OK: 0, loop.XN: -1}, _Z6),
    ("hybrid_decide_scan_tier0", "decide", {loop.OK: 0, loop.XN: 8, loop.XF: 32}, _Z6),
    ("hybrid_decide_scan_tier1", "decide", {loop.OK: 0, loop.XN: 9, loop.XF: 32}, _Z6),
    ("hybrid_decide_worth_border", "decide", {loop.OK: 0, loop.XN: 5, loop.XF: 4900}, _Z6),
    ("hybrid_decide_not_worth", "decide", {loop.OK: 0, loop.XN: 5, loop.XF: 4901}, _Z6),
    ("hybrid_decide_rows_past_top", "decide", {loop.OK: 0, loop.XN: 1002, loop.XF: 10}, _Z6),
    ("hybrid_decide_valid_list_over_top_edges", "decide", {
        loop.CN: 40, loop.FED: 3000, loop.FRE: 5, loop.XN: 40, loop.XF: 3000}, _Z6),
    ("hybrid_decide_past_the_log", "decide", {loop.ROUNDS: loop.LOG_CAP, loop.XN: -1}, _Z6),
    # a tier's list within and past its own w; scans tally their reasons on
    # the counts that sent them there, then the reseed's exact counts; a
    # count is not a round, and before any round from an invalid list it
    # stands for the prime
    ("hybrid_tally_tier_list", "tally", {loop.BRANCH: 0, loop.XN: -1}, (8, 100, 3, 12, 400, 0)),
    ("hybrid_tally_tier_cut", "tally", {loop.BRANCH: 0, loop.XN: -1}, (9, 100, 3, 12, 400, 0)),
    ("hybrid_tally_top_tier_cut", "tally", {loop.BRANCH: 2, loop.XN: -1},
     (300, 100, 3, 12, 400, 0)),
    ("hybrid_tally_sparse_scan", "tally", {loop.BRANCH: 4, loop.OK: 0, loop.CN: 257,
                                           loop.FED: 3000, loop.FRE: 70, loop.XN: 40,
                                           loop.XF: 50}, (30, 200, 5, 9, 100, 0)),
    ("hybrid_tally_dense_scan", "tally", {loop.BRANCH: 6, loop.CN: 10, loop.FED: 3000,
                                          loop.FRE: 1, loop.XN: 10, loop.XF: 3000},
     (300, 9000, 70, 50, 800, 0)),
    ("hybrid_tally_count", "tally", {loop.BRANCH: 7, loop.GO: 1, loop.OK: 0, loop.CN: 257,
                                     loop.FED: 3000, loop.FRE: 70, loop.XN: -1},
     (0, 0, 0, 40, 50, 0)),
    ("hybrid_tally_prime_count", "tally", {loop.BRANCH: 7, loop.GO: 1, loop.ROUNDS: 0,
                                           loop.OK: 0, loop.XN: -1}, (0, 0, 0, 12, 90, 0)),
    ("hybrid_tally_prime_count_converged", "tally", {loop.BRANCH: 7, loop.GO: 1,
                                                     loop.ROUNDS: 0, loop.OK: 0, loop.XN: -1},
     _Z6),
    ("hybrid_tally_reaches_max_rounds", "tally", {loop.BRANCH: 0, loop.ROUNDS: 5, loop.XN: -1},
     (1, 1, 1, 9, 10, 0)),
    ("hybrid_tally_no_active", "tally", {loop.BRANCH: 3, loop.XN: 5, loop.XF: 5}, _Z6),
    # turns: a tier that cut its list, then a count; a count, then its
    # scan; the prime's count that finds no row ends the loop; a scan whose
    # reseed fits a tier; the loop's first turn
    ("hybrid_turn_tier_then_count", "turn", {loop.PENDING: 1, loop.BRANCH: 0, loop.XN: -1},
     (300, 100, 3, 12, 400, 0)),
    ("hybrid_turn_count_then_scan", "turn", {loop.PENDING: 1, loop.BRANCH: 7, loop.GO: 1,
                                             loop.OK: 0, loop.CN: 257, loop.FED: 100,
                                             loop.FRE: 3, loop.XN: -1}, (0, 0, 0, 40, 50, 0)),
    ("hybrid_turn_prime_count_ends", "turn", {loop.PENDING: 1, loop.BRANCH: 7, loop.GO: 1,
                                              loop.ROUNDS: 0, loop.OK: 0, loop.XN: -1}, _Z6),
    ("hybrid_turn_scan_then_tier", "turn", {loop.PENDING: 1, loop.BRANCH: 3, loop.OK: 0,
                                            loop.XN: 8, loop.XF: 32}, (6, 20, 2, 9, 50, 0)),
    ("hybrid_turn_nothing_pending", "turn", {loop.GO: 1, loop.OK: 0, loop.XN: 8, loop.XF: 32},
     _Z6),
    # the loop without a worklist (K4_NOWL): every round a scan, sparse or
    # dense, from the exact counts each leaves; no reasons
    ("nowl_prime_counted", "prime", {loop.C0OK: 0}, (0, 0, 0, 5, 70, 0)),
    ("nowl_decide_sparse", "decide", {loop.OK: 0, loop.XN: 5, loop.XF: 70}, _Z6),
    ("nowl_decide_dense", "decide", {loop.OK: 0, loop.XN: 1002, loop.XF: 70}, _Z6),
    ("nowl_tally_scan", "tally", {loop.BRANCH: 0, loop.OK: 0, loop.XN: 5, loop.XF: 70},
     (4, 60, 0, 9, 100, 0)),
    ("nowl_turn_scan_then_dense", "turn", {loop.PENDING: 1, loop.BRANCH: 0, loop.OK: 0,
                                           loop.XN: 5, loop.XF: 70}, (2000, 100, 0, 9, 100, 0)),
)


def k4_table(case) -> loop.Table:
    """The table a case of ``K4_CASES`` runs under: the sharded rule's for
    a case named ``sharded_*``, the dense rule's for ``dense_*``, the
    proportional rule's for ``prop_*``, the hybrid rule's for ``hybrid_*``
    and, without a worklist, for ``nowl_*``."""
    rule = case[0].split("_")[0]
    return {"sharded": K4_SHARDED, "dense": loop.DENSE_TABLE, "prop": K4_PROPORTIONAL,
            "hybrid": K4_HYBRID, "nowl": K4_NOWL}.get(rule, K4_TABLE)


def k4_case(case) -> tuple[torch.Tensor, torch.Tensor]:
    """A case's carry and counts on the CPU. The carry's log holds a row
    for round 0, which no step may disturb (``decide`` and ``tally`` write
    the row of the carry's round)."""
    _, _, slots, counts = case
    carry = loop.new_carry("cpu")
    for slot, v in {**K4_BASE, **slots}.items():
        carry[slot] = v
    carry[loop.HEAD:loop.HEAD + loop.LOG_W] = torch.arange(1, loop.LOG_W + 1)
    return carry, torch.tensor(counts, dtype=torch.int64)


def k4_launch(case) -> tuple[str, torch.Tensor, torch.Tensor]:
    """The K4 kernel a loop graph launches for a case's step, and the carry
    and counts it finds there: a ``decide`` case is a ``turn`` with no
    round pending while the loop goes on, a ``tally`` case a ``turn`` with
    one pending; the other steps are kernels of their own."""
    _, step, _, _ = case
    carry, counts = k4_case(case)
    if step == "decide":
        carry[loop.PENDING], carry[loop.GO] = 0, 1
    elif step == "tally":
        carry[loop.PENDING] = 1
    return ("turn" if step in ("decide", "tally") else step), carry, counts


# the case each K4 kernel is timed on, as it runs most often: a turn that
# tallies a round and decides the next, with no round cap in reach
K4_TIMED = {"prime": "prime_valid_list", "turn": "turn_tier_then_tier",
            "after_scan": "after_scan_light"}
# and under the hybrid rule (no after_scan): a scan's tally, then a tier
K4_TIMED_HYBRID = {"prime": "hybrid_prime_valid_list", "turn": "hybrid_turn_scan_then_tier"}


def check_k4(dev) -> dict:
    """K4's kernels against their plain steps on every case of
    ``K4_CASES``, each case through the kernel the loop graph launches for
    it (``k4_launch``) and under its table (``k4_table``: wl2's rule, or
    the sharded engine's): the whole carry equal (decisions, tallies, log),
    and so each branch choice; then each kernel's device time (one launch,
    queued behind a spinning kernel: the launch floor), its time as a node
    of a captured graph of 64 of its launches (``graph_ms``: what a loop
    graph's node of it costs, against ``graph_kernel_floor_ms``), its plain
    step's host time, and its bound from the bytes a step moves (the
    carry's head read and written, the counts read, a log row written);
    ``prime`` and ``turn`` again under the hybrid rule (``hybrid_prime``,
    ``hybrid_turn``). Then ``loop_overhead``: what a loop graph's round
    costs the device beyond its kernels, and a kernel node inside its body
    against one in a top-level graph; then the loop graphs of the dense,
    proportional and hybrid rules' fill-kernel arms against the host
    loop."""
    res = {"versions": loop.versions(), "cases": len(K4_CASES)}
    choices, errs = {}, {step: 0 for step in loop.STEPS}
    for case in K4_CASES:
        name = case[0]
        step, carry, counts = k4_launch(case)
        want = carry.clone()
        loop.step_(step, want, counts, k4_table(case))
        got = carry.to(dev)
        loop.step_(step, got, counts.to(dev), k4_table(case))
        got = got.cpu()
        if not torch.equal(got, want):
            diff = (got != want).nonzero().flatten().tolist()[:8]
            raise AssertionError(f"K4 {step} on {name}: slots {diff} are "
                                 f"{got[diff].tolist()}, the plain step's {want[diff].tolist()}")
        choices[name] = [int(got[i]) for i in (loop.BRANCH, loop.STATS, loop.GO, loop.PENDING)]
        errs[step] = max(errs[step], int((got - want).abs().max()))
    res["choices"] = choices
    cases = {case[0]: case for case in K4_CASES}
    for tag, table, timed in (("", K4_TABLE, K4_TIMED), ("hybrid_", K4_HYBRID, K4_TIMED_HYBRID)):
        n_bytes = 2 * loop.HEAD * 8 + table.n_counts * 8 + loop.LOG_W * 8
        for step, name in timed.items():
            _, carry, counts = k4_launch(cases[name])
            carry[loop.MAX_ROUNDS] = 1 << 40
            plain_carry = carry.clone()
            carry, counts_dev = carry.to(dev), counts.to(dev)
            ms = in_turns({step: lambda: loop.step_(step, carry, counts_dev, table)})[step]
            nodes = torch.cuda.CUDAGraph()
            with torch.cuda.graph(nodes):
                for _ in range(64):
                    loop.step_(step, carry, counts_dev, table)
            graph_ms = cuda_ms(nodes.replay) / 64
            t0 = time.perf_counter()
            for _ in range(200):
                loop.step_(step, plain_carry, counts, table)
            b_ms, b_by = bound_ms(n_bytes, 0)
            res[f"{tag}{step}"] = {"ms": ms, "graph_ms": graph_ms,
                                   "plain_ms": (time.perf_counter() - t0) * 1e3 / 200,
                                   "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs[step]}
    res.update(loop_overhead(dev))
    res["dense_loops"] = dense_loop_check(dev)
    res["prop_loops"] = prop_loop_check(dev)
    res["hybrid_loops"] = hybrid_loop_check(dev)
    return res


def fill_branches(g: RoundGraphs, width: int = 1) -> list:
    """A one-tier loop's branches as fill kernels on ``g``'s counts (the
    tier's, ``width`` kernels, and the scan's set n_active to 1, the
    stats' clear cn, fed, fre) under ``FILL_TABLE``: from an invalid list
    a loop runs one scan, its stats, then tier rounds to its cap; from a
    valid empty one, none."""
    na = g.counts[3:4]

    def tier():
        for _ in range(width):
            na.fill_(1)

    return [(("tier", width), tier), ("scan", lambda: na.fill_(1)),
            ("stats", lambda: g.counts[:3].zero_())]


FILL_TABLE = loop.Table(tiers=((8, 32, 4),), emit=(8,), heavy_ew=100)


def dense_fill(g: RoundGraphs, na0: int) -> tuple:
    """A dense loop's prologue and round as fill kernels on ``g``'s counts:
    the first count ``na0``, and a round that leaves an active pair and 3
    edge pushes, so that a loop that starts runs to its cap."""
    first = (("first", na0), lambda: g.counts[3:4].fill_(na0))
    return first, [("round", lambda: (g.counts[3:4].fill_(1), g.counts[4:5].fill_(3)))]


# (first count, max_rounds) of the dense loops phase 3c runs: 0 active at
# the start, one round, stopped at the cap, no round allowed
DENSE_FILL_LOOPS = ((0, 5), (1, 1), (1, 7), (1, 0))


def dense_loop_check(dev) -> dict:
    """Loop graphs of the dense rule's one-arm form (``dense_fill``
    branches) on the card against the host loop of the same branches on
    the CPU: the whole carry equal, K4's launches prime 1 and turn R + 1
    (none where prime stops the loop), the round's branch run R times."""
    res = {}
    for na0, max_rounds in DENSE_FILL_LOOPS:
        got = {}
        for where in (dev, torch.device("cpu")):
            g = RoundGraphs(8, 1, where)
            before = dict(loop.LAUNCHES)
            first, branches = dense_fill(g, na0)
            values, reads = g.loop(first, branches, loop.DENSE_TABLE, True, max_rounds)
            got[where.type] = (values, reads, {k: loop.LAUNCHES[k] - before[k] for k in before})
        (values, reads, k4), (want, _, _) = got[dev.type], got["cpu"]
        rounds = values[loop.ROUNDS]
        if values != want or reads != 1 or k4 != {
                "prime": 1, "turn": rounds + 1 if rounds else 0, "after_scan": 0}:
            raise AssertionError(f"a dense loop from {na0} active, at most {max_rounds} rounds, "
                                 f"left {values[:loop.HEAD]} ({reads} reads, K4 {k4}) where "
                                 f"the host loop left {want[:loop.HEAD]}")
        res[f"{na0}_active_{max_rounds}_rounds"] = rounds
    return res


PROP_FILL_TABLE = loop.Table(tiers=((8, 32, 4),), emit=(8,), heavy_ew=0,
                             rule=loop.PROPORTIONAL)


def prop_fill(g: RoundGraphs, pend0: int) -> tuple:
    """A proportional loop's prologue and arms as fill kernels on ``g``'s
    counts under ``PROP_FILL_TABLE`` (the tier 0, the drain 1, the rescan
    2): the first list's counts and a pending carry ``pend0``; a tier round
    or a rescan that leaves an active pair and no carry, so that the loop
    runs to its cap, and a drain that leaves no list and no carry, which
    ends it."""
    c = g.counts

    def first():
        c[:3].fill_(1)
        c[loop.N_PEND:].fill_(pend0)

    def active():
        c[3:4].fill_(1)
        c[loop.N_PEND:].zero_()

    def drain():
        c[:5].zero_()
        c[loop.N_PEND:].zero_()

    return (("first", pend0), first), [("tier", active), ("drain", drain), ("rescan", active)]


# (c0ok, pending carry, max_rounds) of the proportional loops phase 3c runs:
# an invalid list (a rescan, then tiers to the cap), a pending carry (one
# drain, which ends the loop), a valid list to the cap, no round allowed
PROP_FILL_LOOPS = ((False, 0, 3), (True, 2, 5), (True, 0, 4), (True, 0, 0))


def prop_loop_check(dev) -> dict:
    """Loop graphs of the proportional rule's form (``prop_fill`` arms: the
    tier, the drain, the rescan, no stats) on the card against the host
    loop of the same arms on the CPU: the whole carry equal, K4's launches
    prime 1, turn R + 1 (none where prime stops the loop) and no
    after_scan, one read."""
    res = {}
    for c0ok, pend0, max_rounds in PROP_FILL_LOOPS:
        got = {}
        for where in (dev, torch.device("cpu")):
            g = RoundGraphs(8, 8, where, n_counts=loop.N_COUNTS)
            before = dict(loop.LAUNCHES)
            first, branches = prop_fill(g, pend0)
            values, reads = g.loop(first, branches, PROP_FILL_TABLE, c0ok, max_rounds)
            got[where.type] = (values, reads, {k: loop.LAUNCHES[k] - before[k] for k in before})
        (values, reads, k4), (want, _, _) = got[dev.type], got["cpu"]
        rounds = values[loop.ROUNDS]
        if values != want or reads != 1 or k4 != {
                "prime": 1, "turn": rounds + 1 if rounds else 0, "after_scan": 0}:
            raise AssertionError(f"a proportional loop (c0ok {c0ok}, carry {pend0}, at most "
                                 f"{max_rounds} rounds) left {values[:loop.HEAD]} ({reads} "
                                 f"reads, K4 {k4}) where the host loop left {want[:loop.HEAD]}")
        res[f"ok{int(c0ok)}_carry{pend0}_{max_rounds}_rounds"] = {
            "rounds": rounds, "execs": values[loop.EXECS:loop.EXECS + 3]}
    return res


# the hybrid rule's loop of fill-kernel arms: the tier 0, the scan 1, the
# dense scan 2, the count 3; a sparse scan is always worth it
HYBRID_FILL_TABLE = loop.hybrid_table(((8, 32, 4),), ((8, 32),), 0, 1000)


def hybrid_fill(g: RoundGraphs, c0v: int, first: int, count: int) -> tuple:
    """A hybrid loop's prologue and arms as fill kernels on ``g``'s counts
    under ``HYBRID_FILL_TABLE``: the prologue leaves a list of one row
    (valid where ``c0v``) and a first count of ``first`` rows and edges; a
    tier round marks 9 rows, past its own 8 (the list is cut: a count, then
    a scan, follows), a count finds ``count`` rows and edges, and a scan
    reseeds a list of one row, valid; every round leaves an active pair, so
    that a loop that starts runs to its cap."""
    c = g.counts

    def prologue():
        c[:3].fill_(1)
        c[3:5].fill_(first)
        c[loop.C0V:].fill_(c0v)

    def tier():
        c[:1].fill_(9)
        c[1:5].fill_(1)

    return (("first", c0v, first), prologue), [
        ("tier", tier), ("scan", lambda: c[:5].fill_(1)), ("dense", lambda: c[:5].fill_(1)),
        (("count", count), lambda: c[3:5].fill_(count))]


# (c0ok, the list's validity, first count, count, max_rounds) of the hybrid
# loops phase 3c runs, and the executions of each arm: a valid list (a tier,
# then a count and a scan, in turn, to the cap), the state's first count (a
# scan first), a first count of 0 (no round), a list that overflowed (a
# count first, standing for the prime), one whose count finds no row (no
# round), no round allowed
HYBRID_FILL_LOOPS = (((True, 1, 0, 1, 5), [3, 2, 0, 2]), ((False, 0, 1, 1, 3), [1, 2, 0, 1]),
                     ((False, 0, 0, 1, 3), [0, 0, 0, 0]), ((True, 0, 0, 1, 4), [2, 2, 0, 2]),
                     ((True, 0, 0, 0, 4), [0, 0, 0, 1]), ((True, 1, 0, 1, 0), [0, 0, 0, 0]))


def hybrid_loop_check(dev) -> dict:
    """Loop graphs of the hybrid rule (``hybrid_fill`` arms: a worklist
    tier, a sparse scan, the dense scan and the count, no stats) on the card
    against the host loop of the same arms on the CPU: the whole carry
    equal, each arm's executions, K4's launches prime 1 and turn R + C + 1
    for R rounds and C counts (none where prime stops the loop) and no
    after_scan, one read."""
    res = {}
    for (c0ok, c0v, first, count, max_rounds), execs in HYBRID_FILL_LOOPS:
        got = {}
        for where in (dev, torch.device("cpu")):
            g = RoundGraphs(8, 8, where, n_counts=loop.N_COUNTS)
            before = dict(loop.LAUNCHES)
            pro, arms = hybrid_fill(g, c0v, first, count)
            values, reads = g.loop(pro, arms, HYBRID_FILL_TABLE, c0ok, max_rounds)
            got[where.type] = (values, reads, {k: loop.LAUNCHES[k] - before[k] for k in before})
        (values, reads, k4), (want, _, _) = got[dev.type], got["cpu"]
        steps = values[loop.ROUNDS] + values[loop.EXECS + 3]
        tag = f"ok{int(c0ok)}_valid{c0v}_first{first}_count{count}_{max_rounds}_rounds"
        if values != want or reads != 1 or values[loop.EXECS:loop.EXECS + 4] != execs or k4 != {
                "prime": 1, "turn": steps + 1 if steps else 0, "after_scan": 0}:
            raise AssertionError(f"a hybrid loop ({tag}) left {values[:loop.HEAD]} ({reads} "
                                 f"reads, K4 {k4}) where the host loop left {want[:loop.HEAD]}")
        res[tag] = {"rounds": values[loop.ROUNDS], "execs": execs}
    return res


def loop_overhead(dev, rounds: int = 257, wide: int = 21) -> dict:
    """A loop of ``fill_branches``: its device time a round (launches of
    ``rounds`` and of 1, by CUDA events) with one kernel in the tier's
    branch, against a captured graph of 64 of the same kernels: what the
    WHILE, the SWITCH and a turn add to a tier round beyond its two kernel
    nodes (the turn and the tier's) at a graph's floor; and with ``wide``
    kernels there: what a kernel node costs inside a loop's body."""
    g = RoundGraphs(8, 8, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    per_round = {}
    for width in (1, wide):
        times = {}
        for r in (1, rounds):
            values, reads = g.loop(None, fill_branches(g, width), FILL_TABLE, False, r)
            execs = values[loop.EXECS:loop.EXECS + 3]
            if values[loop.ROUNDS] != r or execs != [r - 1, 1, int(r > 1)] or reads != 1:
                raise AssertionError(f"a loop of {r} rounds ran {values[loop.ROUNDS]}: {execs}")
            graph = next(lg for key, (lg, _) in g.loops.items() if key[1][0] == ("tier", width))
            times[r] = cuda_ms(lambda: graph.launch(stream))
        per_round[width] = (times[rounds] - times[1]) / (rounds - 1)
    na = g.counts[3:4]
    plain = torch.cuda.CUDAGraph()
    with torch.cuda.graph(plain):
        for _ in range(64):
            na.fill_(1)
    floor = cuda_ms(plain.replay) / 64
    return {"loop_round_ms": per_round[1], "graph_kernel_floor_ms": floor,
            "conditional_overhead_ms_per_round": per_round[1] - 2 * floor,
            "body_kernel_ms": (per_round[wide] - per_round[1]) / (wide - 1)}


def check_round_logs() -> dict:
    """Every loop logged since the last call (``graphs.LOG_SINK``): each
    round's branch and stats choice replayed through the plain ``decide``
    and ``after_scan`` from the counts the round logged must be the one the
    loop made. A carry logs a loop's first ``loop.LOG_CAP`` rounds: the
    later ones are not checked, and are counted apart. Empties the sink;
    returns the loops and rounds checked, and the rounds not logged."""
    loops = rounds = unlogged = 0
    for rec in graphs.LOG_SINK:
        made = loop.logged(rec["rows"], rec["table"])
        if loop.replay_log(rec["rows"], rec["table"], rec["max_rounds"]) != made:
            raise AssertionError(f"a loop's branches differ from the plain steps' on its "
                                 f"logged counts: {rec['rows'][:4]}")
        loops += 1
        rounds += len(made)
        unlogged += rec["rounds"] - len(made)
    graphs.LOG_SINK.clear()
    return {"loops": loops, "rounds": rounds, "rounds_not_logged": unlogged}


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    segsum.reset_launches()
    rowpass.reset_launches()
    loop.reset_launches()


def all_launches() -> int:
    """Launches of every kernel since the last reset."""
    return segsum.launches() + rowpass.launches() + loop.launches()


def launches_by_entry(scaled: bool | None = None) -> dict:
    """The launches by entry since the last reset: the segment sum's and
    the row passes'; ``scaled=True``: the segment sum's with a
    ``row_scale`` alone."""
    out = {entry: segsum.launches(entry, scaled) for entry in segsum.ENTRIES}
    if scaled is None:
        out.update({entry: rowpass.launches(entry) for entry in rowpass.ENTRIES})
        out.update({f"loop_{step}": loop.launches(step) for step in loop.STEPS})
    return out


def k1_by_site() -> dict:
    """K1's launches since the last reset by call site (``segsum.SITES``):
    the hybrid engine's worklist rounds and sparse scans, ``wlp``'s group
    sum, and every other call."""
    return dict(segsum.SITE_LAUNCHES)


def run_stream(drv: FastStreamDriver, warmup: int, steps: int) -> dict:
    """Seed, warm up, then time ``steps`` slides (host clock around a
    device sync) and summarise the per-slide push statistics, with the
    driver's captured rounds (``graphs``: graphs held, captures and their
    seconds since the driver was made; ``replays_per_round`` and
    ``eager_rounds`` in the timed slides: every round there should be a
    replay)."""
    dev = drv.device
    t0 = time.perf_counter()
    seed = drv.seed()
    sync(dev)
    seed_s = time.perf_counter() - t0
    for _ in drv.run(warmup):
        pass
    sync(dev)
    before, rows_before = dict(segsum.LAUNCHES), dict(rowpass.LAUNCHES)
    g0 = drv.round_graphs.summary()
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    sync(dev)
    wall = time.perf_counter() - t0
    g1 = drv.round_graphs.summary()
    launched = segsum.launches(since=before)
    scaled = segsum.launches(scaled=True, since=before)
    row_passes = {e: rowpass.launches(e, since=rows_before) / steps for e in rowpass.ENTRIES}
    if len(stats) != steps:
        raise AssertionError(f"stream ran {len(stats)} of {steps} slides")
    b = drv.scfg.slide
    rounds = sum(st.rounds for st in stats)

    def per_slide(f):
        return sum(f(st) for st in stats) / steps

    return {
        "updates_per_s": 2 * b * steps / wall,
        "wall_s": wall,
        "wall_per_round_ms": wall * 1e3 / rounds,
        "seed_s": seed_s,
        "seed_rounds": seed.rounds,
        "rounds_per_slide": per_slide(lambda st: st.rounds),
        "wl_rounds_per_slide": per_slide(lambda st: st.wl_rounds),
        "scan_rounds_per_slide": per_slide(lambda st: st.scan_rounds),
        "syncs_per_slide": per_slide(lambda st: st.syncs),
        "stats_reads_per_slide": per_slide(lambda st: st.stats_reads),
        "kernel_launches_per_slide": launched / steps,
        "scaled_launches_per_slide": scaled / steps,
        "row_pass_launches_per_slide": row_passes,
        "edge_pushes_per_s": sum(st.edge_pushes for st in stats) / wall,
        "graphs": g1,
        "replays_per_round": (g1["replays"] - g0["replays"]) / rounds,
        "graph_launches_per_slide": (g1["graph_launches"] - g0["graph_launches"]) / steps,
        "eager_rounds": g1["eager_rounds"] - g0["eager_rounds"],
    }


# Host-side calls that put work on the card, as torch.profiler names them
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
               "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_slides(drv, steps: int, top: int = 10) -> dict:
    """``steps`` slides of a driver (fast or sharded) under
    ``torch.profiler``: wall time on the host clock, device busy time as the
    sum of the device-side kernel and copy times (one stream, so they do not
    overlap; kernels inside a replayed CUDA graph are traced one by one),
    the ``top`` of them, and the host's launch calls a slide by API
    (``launches_per_slide``: ``cudaGraphLaunch`` is a loop's or a replay's
    launch, the others are eager launches and copies)."""
    dev = drv.device
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = list(drv.run(steps))
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    on_dev = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    on_dev.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # a profiler that sees no device activity measures nothing: say so
    busy_ms = sum(e.self_device_time_total for e in on_dev) / 1e3 if on_dev else None
    return {
        "slides": steps, "wall_ms": wall_ms,
        "rounds": [st["rounds"] if isinstance(st, dict) else st.rounds for st in stats],
        "device_busy_ms": busy_ms,
        "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
        "device_ops_per_slide": sum(e.count for e in on_dev) / steps,
        "launches_per_slide": {e.key: e.count / steps for e in events
                               if e.device_type != torch.autograd.DeviceType.CUDA
                               and e.key in LAUNCH_APIS},
        "top": [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count}
                for e in on_dev[:top]],
    }


def prologue_split(drv: FastStreamDriver, steps: int) -> dict:
    """Where a slide's wall goes: ``steps`` slides with a device sync where
    the convergence loop starts, the slide's prologue (the rebuild when one
    is due, the batch's upload, and the replay of the captured prologue:
    sorts, corrections, kills, ring append, fresh re-sort, first counts)
    timed apart from its loop (the launch of the loop's graph, here without
    the prologue inside: ``split_prologue``, and its read). The sync adds
    one wait a slide, so these slides are not the timed ones."""
    dev = drv.device
    converge = fast_stream.converge_wl2
    marks = []

    def timed_loop(*args, **kw):
        sync(dev)
        marks.append(time.perf_counter())
        return converge(*args, **kw)

    fast_stream.converge_wl2 = timed_loop
    drv.round_graphs.split_prologue = True
    try:
        pro, tot = [], []
        for _ in range(steps):
            sync(dev)
            t0 = time.perf_counter()
            if len(list(drv.run(1))) != 1:
                raise AssertionError("no slide left in the stream")
            sync(dev)
            tot.append(time.perf_counter() - t0)
            pro.append(marks[-1] - t0)
    finally:
        fast_stream.converge_wl2 = converge
        drv.round_graphs.split_prologue = False
    return {"slides": steps, "prologue_ms": [x * 1e3 for x in pro],
            "slide_ms": [x * 1e3 for x in tot], "prologue_share": sum(pro) / sum(tot)}


def serve_check(drv: FastStreamDriver, eps_r: float, k: int) -> dict:
    """Refine twice from the same state (the second call is timed), then
    read the top-k (timed on its second call, as the CLI's serve loop reads
    it warm)."""
    dev = drv.device
    saved = PprState(p=drv.state.p.clone(), r=drv.state.r.clone(), mode=drv.state.mode)
    drv.refine(eps_r)
    sync(dev)
    copy_into_(drv.state, saved)
    t0 = time.perf_counter()
    st = drv.refine(eps_r)
    sync(dev)
    refine_ms = (time.perf_counter() - t0) * 1e3
    topk_candidates(drv.state.p, k)
    sync(dev)
    t0 = time.perf_counter()
    _, ids = topk_candidates(drv.state.p, k)
    sync(dev)
    topk_ms = (time.perf_counter() - t0) * 1e3
    return {"refine_ms": refine_ms, "refine_rounds": st.rounds, "topk_ms": topk_ms,
            "ids": ids.cpu().numpy()}


def state_mass(drv: FastStreamDriver, n_check: int) -> np.ndarray:
    """``sum p + sum r`` (f64) of ``n_check`` sampled sources: 1 where mass
    is conserved."""
    cols = torch.from_numpy(np.linspace(0, drv.state.p.shape[1] - 1, n_check).astype(int))
    st, n = drv.state, drv.n
    return (st.p[:n].double().sum(0) + st.r[:n].double().sum(0)).cpu()[cols].numpy()


def exact_contract(drv: FastStreamDriver, ids: np.ndarray | None, k: int, n_check: int,
                   l1_bound: float, mass_ref: np.ndarray | None = None) -> dict:
    """Hold ``n_check`` sampled sources to the exact-PPR contract: L1 within
    the bound, mass conserved within 1e-3, and, where the top-k ``ids`` of
    a refined state are given, mean precision@k >= 0.95. Exact PPR is a
    power iteration in f64 on the driver's device. With ``mass_ref`` (the
    sampled sources' ``state_mass`` in a run that launched no kernel) the
    mass is held to that reading within 1e-4 and not to 1: bf16 delivery
    does not conserve mass, whatever sums it."""
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
    precs, l1s = [], []
    for si, pi in zip(cols, pis):
        if ids is not None:
            precs.append(precision_at_k(ids[si], pi, k))
        l1s.append(l1_error(p[:n, si], pi))
    mass = p[:n, cols].sum(0) + r[:n, cols].sum(0)
    res = {"sources": n_check, "precision_at_k": float(np.mean(precs)) if precs else None,
           "l1_max": max(l1s), "l1_mean": float(np.mean(l1s)), "l1_bound": l1_bound,
           "mass_err_max": float(np.abs(mass - 1.0).max()), "exact_s": exact_s}
    if mass_ref is None:
        mass_off, res["mass_bound"] = res["mass_err_max"], 1e-3
    else:
        mass_off, res["mass_bound"] = float(np.abs(mass - mass_ref).max()), 1e-4
        res.update(mass_err_max_ref=float(np.abs(mass_ref - 1.0).max()), mass_off_ref=mass_off)
    if res["l1_max"] > l1_bound or mass_off > res["mass_bound"] or (precs and
                                                              res["precision_at_k"] < 0.95):
        raise AssertionError(f"exact-PPR contract failed: {res}")
    return res


def reverse_contract(drv: FastStreamDriver, eps: float, gap_limit: float | None = None,
                     n_check: int = 16) -> dict:
    """Hold up to ``n_check`` sampled targets of a reverse state pushed to
    ``eps`` to the reverse contract, against columns of M by f64 iteration
    on the driver's device: every residual within ``eps``, and
    ``max_v |p[v, j] - M[v, t_j]| <= 2 eps`` (``eps`` in exact arithmetic,
    since the rows of M sum to 1, and as much again for f32).

    The f32 share is measured, not assumed: ``invariant_gap`` is
    ``max |p + M r - M e_t|`` on the same targets, 0 in exact arithmetic at
    any eps, and what the error cannot go below however far r is pushed
    (``error <= eps + gap``). The gap must stay within ``gap_limit`` (by
    default ``eps``, which makes the bound ``2 eps``); a caller that allows
    a gap above ``eps`` gets the bound ``eps + gap``, and ``within_2eps``
    says whether ``2 eps`` held all the same."""
    n = drv.n
    p, r = drv.state.p, drv.state.r
    if not (bool(torch.isfinite(p).all()) and bool(torch.isfinite(r).all())):
        raise AssertionError("non-finite state")
    cols = np.unique(np.linspace(0, p.shape[1] - 1, min(n_check, p.shape[1])).astype(int))
    targets = [drv._queries[j] for j in cols]
    at = torch.from_numpy(cols).to(p.device)
    t0 = time.perf_counter()
    exact = exact_ppr_columns(drv.hsrc, drv.hdst, n, targets, drv.cfg.alpha, tol=1e-11,
                              device=drv.device)
    gap = reverse_invariant_gap(drv.hsrc, drv.hdst, n, targets, p[:, at], r[:, at],
                                drv.cfg.alpha, tol=1e-11)
    exact_s = time.perf_counter() - t0
    err = float(np.abs(p[:n, at].double().cpu().numpy() - exact.T).max())
    gap_limit = eps if gap_limit is None else gap_limit
    bound = eps + max(eps, gap)
    res = {"targets": int(cols.size), "eps": eps, "max_abs_err": err, "bound": bound,
           "within_2eps": err <= 2 * eps, "invariant_gap": gap, "gap_limit": gap_limit,
           "max_abs_r": float(r.abs().max()), "exact_s": exact_s}
    # the residuals by the engine's own test, in the state's dtype (eps
    # rounds to f32 there)
    if err > bound or gap > gap_limit or bool((r.abs() > eps).any()):
        raise AssertionError(f"reverse contract failed: {res}")
    return res


def correction_rounding(drv: FastStreamDriver, n_check: int = 16) -> dict:
    """What the next slide's corrections, as the driver computes them (f32,
    the old window's row sums from the segment-sum kernel over the kill
    graph's views), add to ``r`` beyond the same corrections in f64 with
    the row sums from the COO ring: ``e = r_f32 - r_f64`` over all rows and
    targets, and ``max |M e|`` on sampled targets, which is what the slide
    adds to the invariant gap (M on the window after the slide). The state
    does not advance. A row-sum fault would show here as an ``e`` far above
    f32 rounding: ``max_abs_e`` is held to 1e-5."""
    dev, b, w = drv.device, drv.scfg.slide, drv.scfg.window
    if drv.steps_available < 1:
        raise AssertionError("no slide left in the stream")
    lo = drv.head
    slots = np.arange(lo, lo + b) % w
    ins = [torch.from_numpy(a[lo:lo + b]).to(dev) for a in (drv.stream_src, drv.stream_dst)]
    win = drv.graph.window
    at = torch.from_numpy(slots).to(dev)
    dels = [win.src[at], win.dst[at]]
    st = drv.state
    got, _ = apply_edge_batch(st, win, *ins, *dels, drv.cfg,
                              rowsum=window_row_sums(st.p, drv.graph))
    st64 = PprState(p=st.p.double(), r=st.r.double(), mode=st.mode)
    want, _ = apply_edge_batch(st64, win, *ins, *dels, drv.cfg)
    e = got.r.double() - want.r
    touched = int(((want.r - st64.r) != 0).any(dim=1).sum())
    del got, want, st64
    hsrc, hdst = drv.hsrc.copy(), drv.hdst.copy()
    hsrc[slots], hdst[slots] = drv.stream_src[lo:lo + b], drv.stream_dst[lo:lo + b]
    cols = np.unique(np.linspace(0, e.shape[1] - 1, min(n_check, e.shape[1])).astype(int))
    image = ppr_matrix_times(hsrc, hdst, drv.n, e[:drv.n, torch.from_numpy(cols).to(dev)],
                             drv.cfg.alpha, tol=1e-11)
    res = {"rows_corrected": touched, "max_abs_e": float(e.abs().max()),
           "max_abs_Me": float(image.abs().max())}
    if res["max_abs_e"] > 1e-5:
        raise AssertionError(f"f32 corrections are far from the f64 ones: {res}")
    return res


def reverse_run(dev, n: int, w: int, b: int, s: int, rebuild_every: int, warmup: int,
                steps: int, seed: int, eps_r: float, prof_steps: int = 0) -> dict:
    """One reverse stream through ``FastStreamDriver(mode=REVERSE)``: seed,
    warm up, ``steps`` timed slides, the reverse contract at the maintained
    eps, a timed refine to ``eps_r`` and the contract again, ``prof_steps``
    slides under the profiler, and the rounding of the next slide's
    corrections. The refined state's invariant gap may be what the stream has
    left it (at most the maintained eps): its bound is ``eps_r + gap``
    where that is above ``2 eps_r``. ``cold`` is the control with no
    slides: a second driver seeded on the final window and refined to
    ``eps_r``, which must meet ``2 eps_r``; its gap beside the stream's
    says what the slides added. Fails unless the scaled entry of the
    segment sum launched."""
    src, dst, n = synthetic_powerlaw_stream(n, w + (steps + warmup + prof_steps + 1) * b,
                                            seed=seed)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    scfg = StreamConfig(window=w, slide=b)
    reset_launches()  # this run's path: from here to the profiled slides
    torch.cuda.reset_peak_memory_stats()
    drv = FastStreamDriver(src, dst, n, list(range(s)), cfg, scfg, mode=REVERSE,
                           dtype=torch.float32, rebuild_every=rebuild_every, device=dev)
    res = {"n": n, "window": w, "slide": b, "targets": s, "rebuild_every": rebuild_every,
           "warmup": warmup, "steps": steps, "tiers": [list(t) for t in drv.tiers],
           **run_stream(drv, warmup, steps)}
    res["contract"] = reverse_contract(drv, cfg.eps)
    t0 = time.perf_counter()
    st = drv.refine(eps_r)
    sync(dev)
    res.update(refine_ms=(time.perf_counter() - t0) * 1e3, refine_rounds=st.rounds,
               refine_scan_rounds=st.scan_rounds)
    res["contract_refined"] = reverse_contract(drv, eps_r, gap_limit=cfg.eps)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if prof_steps:
        res["profile"] = profile_slides(drv, prof_steps)
    res["launches_by_entry"] = launches_by_entry()
    res["launches_scaled"] = launches_by_entry(scaled=True)
    if res["launches_scaled"]["segsum_gather_add"] <= 0:
        raise AssertionError(f"the reverse stream never launched the scaled entry: {res}")
    if res["launches_by_entry"]["scan_pass"] <= 0:
        raise AssertionError(f"the reverse stream never launched the scan pass: {res}")
    # what follows compares and is not counted
    res["correction_rounding"] = correction_rounding(drv)
    # the control: the same engine on the final window (the ring's edges in
    # ring order), with no slide behind it
    cold = FastStreamDriver(drv.hsrc, drv.hdst, n, list(range(s)), cfg, scfg, mode=REVERSE,
                            dtype=torch.float32, rebuild_every=rebuild_every, device=dev)
    rounds = cold.seed().rounds + cold.refine(eps_r).rounds
    res["cold"] = {"rounds": rounds, **reverse_contract(cold, eps_r, gap_limit=cfg.eps)}
    if not res["cold"]["within_2eps"]:
        raise AssertionError(f"a cold state refined to {eps_r} misses 2 eps: {res['cold']}")
    return res


def forward_run(dev, n: int, w: int, b: int, s: int, rebuild_every: int, warmup: int,
                steps: int, seed: int, eps_r: float, k: int, bf16d: bool = False,
                prof_steps: int = 0) -> dict:
    """One forward stream through ``FastStreamDriver``: seed, warm up,
    ``steps`` timed slides, ``prof_steps`` more under the profiler, the
    forward contract at the maintained eps (L1 to exact PPR within eps * W
    per sampled source, mass within 1e-3), a refine to ``eps_r`` (timed on
    its second call), the top-k and the contract again with mean
    precision@k >= 0.95. Sets the launch counts to 0 first and fails unless
    the stream launched the segment sum.

    With ``bf16d`` every scan round's contributions are rounded to 8 bits
    while ``r`` gives up the exact amounts, so mass drifts with the number
    of scan rounds, on any device. That run's mass is held, within 1e-4, to
    the witness's: the same stream, slides and refine through the port on
    the CPU (f32, bf16 delivery), where the plain version sums and no
    kernel runs (``cpu_witness_s``: what it took)."""
    src, dst, n = synthetic_powerlaw_stream(n, w + (steps + warmup + prof_steps + 1) * b,
                                            seed=seed)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(dtype=torch.float32, rebuild_every=rebuild_every, bf16d=bf16d)
    drv = FastStreamDriver(src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b),
                           device=dev, **kw)
    res = {"n": n, "window": w, "slide": b, "sources": s, "rebuild_every": rebuild_every,
           "bf16d": bf16d, "warmup": warmup, "steps": steps,
           "tiers": [list(t) for t in drv.tiers], **run_stream(drv, warmup, steps)}
    if prof_steps:
        res["profile"] = profile_slides(drv, prof_steps)
    twin = None
    if bf16d:
        t0 = time.perf_counter()
        twin = FastStreamDriver(src, dst, n, list(range(s)), cfg,
                                StreamConfig(window=w, slide=b), device="cpu", **kw)
        twin.seed()
        for _ in twin.run(warmup + steps + prof_steps):
            pass
        res["cpu_witness_s"] = time.perf_counter() - t0
    res["contract"] = exact_contract(drv, None, k, 16, cfg.eps * w,
                                     twin and state_mass(twin, 16))
    serve = serve_check(drv, eps_r=eps_r, k=k)
    res["launches_by_entry"] = launches_by_entry()
    if min(res["launches_by_entry"][e] for e in ("segsum_gather_add", "scan_pass")) <= 0:
        raise AssertionError(f"the stream never launched the segment sum or the scan pass: {res}")
    # what follows compares and launches nothing of the port's on the card
    if twin:
        t0 = time.perf_counter()
        twin.refine(eps_r)
        res["cpu_witness_s"] += time.perf_counter() - t0
    res["contract_refined"] = exact_contract(drv, serve.pop("ids"), k, 16, cfg.eps * w,
                                             twin and state_mass(twin, 16))
    res.update(serve, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return res


# what a path through the dense engine launches on the card: K1's gather
# entry and K2 each round, K3 each loop's first count, K4's prime and turn
DENSE_ENTRIES = ("segsum_gather_add", "scan_pass", "frontier_rows", "loop_prime", "loop_turn")


def check_dense_launched(by_path: dict) -> dict:
    """Every path named (its launches by entry) launched each of
    ``DENSE_ENTRIES``."""
    for path, counts in by_path.items():
        missing = [e for e in DENSE_ENTRIES if counts[e] <= 0]
        if missing:
            raise AssertionError(f"{path} never launched {missing}: {counts}")
    return by_path


def dense_loops(g: RoundGraphs, loops: int, dev) -> dict:
    """A dense engine's ``RoundGraphs`` summary after ``loops`` loops; on
    the card each loop must have been one loop graph launch and one read of
    its carry (run under ``no_host_loop``)."""
    res = {**g.summary(), "loops": loops}
    if dev.type == "cuda" and not res["loop_launches"] == res["reads"] == loops:
        raise AssertionError(f"{loops} dense loops ran as {res['loop_launches']} loop graph "
                             f"launches and {res['reads']} reads: {res}")
    return res


def dense_check(dev) -> dict:
    """The dense driver (``StreamDriver``: its rounds K2 then K1, each loop
    one conditional graph steered by K4 on the card) on the card, both
    modes, at N=300 and a window of 1,500 edges, with slides of 100 edges
    and of 1 edge: after the slides every query is held to exact PPR on the
    window the driver then holds (forward: L1 within eps * W and mass within
    1e-3; reverse: max error within 2 eps). On the card each driver's loops
    (its seed's and each slide's) must each be one loop graph launch and
    one read (``dense_loops``), and every kernel of ``DENSE_ENTRIES`` must
    have launched."""
    w = 1500
    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)
    queries = [0, 7, 99]
    reset_launches()
    res = {"n": n, "window": w, "queries": len(queries)}
    for mode, tag in ((0, "forward"), (REVERSE, "reverse")):
        for b, slides in ((100, 8), (1, 60)):
            drv = StreamDriver(src, dst, n, queries, cfg, StreamConfig(window=w, slide=b),
                               mode=mode, device=dev)
            with no_host_loop(dev):
                rounds = drv.seed().rounds + sum(st.rounds for st in drv.run(slides))
            sync(dev)
            res[f"{tag}_slide{b}_graphs"] = dense_loops(drv.round_graphs, 1 + slides, dev)
            if drv.state.p.device.type != dev.type or drv.head != w + slides * b:
                raise AssertionError(f"the dense driver did not run its slides on {dev}")
            hs, hd = src[drv.head - w:drv.head], dst[drv.head - w:drv.head]
            p = drv.state.p[:n].double().cpu().numpy()
            if mode == REVERSE:
                exact = exact_ppr_columns(hs, hd, n, queries, cfg.alpha, tol=1e-12, device=dev)
                err, bound = float(np.abs(p - exact.T).max()), 2 * cfg.eps
            else:
                exact = exact_ppr(hs, hd, n, queries, cfg.alpha, tol=1e-12, device=dev)
                err, bound = max(l1_error(p[:, j], pi) for j, pi in enumerate(exact)), cfg.eps * w
                mass = float(np.abs(p.sum(0) + drv.state.r[:n].double().cpu().numpy().sum(0)
                                    - 1.0).max())
                res[f"{tag}_slide{b}_mass_err"] = mass
                if mass > 1e-3:
                    raise AssertionError(f"dense {tag} stream, slide {b}: mass off by {mass}")
            res.update({f"{tag}_slide{b}_rounds": rounds, f"{tag}_slide{b}_err": err,
                        f"{tag}_slide{b}_bound": bound})
            if not err <= bound:
                raise AssertionError(f"dense {tag} stream, slide {b}: error {err} > {bound}")
    res["kernel_launches"] = all_launches()
    res["launches_by_entry"] = launches_by_entry()
    if dev.type == "cuda":
        check_dense_launched({"dense_driver": res["launches_by_entry"]})
    return res


def static_check(dev, idx: int) -> dict:
    """Phase 9: ``run_config(idx)`` for config 1 (with its exact check) or
    config 4 (16 sampled sources held to exact PPR) on the dense engine,
    through a ``RoundGraphs`` of this function's, so that its summary (the
    loop graph's launch, its captures and their seconds, the host's reads)
    is reported beside the config's keys; with the launches by entry (the
    counts set to 0 just before) and the peak memory. On the card the push
    must be one loop graph launch and one read, and launch every kernel of
    ``DENSE_ENTRIES``."""
    g = RoundGraphs({1: 1000, 4: C4_N}[idx], 1, dev)
    kw = {"check_exact": 16} if idx == 4 else {}
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with no_host_loop(dev):
        out = run_config(idx, device=dev, graphs=g, **kw)
    out["launches_by_entry"] = launches_by_entry()
    out["graphs"] = dense_loops(g, 1, dev)
    out["peak_mem_gib"] = peak_gib(dev)
    if dev.type == "cuda":
        check_dense_launched({f"static_config{idx}": out["launches_by_entry"]})
    if not out["within_bound"]:
        raise AssertionError(f"config {idx}'s pushed state misses its bound: {out}")
    return out


def checkpoint_check(drv: FastStreamDriver, n_check: int, l1_bound: float) -> dict:
    """Save ``drv`` mid-stream, load the file on the card, step both one
    slide: each holds the exact-PPR contract (L1 and mass), and they agree
    to 1e-5 in ``settled_distance`` (the small scatters use atomics on CUDA,
    so no bit-identity is asserted, and ``max |dp|``, printed beside it,
    jumps whenever a residual at its threshold is pushed in one run
    only)."""
    dev = drv.device
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stream.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, drv)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        twin = load_checkpoint(path, drv.stream_src, drv.stream_dst, device=dev)
        sync(dev)
        load_s = time.perf_counter() - t0
    if not isinstance(twin, FastStreamDriver) or (twin.head, twin.fcnt) != (drv.head, drv.fcnt):
        raise AssertionError("the loaded driver is not where the saved one was")
    rounds = []
    for d in (drv, twin):
        stats = list(d.run(1))
        if len(stats) != 1:
            raise AssertionError("no slide left in the stream")
        rounds.append(stats[0].rounds)
    sync(dev)
    diff = settled_distance(drv.state, twin.state, drv.cfg.alpha)
    if diff > 1e-5:
        raise AssertionError(
            f"saved and loaded driver differ after one slide: max |d(p + alpha r)| {diff}")
    contracts = [exact_contract(d, None, 0, n_check, l1_bound) for d in (drv, twin)]
    return {"save_s": save_s, "load_s": load_s, "file_mb": size_mb, "rounds": rounds,
            "max_abs_settled": diff,
            "max_abs_dp": float((drv.state.p - twin.state.p).abs().max()), "l1_max": [c["l1_max"] for c in contracts],
            "mass_err_max": [c["mass_err_max"] for c in contracts], "l1_bound": l1_bound}


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


def run_cli(argv: list[str]) -> dict:
    """``pprx_torch.cli.main(argv)`` in this process, with the segment-sum
    counts set to 0 before it: its summary (the last line it prints, as
    JSON), its wall seconds and its launches by entry."""
    out = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        cli.main(argv)
    wall = time.perf_counter() - t0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    return {**res, "cli_s": wall, "launches_by_entry": launches_by_entry()}


def write_edge_text(path: str, src: np.ndarray, dst: np.ndarray) -> None:
    """The stream as ``src dst t`` lines, ``t`` the edge's position."""
    np.savetxt(path, np.column_stack([src, dst, np.arange(src.shape[0])]), fmt="%d")


def read_log(path: str, event: str) -> list[dict]:
    with open(path) as f:
        return [rec for rec in map(json.loads, f) if rec["event"] == event]


def serve_precision(log_path: str, graph: str, head: int, w: int, queries: list[int], k: int,
                    dev) -> dict:
    """The last serve event's id rows (``--emit-ids``) against exact PPR of
    the window that read saw (``[head - w, head)`` of the packed stream; f64
    power iteration on ``dev``): mean precision@k, which must be >= 0.95."""
    ids = np.asarray(read_log(log_path, "serve")[-1]["ids"])
    src, dst, n = load_packed(graph)
    pis = exact_ppr(src[head - w:head], dst[head - w:head], n, queries[:ids.shape[0]], 0.15,
                    tol=1e-10, device=dev)
    prec = float(np.mean([precision_at_k(row, pi, k) for row, pi in zip(ids, pis)]))
    if prec < 0.95:
        raise AssertionError(f"served top-{k} precision {prec} < 0.95 ({log_path})")
    return {"precision_at_k": prec, "sources": int(ids.shape[0])}


FAST_CLI_PATHS = ("cli_serve_budget", "cli_serve_event", "cli_stream", "cli_retrieve_refine",
                  "cli_bench_headline", "cli_bench_config2")
DENSE_CLI_PATHS = ("cli_static", "cli_retrieve_cold", "cli_stream_dense")


def cli_phase(dev, tmp: str, n: int, w: int, b: int, s: int, k: int = 100,
              small: tuple = (1000, 100_000), dense: tuple = (300, 1500, 100)) -> dict:
    """Phase 13: the command line through ``run_cli`` on ``dev``, files
    under ``tmp``, on the headline stream (``n`` vertices, window ``w``,
    slide ``b``, ``s`` served sources; seed 7), config 1's graph size
    (``small``: vertices, edges) and a small dense stream (``dense``:
    vertices, window, slide). Raises where a command's output is wrong.
    Returns each command's summary under its path's name; each carries its
    launches by entry, which ``check_cli_launches`` holds."""
    dv = ["--device", str(dev)]
    res = {}
    # 13a convert: text -> packed, held to renumber(); parsers held to each other
    m = w + 10 * b
    src, dst, _ = synthetic_powerlaw_stream(n, m, seed=7)
    text, graph = os.path.join(tmp, "stream.txt"), os.path.join(tmp, "stream.npz")
    t0 = time.perf_counter()
    write_edge_text(text, src, dst)
    write_s = time.perf_counter() - t0
    conv = run_cli(["convert", text, graph])
    want = renumber(src, dst)
    got = load_packed(graph)
    if (conv["n"], conv["edges"]) != (want[2], m) or got[2] != want[2] or not (
            np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError(f"convert disagrees with renumber(): {conv}")
    head_text = os.path.join(tmp, "head.txt")
    lines = min(m, 200_000)
    write_edge_text(head_text, src[:lines], dst[:lines])
    nat, py = (load_edge_list(head_text, use_native=u) for u in (True, False))
    if nat[2] != py[2] or not all(np.array_equal(a, c) for a, c in zip(nat[:2], py[:2])):
        raise AssertionError("the native and the Python parsers disagree")
    t0 = time.perf_counter()
    native_io.parse_edgelist_raw(text)
    res["cli_convert"] = {**conv, "text_write_s": write_s, "parsers_held_lines": lines,
                          "native_parse_s": time.perf_counter() - t0}
    n_graph = conv["n"]
    queries = list(range(min(s, n_graph)))
    qs = ["--queries", ",".join(map(str, queries))]
    shape = ["--window", str(w), "--slide", str(b)]

    # 13b, 13c serve: budget mode, then event mode
    for tag, steps, extra in (("cli_serve_budget", 8, ["--refine-budget", "6"]),
                              ("cli_serve_event", 4, ["--refine-budget", "0"])):
        log_path = os.path.join(tmp, f"{tag}.jsonl")
        out = run_cli(["serve", graph, *shape, "--steps", str(steps), *extra,
                       "--serve-every", "4", "--k", str(k), "--emit-ids", "16", *qs,
                       "--log", log_path, *dv])
        if (out["steps"], out["serve_events"]) != (steps, steps // 4):
            raise AssertionError(f"{tag}: {out}")
        slides = read_log(log_path, "slide")
        out["slide_wall_ms"] = [rec["wall_ms"] for rec in slides]
        out["refine_rounds"] = [rec.get("refine_rounds") for rec in slides]
        out["event_refines"] = read_log(log_path, "event_refine")
        out["read_ms"] = [rec["latency_ms"] for rec in read_log(log_path, "serve")]
        out["exact"] = serve_precision(log_path, graph, w + steps * b, w, queries, k, dev)
        res[tag] = out

    # 13d stream with a checkpoint, then retrieve from it with a refine
    ck = os.path.join(tmp, "ck.npz")
    res["cli_stream"] = run_cli(["stream", graph, *shape, "--steps", "4", *qs, "--checkpoint",
                                 ck, "--checkpoint-every", "4", "--log",
                                 os.path.join(tmp, "stream.jsonl"), *dv])
    out = run_cli(["retrieve", graph, "--from-checkpoint", ck, "--k", str(k), "--refine-eps",
                   "5e-8", *dv])
    if out["batch"] != len(queries) or out["refine_rounds"] <= 0:
        raise AssertionError(f"retrieve --from-checkpoint did not refine: {out}")
    res["cli_retrieve_refine"] = out
    # ... and the paths through the dense engine, on small graphs
    small_graph = os.path.join(tmp, "small.npz")
    save_packed(small_graph, *synthetic_powerlaw_stream(small[0], small[1], seed=1))
    out = run_cli(["static", small_graph, "--check-exact", *dv])
    if not all(e <= out["l1_bound"] for e in out["l1_error"]):
        raise AssertionError(f"static --check-exact misses its L1 bound: {out}")
    res["cli_static"] = out
    out = run_cli(["retrieve", small_graph, "--queries", "random", "--batch", "64", "--k",
                   str(k), *dv])
    if out["batch"] != 64 or out["push_rounds"] <= 0:
        raise AssertionError(f"cold retrieve: {out}")
    res["cli_retrieve_cold"] = out
    dense_graph = os.path.join(tmp, "dense.npz")
    dn, dw, db = dense
    save_packed(dense_graph, *synthetic_powerlaw_stream(dn, dw + 4 * db, seed=5))
    out = run_cli(["stream", dense_graph, "--window", str(dw), "--slide", str(db), "--steps",
                   "3", "--engine", "dense", "--queries", "0,7,99", *dv])
    if out["steps"] != 3 or out["rounds"] <= 0:
        raise AssertionError(f"dense stream: {out}")
    res["cli_stream_dense"] = out

    # 13e bench: the headline runner at its settings, then config 2 on the file
    out = run_cli(["bench", *dv])
    if (out["top100_precision"] < 0.95 or out["l1_vs_exact_mean"] > out["l1_bound_eps_E"]
            or not out["bf16_updates_per_sec"]):
        raise AssertionError(f"bench (headline): {out}")
    res["cli_bench_headline"] = out
    out = run_cli(["bench", "--config", "2", "--graph", graph, *dv])
    if out["n"] != n_graph or out["steps"] != 10 or out["updates_per_sec"] <= 0:
        raise AssertionError(f"bench --config 2 --graph: {out}")
    res["cli_bench_config2"] = out

    # 13f the module as users start it: its own process (on the card unless
    # this phase runs elsewhere)
    argv = [sys.executable, "-m", "pprx_torch.cli", "static", small_graph, "--check-exact"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv + ([] if dev.type == "cuda" else dv), capture_output=True,
                          text=True, timeout=300, cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv)} exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["rounds"] != res["cli_static"]["rounds"] or not all(
            e <= out["l1_bound"] for e in out["l1_error"]):
        raise AssertionError(f"the subprocess's static run: {out}")
    res["cli_subprocess_static"] = {**out, "process_s": time.perf_counter() - t0}
    return res


def serve_split(dev, graph: str, w: int, b: int, s: int, steps: int = 8, budget: int = 6,
                serve_every: int = 4, k: int = 100, eps_r: float = 5e-8,
                rebuild_every: int = 8) -> dict:
    """Where ``serve``'s slide stall goes: its budget-mode loop on the
    packed ``graph`` (f32 on ``dev``, sources ``0..s-1``), with a device sync
    after each part, so that each is timed apart on the host clock: the
    slide, the budgeted refine, and at each serve event the top-k read.
    ``rebuild_every``: 8 is the driver's default, which ``serve`` uses."""
    src, dst, n = load_packed(graph)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)
    drv = FastStreamDriver(src, dst, n, list(range(min(s, n))), cfg,
                           StreamConfig(window=w, slide=b), rebuild_every=rebuild_every,
                           device=dev)
    drv.seed()
    drv.refine(eps_r)
    sync(dev)
    parts = {"slide_ms": [], "refine_ms": [], "read_ms": [], "refine_rounds": []}
    for i in range(steps):
        t0 = time.perf_counter()
        list(drv.run(1))
        sync(dev)
        t1 = time.perf_counter()
        st = drv.refine(eps_r, rounds=budget)
        sync(dev)
        t2 = time.perf_counter()
        parts["slide_ms"].append((t1 - t0) * 1e3)
        parts["refine_ms"].append((t2 - t1) * 1e3)
        parts["refine_rounds"].append(st.rounds)
        if (i + 1) % serve_every == 0:
            topk_candidates(drv.state.p, k)
            sync(dev)
            parts["read_ms"].append((time.perf_counter() - t2) * 1e3)
    means = {f"{key}_mean": float(np.mean(v)) for key, v in parts.items() if key != "refine_rounds"}
    return {**parts, **means, "budget": budget, "rebuild_every": rebuild_every,
            "sources": drv.state.p.shape[1]}


def check_cli_launches(res: dict) -> dict:
    """Phase 13's launches by path: every path through the fast driver
    launched the gather entry, and every path through the dense engine
    each kernel of ``DENSE_ENTRIES``."""
    by_path = {path: res[path]["launches_by_entry"] for path in FAST_CLI_PATHS + DENSE_CLI_PATHS}
    for path in FAST_CLI_PATHS:
        if by_path[path]["segsum_gather_add"] <= 0:
            raise AssertionError(f"{path} never launched segsum_gather_add: {by_path[path]}")
    check_dense_launched({path: by_path[path] for path in DENSE_CLI_PATHS})
    return by_path


def peak_gib(dev) -> float | None:
    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None


def sharded_contract(drv: ShardedStreamDriver, n_check: int,
                     twin: ShardedStreamDriver | None = None) -> dict:
    """A sharded forward state against the exact-PPR contract on ``n_check``
    sampled sources: L1 to exact PPR of the final window (f64 power iteration
    on the driver's device) within eps * W, and ``|sum p + sum r - 1|``
    within 1e-3; with a ``twin`` (the same run where no kernel sums: bf16
    delivery conserves mass on no device) the mass within 1e-4 of the
    twin's instead."""
    n, w, head = drv.n, drv.scfg.window, drv.head

    def masses(d):
        p, r = d.host_p()[:n].astype(np.float64), d.host_r()[:n].astype(np.float64)
        return p, p[:, cols].sum(0) + r[:, cols].sum(0), r

    cols = np.linspace(0, drv.eng.s_total - 1, n_check).astype(int)
    p, mass, r = masses(drv)
    if not (np.isfinite(p).all() and np.isfinite(r).all()):
        raise AssertionError("non-finite sharded state")
    t0 = time.perf_counter()
    pis = exact_ppr(drv.stream_src[head - w:head], drv.stream_dst[head - w:head], n,
                    [int(c) for c in cols], drv.cfg.alpha, tol=1e-10, device=drv.device)
    l1 = [l1_error(p[:, c], pi) for c, pi in zip(cols, pis)]
    res = {"sources": n_check, "l1_max": max(l1), "l1_mean": float(np.mean(l1)),
           "l1_bound": drv.cfg.eps * w, "mass_err_max": float(np.abs(mass - 1.0).max()),
           "exact_s": time.perf_counter() - t0}
    if twin is None:
        mass_off, res["mass_bound"] = res["mass_err_max"], 1e-3
    else:
        ref = masses(twin)[1]
        mass_off, res["mass_bound"] = float(np.abs(mass - ref).max()), 1e-4
        res.update(mass_err_max_ref=float(np.abs(ref - 1.0).max()), mass_off_ref=mass_off)
    if res["l1_max"] > res["l1_bound"] or mass_off > res["mass_bound"]:
        raise AssertionError(f"sharded exact-PPR contract failed: {res}")
    return res


def sharded_topk_check(drv: ShardedStreamDriver, k: int) -> dict:
    """``make_sharded_topk`` on a 1x1 driver's reserve against
    ``topk_candidates`` on the same ``p``: equal scores, equal ids wherever a
    score is not tied with its neighbour in the row; each timed once warm."""
    if drv.mesh.size != 1:
        raise AssertionError("the single-device head needs the whole reserve: a 1x1 mesh")
    topk = make_sharded_topk(drv.mesh, drv.n, drv.eng.n_local, k)
    times = {}
    for tag, fn in (("sharded", lambda: topk(drv.p)), ("single", lambda: topk_candidates(drv.p, k))):
        fn()
        sync(drv.device)
        t0 = time.perf_counter()
        sc, ids = fn()
        sync(drv.device)
        times[f"{tag}_ms"] = (time.perf_counter() - t0) * 1e3
        times[tag] = (sc.cpu().numpy(), ids.cpu().numpy())
    (sc, ids), (ref_sc, ref_ids) = times.pop("sharded"), times.pop("single")
    tied = np.zeros(ref_sc.shape, bool)
    tied[:, 1:] |= ref_sc[:, 1:] == ref_sc[:, :-1]
    tied[:, :-1] |= ref_sc[:, :-1] == ref_sc[:, 1:]
    if not np.array_equal(sc, ref_sc) or not np.array_equal(ids[~tied], ref_ids[~tied]):
        raise AssertionError("sharded top-k differs from the single-device head")
    return {"k": k, "ids_equal": bool(np.array_equal(ids, ref_ids)), "tied": int(tied.sum()),
            **times}


@contextlib.contextmanager
def no_host_loop(dev):
    """While this holds on the card, ``RoundGraphs.host_loop`` raises: a
    loop that ran on the host there would fail the phase."""
    if dev.type != "cuda":
        yield
        return
    host_loop = RoundGraphs.host_loop

    def refused(*args, **kw):
        raise AssertionError("a convergence loop ran on the host on the card")

    RoundGraphs.host_loop = refused
    try:
        yield
    finally:
        RoundGraphs.host_loop = host_loop


def sharded_loops(drv: ShardedStreamDriver, loops: int) -> dict | None:
    """A 1x1 wl driver's device loop on the card after ``loops`` loops (its
    seed's and its slides'): its ``RoundGraphs`` summary, which must show
    one loop graph launch and one read of the carry a loop; every round
    ran inside those graphs (``no_host_loop`` held). None elsewhere."""
    g = drv.eng.round_graphs
    if drv.device.type != "cuda" or g is None:
        return None
    res = {**g.summary(), "loops": loops}
    if res["loop_launches"] != loops or res["reads"] != loops:
        raise AssertionError(f"{loops} loops ran as {res['loop_launches']} loop graph launches "
                             f"and {res['reads']} reads: {res}")
    return {**res, "launches_per_loop": res["loop_launches"] / loops,
            "reads_per_loop": res["reads"] / loops, "rounds_outside_graphs": 0}


def config5_check(dev, bf16d: bool, n_check: int = 16, k: int = 100, prof: bool = False,
                  deliveries: bool = False, **shape) -> dict:
    """14a: ``config5_run`` (``run_config(5)``'s run: the headline shapes
    unless ``shape`` says otherwise; stream seed 5; seed, 3 warm-up and 5
    timed slides at mesh 1x1), with the counts set to 0 before it; with
    ``prof`` the stream's one slide left under the profiler, with the peak
    memory of that slide alone (``slide_peak_gib``); then the contract and
    (forward) the sharded top-k against the single-device head. With bf16
    delivery the mass is held to a witness: the same run through the port
    on the CPU, where the plain version sums and no kernel runs
    (``cpu_witness_s``: what it took); the loss is the reference's too
    (PERF.md §2). 14c runs it with ``engine="dense"`` and 15c with
    ``engine="wlp"``, each in both modes (``mode="reverse"``: the reverse
    contract, 15a's); ``round_kinds`` counts a wl engine's rounds by kind,
    from the loop's branch executions. The engine's loops run on the card
    as loop graphs (``graphs``: ``sharded_loops``, the seed's and 8 slides'
    before the profile) under the rules ``loop_rules`` names; K1's launches
    by call site beside the launches by entry (``k1_by_site``). With
    ``deliveries`` (``wlp``, its stream a slide longer:
    ``extra_slides=1``), last, K1 at the shape of the largest group sum of
    one more slide (``slide_deliveries``)."""
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with no_host_loop(dev):
        rep, drv = config5_run(device=dev, bf16d=bf16d, **shape)
    res = {**rep, "bf16d": bf16d, "rounds_per_slide": rep["rounds"] / rep["steps"],
           "wl_rounds_per_slide": rep["wl_rounds"] / rep["steps"], "peak_mem_gib": peak_gib(dev),
           "graphs": sharded_loops(drv, 4 + rep["steps"])}
    if prof:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res["profile"] = profile_slides(drv, 1)
        res["slide_peak_gib"] = peak_gib(dev)
    res.update(launches_by_entry=launches_by_entry(), k1_by_site=k1_by_site(),
               round_kinds=dict(getattr(drv.eng, "round_kinds", {})))
    g = drv.eng.round_graphs
    if g is not None:  # the rules the engine's loop graphs run under
        res["loop_rules"] = sorted({table.rule for _, _, table in g.loops})
    twin = None
    if bf16d:
        t0 = time.perf_counter()
        twin = config5_run(device="cpu", bf16d=True, **shape)[1]
        res["cpu_witness_s"] = time.perf_counter() - t0
    if shape.get("mode", "forward") == "forward":
        res["contract"] = sharded_contract(drv, n_check, twin)
        res["topk"] = sharded_topk_check(drv, k)
    else:  # the reverse state's columns are not retrieved by top-k (15a's)
        res["contract"] = reverse_contract(as_fast(drv), drv.cfg.eps, n_check=n_check)
    if deliveries:
        res["deliveries"] = slide_deliveries(drv, {"group_sum": ("group_sum",)})
    return res


def sharding_tax(dev, sharded_ups: float, n: int = 200_000, w: int = 2_000_000,
                 b: int = 160_000, s: int = 128, steps: int = 5, mode: int = 0) -> dict:
    """14b: ``FastStreamDriver`` on config 5's stream and shapes, rebuilding
    every 2 slides as the sharded engine's fresh ring of 2b does (bench.py's
    rule gives 2 at the headline too), timed as config 5 times itself: seed,
    3 warm-up, ``steps`` timed slides. The tax is the single-device rate over
    the sharded one at mesh 1x1. 15a: in reverse (``mode``)."""
    src, dst, n = synthetic_powerlaw_stream(n, w + (steps + 4) * b, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    drv = FastStreamDriver(src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b),
                           mode=mode, rebuild_every=2, device=dev)
    drv.seed()
    list(drv.run(3))
    sync(dev)
    t0 = time.perf_counter()
    stats = list(drv.run(steps))
    sync(dev)
    ups = 2 * b * steps / (time.perf_counter() - t0)
    return {"fast_updates_per_s": ups, "sharded_updates_per_s": sharded_ups,
            "tax": ups / sharded_ups, "fast_rounds_per_slide": sum(st.rounds for st in stats) / steps,
            "rebuild_every": drv.rebuild_every}


def sharded_dense_check(dev) -> dict:
    """14c: ``ShardedStreamDriver(engine="dense")`` at mesh 1x1 in both modes
    on phase 12's stream (N=300, W=1,500; slides of 100 edges and of 1),
    every query held to exact PPR on the window it then holds, as phase 12
    holds the dense driver. Each loop (the seed's, each slide's) is one loop
    graph launch and one read of its carry, none on the host, and the runs
    launch K1, K2, K3 and K4 (``DENSE_ENTRIES``)."""
    w = 1500
    src, dst, n = synthetic_powerlaw_stream(300, 3000, seed=5)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)
    queries = [0, 7, 99]
    reset_launches()
    res = {"n": n, "window": w, "queries": len(queries)}
    for mode, tag in ((0, "forward"), (REVERSE, "reverse")):
        for b, slides in ((100, 8), (1, 60)):
            drv = ShardedStreamDriver(src, dst, n, queries, cfg, StreamConfig(window=w, slide=b),
                                      make_row_mesh(1, 1), mode=mode, engine="dense", device=dev)
            with no_host_loop(dev):
                rounds = drv.seed()["rounds"] + sum(st["rounds"] for st in drv.run(slides))
            res[f"{tag}_slide{b}_graphs"] = sharded_loops(drv, 1 + slides)
            hs, hd = src[drv.head - w:drv.head], dst[drv.head - w:drv.head]
            p = drv.host_p()[:n].astype(np.float64)
            if mode == REVERSE:
                exact = exact_ppr_columns(hs, hd, n, queries, cfg.alpha, tol=1e-12, device=dev)
                err, bound = float(np.abs(p - exact.T).max()), 2 * cfg.eps
            else:
                exact = exact_ppr(hs, hd, n, queries, cfg.alpha, tol=1e-12, device=dev)
                err, bound = max(l1_error(p[:, j], pi) for j, pi in enumerate(exact)), cfg.eps * w
                mass = float(np.abs(p.sum(0) + drv.host_r()[:n].sum(0) - 1.0).max())
                res[f"{tag}_slide{b}_mass_err"] = mass
                if mass > 1e-3:
                    raise AssertionError(f"sharded dense {tag}, slide {b}: mass off by {mass}")
            res.update({f"{tag}_slide{b}_rounds": rounds, f"{tag}_slide{b}_err": err,
                        f"{tag}_slide{b}_bound": bound})
            if not err <= bound:
                raise AssertionError(f"sharded dense {tag}, slide {b}: error {err} > {bound}")
    res["launches_by_entry"] = launches_by_entry()
    if dev.type == "cuda":
        check_dense_launched({"sharded_dense_small": res["launches_by_entry"]})
    return res


def collectives_check(dev, tmp: str) -> dict:
    """14d: each collective wrapper of ``pprx_torch.dist.mesh`` once through a
    real process group of one (NCCL on the card, gloo on the CPU; a
    ``FileStore`` under ``tmp``), on the device's tensors: each result must
    be what the collective means at K=1 (its own input), and the stats
    reduction the values it was given."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        x = torch.arange(24, dtype=torch.float32, device=dev).reshape(12, 2)
        ids = torch.arange(16, dtype=torch.int32, device=dev).reshape(1, 16)
        mass = torch.rand((1, 16, 8), generator=torch.Generator().manual_seed(0)).to(dev)
        checks = {
            "reduce_scatter_f32": torch.equal(reduce_scatter_rows(x, group), x),
            "all_to_all_int32": torch.equal(all_to_all_rows(ids, group), ids),
            "all_to_all_f32": torch.equal(all_to_all_rows(mass, group), mass),
            "all_to_all_bf16": torch.equal(all_to_all_rows(mass.bfloat16(), group),
                                           mass.bfloat16()),
            "stats": gather_stats([torch.tensor(3, device=dev), 5, torch.tensor(True, device=dev)],
                                  group, dev).tolist() == [[3, 5, 1]],
        }
    finally:
        dist.destroy_process_group()
    if not all(checks.values()):
        raise AssertionError(f"a collective wrapper on {backend} differs from its K=1 meaning: "
                             f"{checks}")
    return {"backend": backend, **checks}


SHARDED_CLI_PATHS = ("cli_stream_sharded_wl", "cli_stream_sharded_dense",
                     "cli_bench_config5")


def sharded_cli(dev, tmp: str, graph: str, w: int, b: int, s: int) -> dict:
    """14e: ``stream --engine sharded-wl --mesh 1,1`` and ``stream --engine
    sharded --mesh 1,1`` (the dense engine; 4 slides each) on phase 13's
    converted file, no loop on the host, and ``bench --config 5``, in this
    process."""
    n_graph = int(load_packed(graph)[2])
    queries = ",".join(map(str, range(min(s, n_graph))))
    dv = ["--device", str(dev)]
    res = {}
    for path, engine in zip(SHARDED_CLI_PATHS, ("sharded-wl", "sharded")):
        with no_host_loop(dev):
            res[path] = run_cli([
                "stream", graph, "--window", str(w), "--slide", str(b), "--steps", "4",
                "--engine", engine, "--mesh", "1,1", "--queries", queries, "--log",
                os.path.join(tmp, f"{path}.jsonl"), *dv])
        if res[path]["steps"] != 4 or res[path]["n_chips"] != 1:
            raise AssertionError(f"stream --engine {engine}: {res[path]}")
    out = run_cli(["bench", "--config", "5", *dv])
    if out["config"] != 5 or out["mesh"] != "1x1" or out["updates_per_sec"] <= 0:
        raise AssertionError(f"bench --config 5: {out}")
    res["cli_bench_config5"] = out
    return res


def as_fast(drv: ShardedStreamDriver) -> types.SimpleNamespace:
    """A 1x1 sharded driver as the contracts read a ``FastStreamDriver``:
    its state, its window's edges, its queries (config 5's are 0..S-1)."""
    if drv.mesh.size != 1:
        raise AssertionError("the contracts need the whole state: a 1x1 mesh")
    w, head = drv.scfg.window, drv.head
    return types.SimpleNamespace(
        state=PprState(p=drv.p, r=drv.r, mode=drv.mode), n=drv.n, cfg=drv.cfg,
        device=drv.device, _queries=list(range(drv.eng.s_total)),
        hsrc=drv.stream_src[head - w:head], hdst=drv.stream_dst[head - w:head])


REVERSE_SPARE = 6  # 15a's profiled slide, 15b's 3 and 15d's 2 after 15a's run


def config5_reverse_check(dev, n_check: int = 16, prof: bool = False,
                          **shape) -> tuple[dict, ShardedStreamDriver]:
    """15a: ``config5_run(mode="reverse")`` (the wl engine at config 5's
    shapes, ``REVERSE_SPARE`` slides of stream left for 15a's profile, 15b
    and 15d) with the counts set to 0 before it: updates/s, rounds a slide,
    with ``prof`` one more slide under the profiler, the gather entry's
    launches scaled (the dense and compact rounds' receiver 1/d_out) and
    unscaled (the row-sum sweep) apart, peak memory, and the reverse
    contract on ``n_check`` sampled targets (phase 8's); its loops as
    14a's (``graphs``). Returns (result, driver)."""
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    with no_host_loop(dev):
        rep, drv = config5_run(device=dev, mode="reverse", extra_slides=REVERSE_SPARE - 1,
                               **shape)
    res = {**rep, "rounds_per_slide": rep["rounds"] / rep["steps"],
           "wl_rounds_per_slide": rep["wl_rounds"] / rep["steps"], "peak_mem_gib": peak_gib(dev),
           "graphs": sharded_loops(drv, 4 + rep["steps"])}
    if prof:
        res["profile"] = profile_slides(drv, 1)
    res.update(launches_by_entry=launches_by_entry(),
               launches_scaled=launches_by_entry(scaled=True),
               round_kinds=dict(drv.eng.round_kinds))
    res["launches_unscaled"] = {e: res["launches_by_entry"][e] - res["launches_scaled"][e]
                                for e in segsum.ENTRIES}
    res["contract"] = reverse_contract(as_fast(drv), drv.cfg.eps, n_check=n_check)
    return res, drv


def rowsum_compare(eng, p, snap, egl, eog, eva, pack, counts) -> dict:
    """One reverse slide's row sums, before the slide runs: the sweep as
    the engine runs it (``rowsum_sweep``, twice: the launches must agree
    bit for bit) and its plain version in f64 on the same views, old
    (``s_old``) and with the batch's delta (``s_new``, the delta in the
    state's dtype for the engine's, in f64 for the plain one). At 1x1 the
    sweep is all local."""
    b, dev = eng.bcap, p.device
    _, _, clear, _, wdl, wsg = pack[:6 * b].reshape(6, b).unbind(0)
    got, again = (eng.rowsum_sweep(p, snap)[0] for _ in range(2))
    p64 = p.double()
    p_ext = torch.cat([p64, torch.zeros((1, p.shape[1]), dtype=p64.dtype, device=dev)])
    want = torch.zeros_like(p64)
    for v in ("d", "fd"):
        segsum_gather_add_plain(want, p_ext, snap[f"{v}_gat"], snap[f"{v}_loff"])
    wv = (torch.arange(b, device=dev) < int(counts[2]))[:, None]
    deltas = []
    for q in (p, p64):
        d = torch.zeros_like(q)
        d.index_add_(0, eog[clear], -q[egl[clear]] * eva[clear].to(q.dtype)[:, None])
        d.index_add_(0, wsg, q[wdl] * wv.to(q.dtype))
        deltas.append(d)
    s_new, s_new_plain = got + deltas[0], want + deltas[1]
    scale = max(float(want.abs().max()), float(s_new_plain.abs().max()))
    return {"bit_identical": torch.equal(got, again),
            "s_old_rel_err": float((got.double() - want).abs().max()) / scale,
            "s_new_rel_err": float((s_new.double() - s_new_plain).abs().max()) / scale,
            "max_abs_s": scale}


def sweep_check(drv: ShardedStreamDriver, slides: int = 3) -> dict:
    """15b, anomaly (ii) on the card: on each of ``slides`` slides of a 1x1
    reverse wl driver, ``rowsum_compare`` before the slide runs. The sweep
    must agree with its plain version within 1e-5 relative to max |s| and
    repeat bit for bit. Its launches are comparisons and count on no path."""
    eng = drv.eng
    checks = []

    def checked(p, r, deg, egl, eog, eva, snap, pack, ring, counts):
        checks.append(rowsum_compare(eng, p, snap, egl, eog, eva, pack, counts))
        return type(eng).slide_wl(eng, p, r, deg, egl, eog, eva, snap, pack, ring, counts)

    eng.slide_wl = checked
    try:
        ran = len(list(drv.run(slides)))
    finally:
        del eng.slide_wl
    res = {"slides": ran, "tol": 1e-5,
           **{key: [c[key] for c in checks] for key in checks[0]}}
    if ran != slides or not all(res["bit_identical"]) or max(
            res["s_old_rel_err"] + res["s_new_rel_err"]) > 1e-5:
        raise AssertionError(f"the reverse row-sum sweep differs from its plain version: {res}")
    return res


def sharded_checkpoint_check(drv: ShardedStreamDriver, tmp: str, n_check: int = 16) -> dict:
    """15d: a sharded checkpoint of 15a's reverse driver on the card: the
    save and the load timed apart; both drivers step 2 slides and must agree
    to 1e-5 in ``settled_distance``, as phase 10 holds its pair (the small
    scatters use atomics on CUDA: no bit-identity here), and each holds the
    reverse contract. The loaded engine's loops run on the card as loop
    graphs of its own (``twin_graphs``)."""
    dev = drv.device
    path = os.path.join(tmp, "sharded.npz")
    t0 = time.perf_counter()
    save_sharded_checkpoint(path, drv)
    save_s = time.perf_counter() - t0
    size_mb = os.path.getsize(path) / 1e6
    t0 = time.perf_counter()
    twin = load_sharded_checkpoint(path, drv.stream_src, drv.stream_dst, drv.mesh, device=dev)
    sync(dev)
    load_s = time.perf_counter() - t0
    os.remove(path)
    if (twin.head, twin.step_idx, twin.eng.tiers) != (drv.head, drv.step_idx, drv.eng.tiers):
        raise AssertionError("the loaded sharded driver is not where the saved one was")
    with no_host_loop(dev):
        rounds = [[st["rounds"] for st in d.run(2)] for d in (drv, twin)]
    if any(len(r) != 2 for r in rounds):
        raise AssertionError("no 2 slides left in the stream")
    # the loaded engine binds graphs of its own: 2 loops, 2 launches
    twin_loops = sharded_loops(twin, 2)
    sync(dev)
    diff = settled_distance(PprState(drv.p, drv.r, drv.mode), PprState(twin.p, twin.r, twin.mode),
                            drv.cfg.alpha)
    if diff > 1e-5:
        raise AssertionError(
            f"saved and loaded sharded drivers differ after 2 slides: max |d(p + alpha r)| {diff}")
    contracts = [reverse_contract(as_fast(d), d.cfg.eps, n_check=n_check) for d in (drv, twin)]
    return {"save_s": save_s, "load_s": load_s, "file_mb": size_mb, "rounds": rounds,
            "twin_graphs": twin_loops,
            "max_abs_settled": diff, "max_abs_dp": float((drv.p - twin.p).abs().max()),
            "max_abs_err": [c["max_abs_err"] for c in contracts],
            "bound": [c["bound"] for c in contracts]}


SHARDED_CLI_PATHS_15 = ("cli_stream_sharded_wl_rev", "cli_stream_sharded_wlp")


def sharded_cli_15(dev, tmp: str, graph: str, w: int, b: int, s: int) -> dict:
    """15e: ``stream --engine sharded-wl --mode rev --mesh 1,1`` and
    ``stream --engine sharded-wlp --mesh 1,1`` (4 slides each) on phase
    13's converted file, in this process, no loop on the host."""
    n_graph = int(load_packed(graph)[2])
    queries = ",".join(map(str, range(min(s, n_graph))))
    res = {}
    for path, extra in zip(SHARDED_CLI_PATHS_15, (["sharded-wl", "--mode", "rev"],
                                                  ["sharded-wlp"])):
        with no_host_loop(dev):  # each loop a loop graph
            out = run_cli(["stream", graph, "--window", str(w), "--slide", str(b), "--steps",
                           "4", "--engine", *extra, "--mesh", "1,1", "--queries", queries,
                           "--log", os.path.join(tmp, f"{path}.jsonl"), "--device", str(dev)])
        if out["steps"] != 4 or out["n_chips"] != 1 or out["updates_per_sec"] <= 0:
            raise AssertionError(f"{path}: {out}")
        res[path] = out
    return res


HYBRID_CLI_PATHS = ("cli_stream_hybrid", "cli_stream_hybrid_rev", "cli_retrieve_hybrid")


def window_of(drv: HybridStreamDriver, queries) -> types.SimpleNamespace:
    """A hybrid driver as the contracts read a ``FastStreamDriver``: its
    state, its window's edges (the stream's last W before the head), its
    queries."""
    w, head = drv.scfg.window, drv.head
    return types.SimpleNamespace(
        state=drv.state, n=drv.n, cfg=drv.cfg, device=drv.device, _queries=list(queries),
        hsrc=drv.stream_src[head - w:head], hdst=drv.stream_dst[head - w:head])


@contextlib.contextmanager
def environ(**env):
    """``os.environ`` with ``env`` set, restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def loop_tally():
    """While this holds, the hybrid engine's convergence loops
    (``RoundGraphs.loop`` under ``loop.HYBRID``) are counted: ``loops``,
    the loop graph launches and the host's reads they took (on the card
    one each a loop), their rounds, and their arms' executions by kind
    (``sparse.arm_kinds``); ``other_loops`` counts the loops of other
    rules."""
    tally = {"loops": 0, "loop_graph_launches": 0, "reads": 0, "rounds": 0, "other_loops": 0,
             "arms": {"wl": 0, "sparse": 0, "dense": 0, "count": 0}}
    run = RoundGraphs.loop

    def counted(g, prologue, branches, table, c0ok, max_rounds):
        before = g.loop_launches
        values, reads = run(g, prologue, branches, table, c0ok, max_rounds)
        if not table.hybrid:
            tally["other_loops"] += 1
            return values, reads
        tally["loops"] += 1
        tally["loop_graph_launches"] += g.loop_launches - before
        tally["reads"] += reads
        tally["rounds"] += values[loop.ROUNDS]
        for kind in tally["arms"]:
            tally["arms"][kind] += arm_kinds(table, values)[kind]
        return values, reads

    RoundGraphs.loop = counted
    try:
        yield tally
    finally:
        RoundGraphs.loop = run


def hybrid_loops(tally: dict, cuda: bool) -> dict:
    """A path's hybrid loops (``loop_tally``): at least one ran, and on the
    card each was one loop graph launch and one read of its carry (the host
    loop refused, ``no_host_loop``), and K1's launches at the worklist and
    sparse-scan sites (counted from the carry: each arm's captured launches
    times its executions) are those arms' executions, one each. Call it
    right after the path, whose counts were set to 0 before it."""
    if tally["loops"] <= 0:
        raise AssertionError(f"no hybrid loop ran: {tally}")
    if cuda and not tally["loop_graph_launches"] == tally["reads"] == tally["loops"]:
        raise AssertionError(f"{tally['loops']} hybrid loops ran as "
                             f"{tally['loop_graph_launches']} loop graph launches and "
                             f"{tally['reads']} reads")
    sites, arms = k1_by_site(), tally["arms"]
    if cuda and (sites["worklist"], sites["sparse_scan"]) != (arms["wl"], arms["sparse"]):
        raise AssertionError(f"K1 launched {sites} by call site where the arms ran {arms}")
    return {**tally, "reads_per_loop": tally["reads"] / tally["loops"], "k1_by_site": sites}


def hybrid_bench(dev, **env) -> dict:
    """16a, first: the headline runner with ``PPRX_BENCH_ENGINE=hybrid``
    (bench.py's protocol and keys, the hybrid driver at its defaults, one
    block), with the counts set to 0 before it; the mean L1 within eps * W.
    Its precision@100 is the maintained state's (eps, no refine: bench.py
    refines only the fast driver), reported and not held to 0.95
    (``maintained_precision`` in 16a puts the fast driver's beside it).
    ``env``: more ``PPRX_BENCH_*`` settings."""
    reset_launches()
    with environ(PPRX_BENCH_ENGINE="hybrid", **{f"PPRX_BENCH_{k}": v for k, v in env.items()}), \
            loop_tally() as tally, no_host_loop(dev):
        out = headline.run(dev)
    out["launches_by_entry"] = launches_by_entry()
    out["loops"] = hybrid_loops(tally, dev.type == "cuda")
    if (out["config"]["engine"] != "hybrid" or len(out["blocks"]) != 1
            or not out["l1_vs_exact_mean"] <= out["l1_bound_eps_E"]
            or out["impl"] != "pprx_torch"):
        raise AssertionError(f"bench (hybrid): {out}")
    return out


def hybrid_timed(drv: HybridStreamDriver, warmup: int, steps: int) -> dict:
    """Seed, warm up, then time ``steps`` slides of a hybrid driver (host
    clock around a device sync): updates/s, rounds a slide and their kinds
    (worklist rounds, sparse and dense scans; scans by reason: candidate
    list, edge bound, live-overlay bound), the frontier's counts a slide
    (the count arm, not a round), the host's reads of a loop's counts a
    slide (``syncs``), snapshot rebuilds in the timed slides."""
    dev, b = drv.device, drv.scfg.slide
    t0 = time.perf_counter()
    seed = drv.seed()
    sync(dev)
    seed_s = time.perf_counter() - t0
    list(drv.run(warmup))
    sync(dev)
    stats, rebuilds, it = [], 0, drv.run(steps)
    t0 = time.perf_counter()
    for _ in range(steps):
        rebuilds += drv.ov_count + 2 * b > drv.graph.ov.src.shape[0]
        stats.append(next(it))
    sync(dev)
    wall = time.perf_counter() - t0
    per = {f"{k}_per_slide": sum(getattr(st, k) for st in stats) / steps
           for k in ("rounds", "wl_rounds", "scans_cand", "scans_fed", "scans_liv", "syncs")}
    kinds = {f"{k}_per_slide": sum(st.arms[k] for st in stats) / steps
             for k in ("sparse", "dense", "count")}
    by_tier = [sum(ex) / steps for ex in zip(*(st.arms["sparse_by_tier"] for st in stats))]
    return {"updates_per_s": 2 * b * steps / wall, "wall_s": wall, "seed_s": seed_s,
            "seed_rounds": seed.rounds, "seed_arms": seed.arms, "warmup": warmup,
            "steps": steps, **per, "rounds": [st.rounds for st in stats],
            "sparse_scans_per_slide": kinds["sparse_per_slide"],
            "dense_scans_per_slide": kinds["dense_per_slide"],
            "counts_per_slide": kinds["count_per_slide"],
            "sparse_scans_by_tier_per_slide": by_tier, "rebuilds": rebuilds,
            "edge_pushes_per_s": sum(st.edge_pushes for st in stats) / wall}


def hybrid_forward(dev, n: int, w: int, b: int, s: int, warmup: int = 6, steps: int = 8,
                   prof_steps: int = 1, spare: int = 2, n_check: int = 16
                   ) -> tuple[dict, HybridStreamDriver]:
    """16a: ``HybridStreamDriver`` forward at its defaults
    (``rebuild_every=4``) on the headline runner's stream (seed 7, its
    first edges repeated for the slides past the runner's), with the counts
    set to 0 before it: ``hybrid_timed``, peak memory, ``prof_steps``
    slides under the profiler, the exact-PPR contract on ``n_check``
    sampled sources. Then ``FastStreamDriver`` (bench.py's rebuild rule) on
    the same stream, timed the same way: both rates and their ratio. Leaves
    ``spare`` slides for 16d. Both at one head, the two states must agree
    to 1e-5 in ``settled_distance``; each one's maintained precision@100 is
    reported. Returns (result, hybrid driver)."""
    every = max(1, min(8, w // (6 * b)))
    src, dst, n = synthetic_powerlaw_stream(n, w + (8 + every + 2 + 1) * b, seed=7)
    more = (warmup + steps + prof_steps + spare + 1) * b + w - src.shape[0]
    if more > 0:
        src, dst = np.concatenate([src, src[:more]]), np.concatenate([dst, dst[:more]])
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    scfg = StreamConfig(window=w, slide=b)
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv = HybridStreamDriver(src, dst, n, list(range(s)), cfg, scfg, device=dev)
    with loop_tally() as tally, no_host_loop(dev):
        res = {"n": n, "window": w, "slide": b, "sources": s,
               "rebuild_every": drv.rebuild_every, "tiers": [list(t) for t in drv.tiers],
               "fcap": drv.fcap, "scan_ecap": drv.scan_ecap,
               "overlay_cap": int(drv.graph.ov.src.shape[0]), **hybrid_timed(drv, warmup, steps),
               "peak_mem_gib": peak_gib(dev)}
        if prof_steps:
            res["profile"] = profile_slides(drv, prof_steps)
    res["loops"] = hybrid_loops(tally, dev.type == "cuda")
    res["graphs"] = drv.round_graphs.summary()
    res["launches_by_entry"] = launches_by_entry()
    res["contract"] = exact_contract(window_of(drv, range(s)), None, 0, n_check, cfg.eps * w)
    fast = FastStreamDriver(src, dst, n, list(range(s)), cfg, scfg, rebuild_every=every,
                            device=dev)
    ft = run_stream(fast, warmup, steps)
    res["fast"] = {k: ft[k] for k in ("updates_per_s", "rounds_per_slide", "syncs_per_slide")}
    res["fast"]["rebuild_every"] = every
    res["fast_over_hybrid"] = ft["updates_per_s"] / res["updates_per_s"]
    # both at one head: the two engines' states side by side, held to each
    # other as phase 10 holds a saved and a loaded driver
    list(fast.run(prof_steps))
    res["maintained_precision"] = maintained_precision({"hybrid": drv, "fast": fast}, 100,
                                                       n_check)
    res["settled_vs_fast"] = settled_distance(drv.state, fast.state, cfg.alpha)
    if res["settled_vs_fast"] > 1e-5:
        raise AssertionError(f"the hybrid and the fast driver differ: {res}")
    return res, drv


def maintained_precision(drivers: dict, k: int, n_check: int) -> dict:
    """Forward drivers at one head of one stream: mean precision@k of each
    maintained state (its eps, no refine) against exact PPR of the window
    on ``n_check`` sampled sources (f64 power iteration on the device)."""
    drv = next(iter(drivers.values()))
    view = window_of(drv, range(drv.state.p.shape[1]))
    if any(d.head != drv.head for d in drivers.values()):
        raise AssertionError("the drivers are not at one head")
    cols = np.linspace(0, drv.state.p.shape[1] - 1, n_check).astype(int)
    pis = exact_ppr(view.hsrc, view.hdst, drv.n, [int(c) for c in cols], drv.cfg.alpha,
                    tol=1e-10, device=drv.device)
    out = {}
    for name, d in drivers.items():
        ids = topk_candidates(d.state.p, k)[1].cpu().numpy()
        out[name] = float(np.mean([precision_at_k(ids[c], pi, k) for c, pi in zip(cols, pis)]))
    return out


def hybrid_reverse(dev, n: int, w: int, b: int, s: int, warmup: int = 2, steps: int = 3,
                   n_check: int = 16) -> dict:
    """16b: ``HybridStreamDriver(mode=REVERSE)`` at its defaults on the
    headline stream (seed 7), with the counts set to 0 before it:
    ``hybrid_timed``, peak memory and the reverse contract on ``n_check``
    sampled targets at the maintained eps (phase 8's)."""
    src, dst, n = synthetic_powerlaw_stream(n, w + (warmup + steps + 1) * b, seed=7)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    reset_launches()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv = HybridStreamDriver(src, dst, n, list(range(s)), cfg, StreamConfig(window=w, slide=b),
                             mode=REVERSE, device=dev)
    with loop_tally() as tally, no_host_loop(dev):
        res = {"n": n, "window": w, "slide": b, "targets": s, **hybrid_timed(drv, warmup, steps),
               "peak_mem_gib": peak_gib(dev), "launches_by_entry": launches_by_entry()}
    res["loops"] = hybrid_loops(tally, dev.type == "cuda")
    res["contract"] = reverse_contract(window_of(drv, range(s)), cfg.eps, n_check=n_check)
    return res


def hybrid_no_worklist(dev, n: int = 20_000, w: int = 200_000, b: int = 4000, s: int = 16,
                       steps: int = 4, n_check: int = 8, deliveries: bool = False) -> dict:
    """16c: ``worklist=False`` (``push_to_convergence_hybrid``: every round a
    scan, sparse where the frontier fits and is worth it) on a small stream
    (seed 3) whose overlay is small beside the window, with the counts set
    to 0 before it: seed and ``steps`` slides, the exact-PPR contract, and
    the worklist driver on the same stream within 1e-5 in
    ``settled_distance``. Must run sparse scan arms, as the loops' carries
    count them (``scan_kinds``: each driver's arms by kind). With
    ``deliveries``, last, K1 at the shape of the driver's sparse scan, from
    one more slide without a worklist, and at the worklist driver's top and
    smallest tiers (tags ``small_wl_*``), from one more slide of it
    (``slide_deliveries``): the arms of a small stream, whose shapes 16f's
    headline tiers do not show."""
    src, dst, n = synthetic_powerlaw_stream(n, w + (steps + 1) * b, seed=3)
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)
    scfg = StreamConfig(window=w, slide=b)
    reset_launches()
    res, drivers = {"n": n, "window": w, "slide": b, "sources": s}, {}
    with loop_tally() as tally, no_host_loop(dev):
        for wl in (False, True):
            drv = HybridStreamDriver(src, dst, n, list(range(s)), cfg, scfg, worklist=wl,
                                     device=dev)
            stats = [drv.seed(), *drv.run(steps)]
            sync(dev)
            tag = "worklist" if wl else "no_worklist"
            res[f"{tag}_rounds"] = [st.rounds for st in stats]
            res[f"{tag}_scan_kinds"] = {k: sum(st.arms[k] for st in stats)
                                        for k in ("wl", "sparse", "dense", "count")}
            drivers[wl] = drv
    res["loops"] = hybrid_loops(tally, dev.type == "cuda")
    res["launches_by_entry"] = launches_by_entry()
    res["contract"] = exact_contract(window_of(drivers[False], range(s)), None, 0, n_check,
                                     cfg.eps * w)
    res["settled_distance"] = settled_distance(drivers[False].state, drivers[True].state,
                                               cfg.alpha)
    if res["settled_distance"] > 1e-5 or res["no_worklist_scan_kinds"]["sparse"] <= 0:
        raise AssertionError(f"worklist=False: {res}")
    if deliveries:
        res["deliveries"] = slide_deliveries(drivers[False], hybrid_arm_keys(drivers[False]))
        res["worklist_deliveries"] = slide_deliveries(
            drivers[True], {f"small_{t}": key for t, key in hybrid_arm_keys(drivers[True]).items()})
    return res


def hybrid_checkpoint_check(drv: HybridStreamDriver, n_check: int, l1_bound: float) -> dict:
    """16d: save 16a's driver mid-stream, load the file on the card: the
    writer's tuning carried attribute by attribute, a fresh snapshot and an
    empty overlay; both step 2 slides, hold the exact-PPR contract and
    agree to 1e-5 in ``settled_distance`` (phase 10's pair), with the
    counts set to 0 before it."""
    dev = drv.device
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hybrid.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, drv)
        save_s = time.perf_counter() - t0
        size_mb = os.path.getsize(path) / 1e6
        t0 = time.perf_counter()
        twin = load_checkpoint(path, drv.stream_src, drv.stream_dst, device=dev)
        sync(dev)
        load_s = time.perf_counter() - t0
    if (not isinstance(twin, HybridStreamDriver) or (twin.head, twin.step_idx) != (drv.head,
            drv.step_idx) or twin.ov_count != 0
            or any(getattr(twin, a) != getattr(drv, a) for a in HYBRID_TUNING)):
        raise AssertionError("the loaded hybrid driver is not where the saved one was")
    with loop_tally() as tally, no_host_loop(dev):
        rounds = [[st.rounds for st in d.run(2)] for d in (drv, twin)]
    if any(len(r) != 2 for r in rounds):
        raise AssertionError("no 2 slides left in the stream")
    loops = hybrid_loops(tally, dev.type == "cuda")
    sync(dev)
    diff = settled_distance(drv.state, twin.state, drv.cfg.alpha)
    if diff > 1e-5:
        raise AssertionError(
            f"saved and loaded hybrid drivers differ after 2 slides: max |d(p + alpha r)| {diff}")
    queries = range(drv.state.p.shape[1])
    contracts = [exact_contract(window_of(d, queries), None, 0, n_check, l1_bound)
                 for d in (drv, twin)]
    return {"save_s": save_s, "load_s": load_s, "file_mb": size_mb, "rounds": rounds,
            "ov_count_saved": drv.ov_count, "max_abs_settled": diff,
            "max_abs_dp": float((drv.state.p - twin.state.p).abs().max()),
            "l1_max": [c["l1_max"] for c in contracts],
            "mass_err_max": [c["mass_err_max"] for c in contracts],
            "loops": loops, "twin_graphs": twin.round_graphs.summary(),
            "launches_by_entry": launches_by_entry()}


def hybrid_cli(dev, tmp: str, graph: str, w: int, b: int, s: int, k: int = 100) -> dict:
    """16e: ``stream --engine hybrid`` (4 slides, forward with a checkpoint
    at its end, and ``--mode rev``) on phase 13's converted file, then
    ``retrieve --from-checkpoint`` on the forward stream's file, each with
    the counts set to 0 before it (``run_cli``)."""
    n_graph = int(load_packed(graph)[2])
    qs = ["--queries", ",".join(map(str, range(min(s, n_graph))))]
    shape = ["--window", str(w), "--slide", str(b), "--steps", "4", "--engine", "hybrid"]
    ck = os.path.join(tmp, "hybrid_ck.npz")
    res = {}
    for path, extra in zip(HYBRID_CLI_PATHS[:2], (["--checkpoint", ck, "--checkpoint-every", "4"],
                                                  ["--mode", "rev"])):
        with loop_tally() as tally, no_host_loop(dev):
            out = run_cli(["stream", graph, *shape, *qs, *extra, "--log",
                           os.path.join(tmp, f"{path}.jsonl"), "--device", str(dev)])
        if out["steps"] != 4 or out["updates_per_sec"] <= 0 or out["rounds"] <= 0:
            raise AssertionError(f"{path}: {out}")
        out["loops"] = hybrid_loops(tally, dev.type == "cuda")
        res[path] = out
    with loop_tally() as tally:
        out = run_cli(["retrieve", graph, "--from-checkpoint", ck, "--k", str(k), "--device",
                       str(dev)])
    if tally["loops"] or any(out["launches_by_entry"].values()):
        raise AssertionError(f"retrieve --from-checkpoint pushed: {tally}, {out}")
    if out["batch"] != min(s, n_graph) or out["k"] != k or out["queries_known"]:
        raise AssertionError(f"retrieve --from-checkpoint on a hybrid file: {out}")
    res["cli_retrieve_hybrid"] = out
    os.remove(ck)
    return res


@contextlib.contextmanager
def recorded_deliveries():
    """While this holds, convergence loops run on the host
    (``RoundGraphs.host_loop``: each arm's first run is eager, later ones
    replay its capture) and the inputs of eager deliveries are kept (on
    the card: a capture takes none): the hybrid engine's
    (``sparse._deliver_``), the first of each arm's shape under (site,
    snapshot lanes, overlay lanes), and ``wlp``'s group sum (the gather
    entry under the ``group_sum`` site), the one with the most lanes under
    ("group_sum",). Yields that dict."""
    got = {}
    deliver, gather, run_loop = sparse._deliver_, dist_wl.segsum_gather_add_, RoundGraphs.loop

    def eager() -> bool:
        return not (torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())

    def kept_deliver(r, moving_f, t, nbr, valid, mov_ov, sca, inv_deg, site):
        key = (site, nbr.shape[0], mov_ov.shape[0])
        if eager() and key not in got:
            got[key] = {"r": r.clone(), "moving_f": moving_f.clone(), "t": t.clone(),
                        "nbr": nbr.clone(), "valid": valid.clone(), "mov_ov": mov_ov.clone(),
                        "sca": sca.clone(), "site": site,
                        "inv_deg": None if inv_deg is None else inv_deg.clone()}
        return deliver(r, moving_f, t, nbr, valid, mov_ov, sca, inv_deg, site)

    def kept_gather(rin, table, gat, row_off, row_scale=None, site="other"):
        old = got.get(("group_sum",))
        if site == "group_sum" and eager() and (old is None or gat.shape[0] > old["gat"].shape[0]):
            got[("group_sum",)] = {"rin": rin.clone(), "table": table.clone(),
                                   "gat": gat.clone(), "row_off": row_off.clone()}
        return gather(rin, table, gat, row_off, row_scale, site)

    sparse._deliver_, dist_wl.segsum_gather_add_ = kept_deliver, kept_gather
    RoundGraphs.loop = RoundGraphs.host_loop
    try:
        yield got
    finally:
        sparse._deliver_, dist_wl.segsum_gather_add_ = deliver, gather
        RoundGraphs.loop = run_loop


def delivery_inputs(rec: dict) -> tuple:
    """A recorded hybrid delivery as K1 takes it: (``rin``, the sorted
    keys' row offsets, the table ``[moving_f; mov_ov]``, the sorted lanes'
    table rows, the per-row scale or None), from ``sparse.delivery_lanes``
    as ``sparse._deliver_`` sorts them."""
    r, n = rec["r"], rec["r"].shape[0] - 1
    keys, table, rows = sparse.delivery_lanes(
        n, *(rec[k] for k in ("moving_f", "t", "nbr", "valid", "mov_ov", "sca")))
    keys_s, order = torch.sort(keys, stable=True)
    scale = None if rec["inv_deg"] is None else rec["inv_deg"][:n].contiguous()
    return r[:n].contiguous(), row_offsets(keys_s, n), table, rows[order].contiguous(), scale


def refilled(rec: dict, seed: int = 0) -> dict:
    """A recorded delivery with the values it sums (a hybrid record's
    ``moving_f`` and ``mov_ov``, a group sum's ``table``) drawn anew in
    [0, 1) from ``seed``, as phase 3's tables are: the recorded layout
    (keys, lanes, rows, scale) with sums that KERNEL_TOL can hold. A
    round's own mass is ~1e-5 a lane, under KERNEL_TOL's absolute part, so
    a dropped or misrouted lane would pass unseen at the recorded values."""
    out = dict(rec)
    for k in ("moving_f", "mov_ov", "table"):
        if k in rec:
            v = rec[k]
            gen = torch.Generator(device=v.device).manual_seed(seed)
            out[k] = torch.rand(v.shape, generator=gen, dtype=v.dtype, device=v.device)
    return out


def captured(fn):
    """``fn`` captured in a CUDA graph, as a hybrid arm's work is (warmed up
    on a side stream first); the kernel launches the capture counted are
    taken back out."""
    counts = [dict(c) for c in graphs.KERNEL_COUNTS]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    for c, old in zip(graphs.KERNEL_COUNTS, counts):
        c.update(old)
    return graph


def scatter_form_(acc: torch.Tensor, rec: dict) -> None:
    """A recorded hybrid delivery as the reference writes it, with torch's
    scatter: the ``[ecap, S]`` contributions ``moving_f[t] * valid`` (in
    reverse times the receiver's 1/d_out, per lane), then ``index_add_``
    of them and of the overlay's rows into ``acc`` (``[N+1, S]``; the
    phantom row takes the invalid lanes). The port's arms do not run it:
    ``--turns``' ``delivery_forms`` times it beside theirs."""
    contrib = rec["moving_f"][rec["t"]] * rec["valid"].to(acc.dtype)[:, None]
    mov_ov, inv_deg = rec["mov_ov"], rec["inv_deg"]
    if inv_deg is not None:
        contrib = contrib * inv_deg[rec["nbr"]][:, None]
        mov_ov = mov_ov * inv_deg[rec["sca"]][:, None]
    acc.index_add_(0, rec["nbr"], contrib)
    acc.index_add_(0, rec["sca"], mov_ov)


def delivery_forms(rec: dict) -> dict:
    """One recorded hybrid delivery in both forms: the port's sorted one
    (``sparse._deliver_``: a stable sort, then K1) and the reference's
    scatter (``scatter_form_``), each held to the f64 plain sum of the
    same lanes within KERNEL_TOL, then timed in turns (device ms): issued eagerly (``<form>_ms``; ``host_paced`` names the
    forms whose eager time was the host's, not the device's) and as one
    replay of each form captured in a CUDA graph (``<form>_graph_ms``), as
    the loop's arms run them. Hold it at values in [0, 1) (``refilled``)."""
    args = [rec[k] for k in ("moving_f", "t", "nbr", "valid", "mov_ov", "sca", "inv_deg",
                             "site")]
    n = rec["r"].shape[0] - 1
    forms = {"sorted_form": lambda acc: sparse._deliver_(acc, *args),
             "index_add_form": lambda acc: scatter_form_(acc, rec)}
    rin, row_off, table, gat, scale = delivery_inputs(rec)
    ref = segsum_gather_add_plain(rin.double(), table.double(), gat, row_off,
                                  None if scale is None else scale.double())
    res = {}
    for name, form in forms.items():
        acc = rec["r"].clone()
        form(acc)
        got = acc[:n].double()
        res[f"{name}_max_abs_err"] = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=KERNEL_TOL, atol=KERNEL_TOL):
            raise AssertionError(f"the {name} of a {rec['site']} delivery disagrees with the "
                                 f"plain sum: {res}")
    acc = rec["r"].clone()
    paced = set()
    res.update(in_turns({f"{name}_ms": (lambda form=form: form(acc))
                         for name, form in forms.items()}, host_paced=paced))
    replays = {f"{name}_graph_ms": captured(lambda form=form: form(acc)).replay
               for name, form in forms.items()}
    res.update(in_turns(replays))
    res["host_paced"] = sorted(paced)
    return res


def recorded_rows(got: dict, tags: dict, timed: bool = True, forms: bool = False) -> dict:
    """K1 at the shapes of recorded deliveries (``recorded_deliveries``):
    for each tag, the record its key names (a hybrid arm's, or the group
    sum's), its values drawn anew in [0, 1) (``refilled``), held to the f64
    plain sum and timed as phase 3 times a layout (``check_layout``:
    kernel, plain version, library call, ``index_add_`` of the gathered
    rows; the bound from the rows of ``rin`` the lanes touch); with
    ``forms``, a hybrid delivery's two forms too (``delivery_forms``).
    ``missing``: the tags whose arm ran no delivery in the recorded
    slides."""
    res = {"missing": sorted(t for t, key in tags.items() if key not in got)}
    for tag, key in tags.items():
        if key not in got:
            continue
        rec = refilled(got[key])
        if key[0] == "group_sum":
            rin, row_off, table, gat, scale = (rec["rin"], rec["row_off"], rec["table"],
                                               rec["gat"], None)
        else:
            rin, row_off, table, gat, scale = delivery_inputs(rec)
            res[f"{tag}_lanes"] = {"snapshot": key[1], "overlay": key[2]}
            if forms:
                res.update({f"{tag}_{k}": v for k, v in delivery_forms(rec).items()})
        res.update(check_layout(f"{tag}_", rin, row_off, table, gat, row_scale=scale,
                                timed=timed, touched_rows=True))
        res[f"{tag}_touched_rows"] = int((row_off.diff() > 0).sum())
        res[f"{tag}_valid_lanes"] = int(row_off[-1] - row_off[0])
        del rec, rin, table, gat
        torch.cuda.empty_cache()
    return res


def hybrid_arm_keys(drv: HybridStreamDriver) -> dict:
    """The recorded-delivery keys (``recorded_deliveries``) of a hybrid
    driver's top and smallest worklist tiers, or without a worklist of its
    sparse scan."""
    ovcap = drv.graph.ov.src.shape[0]
    if not drv.worklist:
        return {"scan": ("sparse_scan", drv.ecap, ovcap)}
    (_, e0, o0), (_, e1, o1) = drv.tiers[0], drv.tiers[-1]
    return {"wl_top": ("worklist", e1, o1 or ovcap), "wl_smallest": ("worklist", e0, o0 or ovcap)}


def slide_deliveries(drv, tags: dict, forms: bool = False, timed: bool = True) -> dict:
    """One slide of ``drv`` (a hybrid or a sharded driver with a slide of
    stream left) with its loops on the host, so that each arm's first run
    is eager, and its deliveries recorded (``recorded_deliveries``); then
    K1 at the recorded shapes ``tags`` names (``recorded_rows``): held to
    the f64 plain sum, timed beside its bound, its plain version and
    ``index_add_`` (``timed``); with ``forms``, a hybrid delivery's two
    forms timed in turns."""
    with recorded_deliveries() as got:
        if len(list(drv.run(1))) != 1:
            raise AssertionError("no slide left in the stream")
    sync(drv.device)
    out = {"recorded": sorted(map(str, got)), **recorded_rows(got, tags, timed, forms)}
    if len(out["missing"]) == len(tags):
        raise AssertionError(f"the recorded slide ran none of {tags}: {out['recorded']}")
    return out


# ``--turns``' ``delivery_forms`` streams: (nodes, window, slide, sources,
# worklist, seed): the headline's (16a) and 16c's, the latter without a
# worklist, with one, and with one at S=64
FORM_STREAMS = {"headline": (200_000, 2_000_000, 160_000, 128, True, 7),
                "small_scan": (20_000, 200_000, 4000, 16, False, 3),
                "small_wl": (20_000, 200_000, 4000, 16, True, 3),
                "small_wl_s64": (20_000, 200_000, 4000, 64, True, 3)}


def delivery_forms_turn(dev, warmup: int = 2) -> dict:
    """``--turns``' ``delivery_forms``: for each stream of ``FORM_STREAMS``,
    a forward hybrid driver seeded and stepped ``warmup`` slides, then one
    slide recorded (``slide_deliveries``, untimed): at the shapes of its
    top and smallest worklist tiers (or of its sparse scan), both forms of
    the delivery, the sorted one and the scatter, held to the f64 plain
    sum and timed in turns."""
    out = {}
    for tag, (n, w, b, s, worklist, seed) in FORM_STREAMS.items():
        src, dst, n = synthetic_powerlaw_stream(n, w + (warmup + 2) * b, seed=seed)
        drv = HybridStreamDriver(src, dst, n, list(range(s)),
                                 PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000),
                                 StreamConfig(window=w, slide=b), worklist=worklist, device=dev)
        drv.seed()
        list(drv.run(warmup))
        rows = slide_deliveries(drv, hybrid_arm_keys(drv), forms=True, timed=False)
        out[tag] = {k: v for k, v in rows.items()
                    if "form" in k or k.endswith(("_lanes", "missing", "host_paced"))}
        out[tag]["sources"] = s
        del drv
        torch.cuda.empty_cache()
    return out


def check_hybrid_launched(runs: dict) -> dict:
    """Every hybrid path named (its ``launches_by_entry`` and its loops'
    arms, ``loops["arms"]``, both counted from one reset) launched K4's
    prime and turn; where a dense scan ran, K1's gather entry and K2; where
    a scan or a count of the frontier ran, K3. Returns path -> launches."""
    out = {}
    for path, (counts, arms) in runs.items():
        need = ["loop_prime", "loop_turn"]
        if arms["dense"]:
            need += ["segsum_gather_add", "scan_pass"]
        if arms["sparse"] + arms["dense"] + arms["count"]:
            need.append("frontier_rows")
        missing = [e for e in need if counts[e] <= 0]
        if missing:
            raise AssertionError(f"{path} ran {arms} and never launched {missing}: {counts}")
        out[path] = counts
    return out


def check_dense_row_passes(runs: dict) -> dict:
    """Every sharded wl run named (its ``launches_by_entry`` and its
    engine's ``round_kinds``, both counted from one reset): each dense round
    launched ``scan_pass`` once, and ``frontier_rows`` ran at least once
    and at most once a dense round. Returns path -> (dense rounds, the two
    launches)."""
    out = {}
    for path, res in runs.items():
        dense = res["round_kinds"]["dense"]
        scans, rescans = (res["launches_by_entry"][e] for e in ("scan_pass", "frontier_rows"))
        if dense <= 0 or scans != dense or not 0 < rescans <= dense:
            raise AssertionError(f"{path}: {dense} dense rounds launched scan_pass {scans} and "
                                 f"frontier_rows {rescans} times")
        out[path] = {"dense_rounds": dense, "scan_pass": scans, "frontier_rows": rescans}
    return out


def check_launched(by_path: dict, entry: str = "segsum_gather_add") -> dict:
    """Every path named launched ``entry``."""
    for path, counts in by_path.items():
        if counts[entry] <= 0:
            raise AssertionError(f"{path} never launched {entry}: {counts}")
    return by_path


# the kernels line's K1 rows at the shapes of recorded deliveries: the
# numbers ``recorded_rows`` keeps of each (f32 and bf16 tables)
RECORDED_WHATS = ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "library_ms",
                  "index_add_ms", "pair_ms", "max_abs_err", "call_ms")


def recorded_entry(rows: dict, tags) -> dict:
    """Each of ``tags``' numbers (``RECORDED_WHATS`` for the f32 and the
    bf16 table, the lanes, and a hybrid delivery's two forms) from
    ``recorded_rows``' output."""
    out = {}
    for tag in tags:
        if f"{tag}_gather_f32_ms" not in rows:
            continue
        out[tag] = {f"{dt}_{what}": rows[f"{tag}_gather_{dt}_{what}"]
                    for dt in ("f32", "bf16") for what in RECORDED_WHATS}
        out[tag].update({k[len(tag) + 1:]: v for k, v in rows.items()
                         if k.startswith(f"{tag}_") and "form" in k or k in (
                             f"{tag}_lanes", f"{tag}_valid_lanes", f"{tag}_edges",
                             f"{tag}_touched_rows")})
    return out


def kernel_entry(name: str, key: str, kern: dict, launches: dict,
                 recorded: dict | None = None, sites: dict | None = None) -> dict:
    """One entry of the kernels line from phase 3's numbers: the window
    scan's f32 figures (power-law rows) under the plain names; bf16, the
    other layouts (uniform rows, the short fresh view, for the gather entry
    the compact round with int64 ``gat``; and with a per-row scale the
    window and the fresh view, and at config 3's S=8 both of them; without
    one config 3's two at S=8 and config 2's two at S=16) beside them, and
    the launch floor at S=8 and S=16.
    ``launches`` maps each path driven to its count by entry: the main
    (forward) path's is the entry's ``launches``, and every path's stands
    under ``launches_by_path``. ``max_abs_err`` is the largest over every
    layout held, config 3's untimed ones (``held_untimed``) included. The
    gather entry's ``recorded``: its rows at the shapes of recorded
    deliveries (``recorded_entry``: the hybrid's worklist tiers, 16c's
    sparse scan and worklist tiers, ``wlp``'s group sum), whose errors count too; ``sites``:
    each path's launches by call site (``k1_by_site``)."""
    plain = ["", "uniform_", "short_"] + (["compact_"] if key == "gather" else [])
    plain += ["s8_unscaled_", "s8_fresh_unscaled_", "s16_", "s16_fresh_"]
    scaled = ["scaled_", "scaled_short_", "s8_", "s8_fresh_"]
    errs = {k: v for k, v in kern.items()
            if re.fullmatch(rf"\w*?{key}_(f32|bf16)_max_abs_err", k)}
    timed = {f"{lay}{key}_{dt}_max_abs_err" for lay in plain + scaled for dt in ("f32", "bf16")}
    # config 4's window (gather entry, f32): the dense round's delivery
    timed |= {k for k in errs if k.startswith("c4_")}
    whats = ["ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "share_of_bound",
             "call_ms", "library_call_ms"]
    by_path = {path: counts[name] for path, counts in launches.items()}
    recorded = recorded or {}
    out = {
        "name": name,
        "route": "cuda",
        "source": "pprx_torch/csrc/segsum.cu",
        "replaces": "pprx/engine/segsum.py:184",
        "launches": by_path["forward"],
        "launches_by_path": by_path,
        "max_abs_err": max([*errs.values(), *(v for row in recorded.values()
                                               for k, v in row.items()
                                               if k.endswith("max_abs_err"))]),
        "held_untimed": sorted({k.split(f"{key}_")[0] for k in set(errs) - timed}),
        "library_call": ("torch.sparse.addmm on a unit-valued CSR (a bf16 table through "
                         "table.float() first, timed with it: two calls)"
                         if key == "gather" else "index_add_ on prebuilt ids"),
        "scaled_library_call": "torch.sparse.addmm on a CSR whose values are row_scale[row]",
    }
    for tag in ("s8_", "s16_"):
        out[f"{tag}launch_floor_ms"] = kern[f"{tag}{key}_launch_floor_ms"]
        out[f"{tag}call_floor_ms"] = kern[f"{tag}{key}_call_floor_ms"]
    rows = {}
    for lay in plain + scaled:
        rows[f"{lay}chunk"] = kern[f"{lay}chunk"]
        extra = ["pair_ms", "index_add_ms"] if key == "gather" and lay in plain else []
        for what in whats + extra:
            for dt, tag in (("f32", ""), ("bf16", "bf16_")):
                if f"{lay}{tag}{what}" in rows:  # a layout's tag that ends as a key begins
                    raise AssertionError(f"kernels line: {lay}{tag}{what} names two numbers")
                rows[f"{lay}{tag}{what}"] = kern[f"{lay}{key}_{dt}_{what}"]
    if key == "gather":
        rows.update({k: v for k, v in kern.items() if k.startswith("c4_")})
        rows.update(at_recorded_shapes=recorded, launches_by_site_by_path=sites or {})
    return {**out, **rows}


# the row passes' entries of the kernels line: (TPU work they stand for,
# its lines in the reference) and the phase 3b case that is the main path's
ROWPASS_KERNELS = {
    "scan_pass": ("pprx/engine/wl2.py:201", "XLA's fusion of dense_round_sorted's elementwise "
                  "work (pprx/engine/wl2.py:201-219, 246, 283-288); no pl.pallas_call",
                  "headline_fwd_scan_pass_f32"),
    "frontier_rows": ("pprx/engine/wl2.py:510", "XLA's fusion of the rescan "
                      "(pprx/engine/wl2.py:510-516, 640-649); no pl.pallas_call",
                      "headline_fwd_frontier_rows"),
}


def rowpass_entry(name: str, rp: dict, launches: dict) -> dict:
    """One row pass's entry of the kernels line from phase 3b's numbers: the
    headline forward case (f32 ``moving`` for K2) under the plain names,
    every case held and timed beside them. ``launches`` as for
    ``kernel_entry``."""
    replaces, tpu, main = ROWPASS_KERNELS[name]
    by_path = {path: counts[name] for path, counts in launches.items()}
    out = {
        "name": name, "route": "cuda", "source": "pprx_torch/csrc/rowpass.cu",
        "replaces": replaces, "tpu_work": tpu,
        "launches": by_path["forward"], "launches_by_path": by_path,
        "max_abs_err": max(v for k, v in rp.items()
                           if k.endswith("_max_abs_err") and f"_{name}" in k),
        "library_ms": None, "library_call": "none: no single PyTorch call computes this",
    }
    for what in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "call_ms"):
        out[what] = rp[f"{main}_{what}"]
    out["cases"] = {k[:-3]: {what: rp[f"{k[:-3]}_{what}"] for what in (
        "ms", "plain_ms", "bound_ms", "share_of_bound", "call_ms", "max_abs_err")}
        for k in rp if k.endswith("_ms") and f"_{name}" in k and not k.endswith(
            ("_plain_ms", "_bound_ms", "_call_ms"))}
    return out


def loop_entry(step: str, k4: dict, launches: dict) -> dict:
    """One K4 step's entry of the kernels line from phase 3c's numbers;
    ``launches`` as for ``kernel_entry``."""
    by_path = {path: counts[f"loop_{step}"] for path, counts in launches.items()}
    return {
        "name": f"loop_{step}", "route": "cuda", "source": "pprx_torch/csrc/loop.cu",
        "replaces": "pprx/engine/wl2.py:687",
        "tpu_work": "the lax.while_loop of push_to_convergence_wl2, its lax.switch over the "
                    "tiers and its lax.cond (pprx/engine/wl2.py:617-687), of the sharded wl "
                    "engine at 1x1 (pprx/dist/wl.py:954-1025) and its memory-proportional "
                    "loop (pprx/dist/wl.py:1177-1214), of the dense engine's "
                    "push_to_convergence (pprx/engine/push.py:94-119), of the sharded "
                    "dense engine at 1x1 (pprx/dist/sharded.py:378-398) and of the hybrid "
                    "engine's two loops (pprx/engine/sparse.py:457-586, with the lax.switch "
                    "over the scan tiers at :193-201); no pl.pallas_call",
        "launches": by_path["forward"], "launches_by_path": by_path,
        **k4[step], "hybrid": k4.get(f"hybrid_{step}"), "library_ms": None,
        "library_call": "none: no PyTorch call sets a graph's conditions",
        "graph_kernel_floor_ms": k4["graph_kernel_floor_ms"],
        "body_kernel_ms": k4["body_kernel_ms"],
        "conditional_overhead_ms_per_round": k4["conditional_overhead_ms_per_round"],
    }


def build_all() -> dict:
    """Every kernel source built at once, one ``nvcc`` each, in parallel."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = dict(zip(KERNEL_SOURCES, pool.map(_ext.build, KERNEL_SOURCES)))
    for name in KERNEL_SOURCES:
        _ext.load(name)
    return builds


KERNEL_SOURCES = ("segsum", "rowpass", "loop")


def main() -> None:
    dev = require_cuda()
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log("1 device", name=name, count=count, nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    builds = build_all()
    log("2 build", seconds=time.perf_counter() - t0, **{name: {
        "seconds": b.seconds, "library": b.path.name,
        "ptxas": sorted({ln.split(":", 1)[1].strip() for ln in b.log.splitlines() if "Used" in ln})}
        for name, b in builds.items()})

    n, w, b, s = (HEADLINE[k] for k in "nwbs")
    kern = check_kernel(dev, n, w, s)
    kern.update(check_kernel_config3(dev))
    kern.update(check_kernel_config2(dev))
    torch.cuda.empty_cache()
    kern.update(check_kernel_config4(dev))
    log("3 kernel", **kern)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rp = check_rowpass(dev)
    log("3b row passes", **rp, seconds=time.perf_counter() - t0)
    torch.cuda.empty_cache()
    k4 = check_k4(dev)
    log("3c loop control", **k4)
    # every fast-driver loop from here on logs its rounds, and each phase's
    # line replays them through the plain steps
    graphs.LOG_SINK = []

    steps, prof_steps = HEADLINE["steps"], HEADLINE["prof_steps"]
    rebuild_every, warmup = headline_schedule(w, b)
    need = w + (steps + warmup + 2 * prof_steps + 1) * b
    src, dst, n = synthetic_powerlaw_stream(n, need, seed=HEADLINE["seed"])
    cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000)
    scfg = StreamConfig(window=w, slide=b)
    queries = list(range(s))

    # the main path: every launch from here to the top-k read counts
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    drv = FastStreamDriver(src, dst, n, queries, cfg, scfg, dtype=torch.float32,
                           rebuild_every=rebuild_every, device=dev)
    f32 = run_stream(drv, warmup, steps)
    f32["launches"] = segsum.launches()
    if f32["launches"] <= 0:
        raise AssertionError("the f32 stream never launched the segment-sum kernel")
    f32["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log("4 stream f32", n=n, window=w, slide=b, sources=s, rebuild_every=rebuild_every,
        tiers=[list(t) for t in drv.tiers], **f32)
    log("4 profile", **profile_slides(drv, prof_steps))
    log("4 prologue", **prologue_split(drv, prof_steps),
        note="the slide's prologue (one replay) against its loop (one graph launch)")

    drv16 = FastStreamDriver(src, dst, n, queries, cfg, scfg, dtype=torch.float32,
                             rebuild_every=rebuild_every, bf16d=True, device=dev)
    before = dict(segsum.LAUNCHES)
    bf16 = run_stream(drv16, warmup, steps)
    bf16["launches"] = segsum.launches(since=before)
    log("5 stream bf16", **bf16)
    del drv16
    torch.cuda.empty_cache()

    k = 100
    serve = serve_check(drv, eps_r=5e-8, k=k)
    launches = segsum.launches()
    by_entry = launches_by_entry()
    if min(launches, by_entry["scan_pass"], by_entry["frontier_rows"],
           *(by_entry[f"loop_{step}"] for step in loop.STEPS)) <= 0:
        raise AssertionError(f"the main path never launched one of its kernels: {by_entry}")
    contract = exact_contract(drv, serve.pop("ids"), k, 16, l1_bound=cfg.eps * w)
    log("6 serve", eps_retrieve=5e-8, k=k, **serve, **contract, launches_total=launches,
        launches_by_entry=by_entry)

    parity = parity_small(dev)
    log("7 parity", **parity)

    # the reverse path: config 3's shapes at S=8 and S=128, then full width;
    # each run sets the counts to 0 and reads them itself
    c3 = dict(CONFIG3, eps_r=5e-8)
    reverse = {
        "config3_s8": reverse_run(dev, s=8, **c3),
        "config3_s128": reverse_run(dev, s=128, **c3),
        "headline": reverse_run(
            dev, n=n, w=w, b=b, s=s, rebuild_every=rebuild_every, warmup=warmup, steps=steps,
            seed=HEADLINE["seed"], eps_r=5e-8, prof_steps=prof_steps),
    }
    for tag, res in reverse.items():
        log(f"8 reverse {tag.replace('_', ' ')}", **res)
    torch.cuda.empty_cache()

    # the static configs on the dense engine: each push one loop graph
    # launch; each run sets the counts to 0 and reads them itself
    static = {}
    for idx in (1, 4):
        static[idx] = static_check(dev, idx)
        log(f"9 static config{idx}", **static[idx])
        torch.cuda.empty_cache()

    reset_launches()
    log("10 checkpoint", **checkpoint_check(drv, 16, l1_bound=cfg.eps * w))
    ckpt_by_entry = launches_by_entry()

    # config 2 at its full shapes, f32 and bf16 delivery; each run sets the
    # counts to 0 and reads them itself
    c2 = dict(CONFIG2, s=C2_S, eps_r=5e-8, k=k)
    config2 = {"f32": forward_run(dev, prof_steps=prof_steps, **c2),
               "bf16": forward_run(dev, bf16d=True, **c2)}
    for tag, res in config2.items():
        log(f"11 forward config2 {tag}", **res)
    torch.cuda.empty_cache()

    dense = dense_check(dev)
    log("12 dense driver", **dense,
        note="K2 then K1 each round, each loop one graph launch steered by K4")
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        cli_res = cli_phase(dev, tmp, n=200_000, w=w, b=b, s=s, k=k)
        for tag, res in cli_res.items():
            log(f"13 {tag.replace('_', ' ')}", **res)
        cli_by_path = check_cli_launches(cli_res)
        # as serve runs (the driver's default rebuild_every), then with bench's rule
        for every in (8, rebuild_every):
            log(f"13 serve split rebuild_every={every}",
                **serve_split(dev, os.path.join(tmp, "stream.npz"), w, b, s, k=k,
                              rebuild_every=every))
        torch.cuda.empty_cache()

        # the sharded engines at mesh 1x1; each run sets the counts to 0 itself
        config5 = {tag: config5_check(dev, bf16d=tag == "bf16", prof=tag == "f32")
                   for tag in ("f32", "bf16")}
        for tag, res in config5.items():
            log(f"14a config5 {tag}", **res)
        sharded_by_path = check_launched({f"config5_{tag}": res["launches_by_entry"]
                                          for tag, res in config5.items()})
        log("14a dense rounds", **check_dense_row_passes(
            {f"config5_{tag}": res for tag, res in config5.items()}))
        torch.cuda.empty_cache()
        log("14b sharding tax", **sharding_tax(dev, config5["f32"]["updates_per_sec"]))
        torch.cuda.empty_cache()
        dense14 = sharded_dense_check(dev)
        sharded_by_path["sharded_dense_small"] = dense14["launches_by_entry"]
        log("14c sharded dense", **dense14,
            note="K2 then K1 each round over the window's slot view, each loop one graph "
                 "launch steered by K4")
        torch.cuda.empty_cache()
        # the dense engine at config 5's shapes; each run sets the counts to 0
        for mode in ("forward", "reverse"):
            res = config5_check(dev, bf16d=False, engine="dense", mode=mode)
            if res["loop_rules"] != [loop.DENSE]:
                raise AssertionError(f"dense {mode}: its loops ran under {res['loop_rules']}")
            log(f"14c config5 dense {mode}", **res)
            sharded_by_path[f"config5_dense_{mode}"] = res["launches_by_entry"]
            del res
            torch.cuda.empty_cache()
        cli5 = sharded_cli(dev, tmp, os.path.join(tmp, "stream.npz"), w, b, s)
        for tag, res in cli5.items():
            log(f"14e {tag.replace('_', ' ')}", **res)
        sharded_by_path.update(check_launched({path: cli5[path]["launches_by_entry"]
                                               for path in SHARDED_CLI_PATHS}))
        check_dense_launched({path: sharded_by_path[path] for path in (
            "config5_dense_forward", "config5_dense_reverse", "cli_stream_sharded_dense")})
        # the sharded engines' loops at 1x1 are loop graphs: K4 steers each
        check_launched({path: sharded_by_path[path] for path in (
            "config5_f32", "config5_bf16", *SHARDED_CLI_PATHS)}, "loop_prime")
        torch.cuda.empty_cache()
        log("14d collectives", **collectives_check(dev, tmp))

        # the rest of the sharded engines at mesh 1x1: the wl engine's
        # reverse slide, the memory-proportional loop, sharded checkpoints
        rev, rev_drv = config5_reverse_check(dev, prof=True)
        rev["tax"] = sharding_tax(dev, rev["updates_per_sec"], mode=REVERSE)
        log("15a config5 reverse", **rev)
        log("15a dense rounds", **check_dense_row_passes({"config5_rev": rev}))
        log("15b reverse rowsum sweep", **sweep_check(rev_drv))
        # wlp in both modes: its loops are loop graphs under K4's
        # proportional rule
        # wlp forward: its stream a slide longer, for K1 at its largest
        # group sum's shape
        wlp = {mode: config5_check(dev, bf16d=False, prof=mode == "forward", engine="wlp",
                                   mode=mode, **({"deliveries": True, "extra_slides": 1}
                                                 if mode == "forward" else {}))
               for mode in ("forward", "reverse")}
        wlp["forward"]["wl_slide_peak_gib"] = config5["f32"].get("slide_peak_gib")
        for mode, res in wlp.items():
            if res["loop_rules"] != [loop.PROPORTIONAL]:
                raise AssertionError(f"wlp {mode}: its loops ran under {res['loop_rules']}")
            if res["k1_by_site"]["group_sum"] <= 0:
                raise AssertionError(f"wlp {mode}: K1 never summed a group: {res['k1_by_site']}")
            log(f"15c config5 wlp{'' if mode == 'forward' else ' reverse'}", **res)
        log("15d sharded checkpoint", **sharded_checkpoint_check(rev_drv, tmp))
        del rev_drv
        torch.cuda.empty_cache()
        cli15 = sharded_cli_15(dev, tmp, os.path.join(tmp, "stream.npz"), w, b, s)
        for tag, res in cli15.items():
            log(f"15e {tag.replace('_', ' ')}", **res)
        sharded_by_path.update(check_launched(
            {"config5_rev": rev["launches_by_entry"],
             "config5_wlp": wlp["forward"]["launches_by_entry"],
             "config5_wlp_rev": wlp["reverse"]["launches_by_entry"],
             **{path: cli15[path]["launches_by_entry"] for path in SHARDED_CLI_PATHS_15}}))
        for entry in ("loop_prime", "loop_turn"):
            check_launched({path: sharded_by_path[path] for path in (
                "config5_rev", "config5_wlp", "config5_wlp_rev",
                *SHARDED_CLI_PATHS_15)}, entry)
        if min(rev["launches_unscaled"]["segsum_gather_add"],
               rev["launches_scaled"]["segsum_gather_add"]) <= 0:
            raise AssertionError(f"config5_rev: the sweep or the scaled rounds never launched "
                                 f"the gather entry: {rev['launches_scaled']}")

        # the hybrid engine: each loop one loop graph under K4's hybrid
        # rule; each run sets the counts to 0 itself
        hybrid = {"hybrid_bench": hybrid_bench(dev)}
        log("16a bench hybrid", **hybrid["hybrid_bench"])
        res16, hyb = hybrid_forward(dev, n=200_000, w=w, b=b, s=s)
        hybrid["hybrid_forward"] = res16
        log("16a hybrid forward", **res16)
        hybrid["hybrid_checkpoint"] = hybrid_checkpoint_check(hyb, 16, l1_bound=cfg.eps * w)
        log("16d hybrid checkpoint", **hybrid["hybrid_checkpoint"])
        deliveries16 = slide_deliveries(hyb, hybrid_arm_keys(hyb))
        log("16f hybrid deliveries", **deliveries16,
            note="K1 at the worklist tiers' recorded deliveries, and both forms of each")
        del hyb
        torch.cuda.empty_cache()
        hybrid["hybrid_reverse"] = hybrid_reverse(dev, n=200_000, w=w, b=b, s=s)
        log("16b hybrid reverse", **hybrid["hybrid_reverse"])
        torch.cuda.empty_cache()
        hybrid["hybrid_no_worklist"] = hybrid_no_worklist(dev, deliveries=True)
        log("16c hybrid no worklist", **hybrid["hybrid_no_worklist"])
        cli16 = hybrid_cli(dev, tmp, os.path.join(tmp, "stream.npz"), w, b, s, k=k)
        for tag, res in cli16.items():
            log(f"16e {tag.replace('_', ' ')}", **res)
        runs16 = {**hybrid, **{path: cli16[path] for path in HYBRID_CLI_PATHS[:2]}}
        hybrid_by_path = check_hybrid_launched(
            {path: (res["launches_by_entry"], res["loops"]["arms"]) for path, res in runs16.items()})
        hybrid_by_path["cli_retrieve_hybrid"] = cli16["cli_retrieve_hybrid"]["launches_by_entry"]
        torch.cuda.empty_cache()

    if "jax" in sys.modules or "pprx" in sys.modules:
        raise AssertionError("jax or the JAX package was imported")
    launches = {"forward": by_entry,
                **{f"forward_config2_{tag}": res["launches_by_entry"]
                   for tag, res in config2.items()},
                **{f"reverse_{tag}": res["launches_by_entry"] for tag, res in reverse.items()},
                **{f"static_config{idx}": res["launches_by_entry"] for idx, res in static.items()},
                "dense_driver": dense["launches_by_entry"], "checkpoint": ckpt_by_entry,
                **cli_by_path,
                **sharded_by_path, **hybrid_by_path}
    # K1 at the recorded shapes, and by call site where the new ones launch
    recorded = {**recorded_entry(deliveries16, ("wl_top", "wl_smallest")),
                **recorded_entry(hybrid["hybrid_no_worklist"]["deliveries"], ("scan",)),
                **recorded_entry(hybrid["hybrid_no_worklist"]["worklist_deliveries"],
                                 ("small_wl_top", "small_wl_smallest")),
                **recorded_entry(wlp["forward"]["deliveries"], ("group_sum",))}
    sites = {**{path: res["loops"]["k1_by_site"] for path, res in runs16.items()},
             **{f"config5_wlp{'' if m == 'forward' else '_rev'}": wlp[m]["k1_by_site"]
                for m in wlp}}
    print(json.dumps({"kernels": [
        kernel_entry("segsum_add", "add", kern, launches),
        kernel_entry("segsum_gather_add", "gather", kern, launches, recorded, sites),
        *(rowpass_entry(name, rp, launches) for name in ROWPASS_KERNELS),
        *(loop_entry(step, k4, launches) for step in loop.STEPS),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))


def turn_shapes() -> list[dict]:
    """The shapes ``--turns`` drives: phases 4 and 5 (the headline forward,
    f32 and bf16 delivery), phase 8's headline reverse and config 3 at S=8,
    phase 11's config 2 in f32, and phases 14a's and 15a's config 5, forward
    in f32 and reverse (the sharded wl engine at mesh 1x1; its stream has
    one slide to spare, profiled). ``--shapes`` also takes
    ``TURN_EXTRA``'s, which no default run drives."""
    h = dict(HEADLINE)
    h["rebuild_every"], h["warmup"] = headline_schedule(h["w"], h["b"])
    c3 = dict(CONFIG3, s=8, prof_steps=h["prof_steps"])
    c2 = dict(CONFIG2, s=C2_S, prof_steps=h["prof_steps"])
    c5 = dict(n=h["n"], w=h["w"], b=h["b"], s=h["s"], steps=5, prof_steps=1)
    return [dict(h, tag="headline_fwd_f32", reverse=False, bf16d=False),
            dict(h, tag="headline_fwd_bf16", reverse=False, bf16d=True),
            dict(h, tag="headline_rev", reverse=True, bf16d=False),
            dict(c2, tag="config2_f32", reverse=False, bf16d=False),
            dict(c3, tag="config3_s8_rev", reverse=True, bf16d=False),
            dict(c5, tag="config5_f32", reverse=False, bf16d=False, sharded=True),
            dict(c5, tag="config5_rev", reverse=True, bf16d=False, sharded=True)]


# shapes ``--turns`` drives only where ``--shapes`` names them: phase 3c,
# K4 and the loop graph's cost a round (``check_k4``); phase 9's config 4
# (its cold push, twice); phase 12's dense driver, both modes, slides of
# 100 and of 1, then the first run again (the first is the first of
# its process); the dense driver at the headline stream's shapes (N=200k,
# W=2M, b=160k, S=128), both modes; phase 14c's sharded dense engine at
# config 5's shapes, both modes, and phase 15c's wlp forward, as the
# sharded shapes of ``turn_shapes`` are run; the hybrid driver forward and
# in reverse at the headline shapes (phases 16a and 16b) and without a
# worklist at 16c's (N=20k, W=200k, b=4k, S=16)
_C5 = dict(n=HEADLINE["n"], w=HEADLINE["w"], b=HEADLINE["b"], s=HEADLINE["s"], steps=5,
           prof_steps=1, bf16d=False, sharded=True)
# the hybrid driver at its defaults (rebuild_every=4) on the headline
# stream, as phase 16a and 16b run it
_HYB = dict(n=HEADLINE["n"], w=HEADLINE["w"], b=HEADLINE["b"], s=HEADLINE["s"], seed=7,
            max_rounds=2000)
TURN_EXTRA = [{"tag": "loop_control"}, {"tag": "config4", "pushes": 2},
              dict(_C5, tag="config5_dense_f32", reverse=False, engine="dense"),
              dict(_C5, tag="config5_dense_rev", reverse=True, engine="dense"),
              dict(_C5, tag="config5_wlp", reverse=False, engine="wlp"),
              {"tag": "dense_driver", "n": 300, "w": 1500, "seed": 5,
               "runs": [[0, 100, 8], [0, 1, 60], [1, 100, 8], [1, 1, 60], [0, 100, 8]]},
              {"tag": "dense_driver_headline", "n": HEADLINE["n"], "w": HEADLINE["w"],
               "s": HEADLINE["s"], "seed": HEADLINE["seed"],
               "runs": [[0, HEADLINE["b"], 4], [1, HEADLINE["b"], 4]]},
              dict(_HYB, tag="hybrid_fwd", reverse=False, worklist=True, warmup=6, steps=8),
              dict(_HYB, tag="hybrid_rev", reverse=True, worklist=True, warmup=2, steps=3),
              dict(n=20_000, w=200_000, b=4000, s=16, seed=3, max_rounds=10_000,
                   tag="hybrid_no_worklist", reverse=False, worklist=False, warmup=2, steps=8),
              dict(n=20_000, w=200_000, b=4000, s=16, seed=3, max_rounds=10_000,
                   tag="hybrid_small_worklist", reverse=False, worklist=True, warmup=2,
                   steps=8),
              {"tag": "delivery_forms"}]


def turn_record(cs, sh: dict, dev) -> dict:
    """One shape of a turn through ``cs``, the chip_smoke module of the
    root the turn runs in (this function's source is run in each, so it
    uses only what each root has: ``run_stream``, ``profile_slides``,
    ``sync``, ``check_k4``, the ``segsum``, ``rowpass`` and ``loop``
    modules). ``loop_control``: the root's phase 3c, under that key.
    ``config4``: ``run_config(4)`` ``pushes`` times, each a cold push
    (the kernels built before): its ``cold_push_s``, rounds, top-100 ms,
    peak memory, the device's time from the push's first launch to its last
    by CUDA events around ``push_to_convergence`` (``push_event_ms``) and
    inside loop graphs by events around each launch (``graph_device_ms``,
    none in a tree whose loop runs on the host), the host's reads, and the
    launches by entry. ``dense_driver``: ``StreamDriver`` on phase 12's
    stream (``dense_driver_headline``: on the headline stream's, S=128),
    each run (mode, slide, slides) seeded (its ms, rounds, capture seconds
    and loop graph ms), then its slides one at a time, each timed on the
    host clock around a sync (``slide_ms`` and ``slide_ms_each``, rounds a
    slide, the graph time a slide as above), each split by CUDA events into
    its parts as the tree's stream module calls them (``corrections``,
    ``view_sort``, ``view_copy``, ``push``: ``device_ms_by_part``) with
    its capture seconds and loop graph ms; the first slide of a run also
    on the host clock, a sync before and after each part
    (``host_ms_by_part``). A
    stream shape:
    ``run_stream`` and ``profile_slides`` on ``FastStreamDriver``, then
    two refines to 5e-8 from one state, the first of which captures the
    new eps's rounds (``refine_ms``, ``refine_rounds``); before them, 2
    more slides with CUDA events around every graph launch (a root's round
    replays, or its loop graphs, and the rebuild's replays): the device's
    time inside graphs a slide (``graph_device_ms``), beside the slides'
    wall (``slide_wall_ms``), and the share of the wall the device spent
    outside graphs (``event_idle_share``), where no profiler is running,
    and K4's launches a slide by kernel (``k4_launches_per_slide``). A
    sharded shape: ``config5_run`` on its ``engine`` (the wl engine unless it
    names ``dense`` or ``wlp``; seed, 3 warm-up and ``steps`` timed slides),
    its launches by entry and round kinds, then 2 slides as above, where
    the host's reads are counted too (``host_reads_per_slide``: the stats
    reductions' and the loop graphs' carry reads; ``sync_ops_per_slide``:
    every blocking transfer, the upload's too, by torch's sync debug mode)
    and the driver's bookkeeping before the engine's slide (grouping,
    packing, the free stacks, a due rebuild, the upload: ``driver_host_ms``)
    is timed apart from the engine's slide (``engine_ms``); then its spare
    slide under the profiler with that slide's peak memory
    (``slide_peak_gib``) and the host's time a round outside the device's
    busy time (``host_ms_per_round``). A hybrid shape (``hybrid_*``):
    ``HybridStreamDriver`` through the root's ``hybrid_timed`` (its rate,
    rounds a slide by kind, host reads a slide), its peak memory and
    launches by entry, then 2 slides with CUDA events around every graph
    launch as above (none in a tree whose hybrid loops run on the host),
    with K1's launches a slide, by call site where the tree counts them,
    then ``arm_split`` (a slide's prologue, loop graph and each arm
    replayed alone, by CUDA events), and one slide under the profiler. A
    sharded shape's K1 launches a slide are counted over its 2 evented
    slides the same way."""
    import warnings

    if sh["tag"] == "loop_control":
        return {"loop_control": cs.check_k4(dev)}
    if sh["tag"] == "delivery_forms":
        cs.build_all()
        return {"delivery_forms": cs.delivery_forms_turn(dev)}
    cuda = dev.type == "cuda"
    if sh["tag"] in ("config4", "dense_driver", "dense_driver_headline"):
        import pprx_torch.bench.run as run_mod
        from pprx_torch.graph.stream import StreamDriver

        if cuda and hasattr(cs, "build_all"):
            cs.build_all()
        marks, pushes = [], []

        def evented(fn, into):
            def call(*args, **kw):
                if not cuda:
                    return fn(*args, **kw)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                into.append((start, end))
                return out
            return call

        def ms(pairs):
            if not cuda:
                return None
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in pairs)

        patched = [(run_mod, "push_to_convergence", pushes)]
        try:
            from pprx_torch.engine.loop import LoopGraph
            patched.append((LoopGraph, "launch", marks))
        except ImportError:  # a tree whose loop runs on the host
            pass
        originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patched]
        for obj, name, into in patched:
            setattr(obj, name, evented(getattr(obj, name), into))
        runs = []
        try:
            if sh["tag"] == "config4":
                for _ in range(sh["pushes"]):
                    del marks[:], pushes[:]
                    cs.reset_launches()
                    if cuda:
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats()
                    rep = cs.run_config(4, device=dev)
                    runs.append({**rep, "push_event_ms": ms(pushes), "graph_device_ms": ms(marks),
                                 "graph_launches": len(marks),
                                 "launches_by_entry": cs.launches_by_entry(),
                                 "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30
                                 if cuda else None})
                return {"config4": runs}
            import numpy as np

            import pprx_torch.graph.stream as stream_mod

            # a slide's parts, by the names each tree's stream module calls
            # them: the corrections (in place or copying), the view's sort
            # and its copy into the held view, the push (a capture, the loop)
            part_of = {"apply_edge_batch_": "corrections", "apply_edge_batch": "corrections",
                       "delivery_view": "view_sort", "copy_into_": "view_copy",
                       "push_to_convergence": "push"}
            spans, walls, split = {}, {}, [False]

            def parted(fn, part):
                def call(*args, **kw):
                    if split[0]:
                        cs.sync(dev)
                        t = time.perf_counter()
                    if cuda:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                    out = fn(*args, **kw)
                    if cuda:
                        end.record()
                        spans.setdefault(part, []).append((start, end))
                    if split[0]:
                        cs.sync(dev)
                        walls[part] = walls.get(part, 0.0) + (time.perf_counter() - t) * 1e3
                    return out
                return call

            for name, part in part_of.items():
                if hasattr(stream_mod, name):
                    originals.append((stream_mod, name, getattr(stream_mod, name)))
                    setattr(stream_mod, name, parted(getattr(stream_mod, name), part))

            def capture_s(drv):
                g = getattr(drv, "round_graphs", None)  # none in a tree whose loop runs on the host
                return g.summary()["capture_s"] if g is not None else 0.0

            src, dst, n = synthetic_powerlaw_stream(sh["n"], 2 * sh["w"], seed=sh["seed"])
            cfg = PprConfig(alpha=0.15, eps=1e-6, max_rounds=10_000)
            queries = list(range(sh["s"])) if "s" in sh else [0, 7, 99]
            for mode, b, k in sh["runs"]:
                drv = StreamDriver(src, dst, n, queries, cfg,
                                   StreamConfig(window=sh["w"], slide=b), mode=mode, device=dev)
                del marks[:]
                t0 = time.perf_counter()
                seed = drv.seed()
                cs.sync(dev)
                seed_rec = {"ms": (time.perf_counter() - t0) * 1e3, "rounds": seed.rounds,
                            "capture_s": capture_s(drv), "graph_device_ms": ms(marks)}
                each, rounds, by_slide = [], 0, []
                wall = 0.0
                for i in range(k):
                    del marks[:]
                    spans.clear()
                    walls.clear()
                    split[0] = i == 0
                    cap0 = capture_s(drv)
                    t0 = time.perf_counter()
                    st = next(drv.run(1))
                    cs.sync(dev)
                    each.append((time.perf_counter() - t0) * 1e3)
                    wall += each[-1]
                    rounds += st.rounds
                    by_slide.append({"rounds": st.rounds, "capture_s": capture_s(drv) - cap0,
                                     "loop_graph_ms": ms(marks), "graph_launches": len(marks),
                                     "device_ms_by_part": {p: ms(v) for p, v in spans.items()},
                                     **({"host_ms_by_part": dict(walls)} if i == 0 else {})})
                split[0] = False
                r_l1 = drv.state.r[:n].double().abs().sum(0)
                runs.append({"mode": mode, "slide": b, "slides": k, "sources": len(queries),
                             "seed": seed_rec, "slide_ms": wall / k, "slide_ms_each": each,
                             "rounds_per_slide": rounds / k,
                             "graph_device_ms": sum(x["loop_graph_ms"] or 0 for x in by_slide)
                             / k if cuda else None,
                             "graph_launches_per_slide": sum(x["graph_launches"] for x in by_slide)
                             / k,
                             "first_slide": by_slide[0],
                             "later_median": {
                                 key: float(np.median([x[key] or 0 for x in by_slide[1:]]))
                                 for key in ("capture_s", "loop_graph_ms")} | {
                                 "device_ms_by_part": {
                                     p: float(np.median([x["device_ms_by_part"][p]
                                                         for x in by_slide[1:]]))
                                     for p in by_slide[0]["device_ms_by_part"]}},
                             "p_plus_r_max": float((drv.state.p[:n].double().sum(0)
                                            + drv.state.r[:n].double().sum(0)).max()),
                             "residual_l1_max": float(r_l1.max())})
            return {"dense_driver": runs}
        finally:
            for obj, name, fn in originals:
                setattr(obj, name, fn)
    mods = (cs.segsum, cs.rowpass)
    k4 = cs.loop.LAUNCHES if hasattr(cs, "loop") else {}  # a tree whose loop runs on the host

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    def evented_k1(drv, sharded, slides=2):
        """``event_slides`` over ``slides`` slides, with K1's launches a
        slide in them, by call site where the tree counts them."""
        by_entry = dict(cs.segsum.LAUNCHES)
        by_site = dict(getattr(cs.segsum, "SITE_LAUNCHES", {}))
        out = event_slides(drv, slides, sharded=sharded)
        out["k1_launches_per_slide"] = sum(
            cs.segsum.LAUNCHES[k] - c for k, c in by_entry.items()
            if k[0] == "segsum_gather_add") / slides
        out["k1_by_site_per_slide"] = {site: (cs.segsum.SITE_LAUNCHES[site] - c) / slides
                                       for site, c in by_site.items()}
        return out

    def event_slides(drv, k, sharded):
        marks, patched = [], [(torch.cuda.CUDAGraph, "replay")]
        try:
            from pprx_torch.engine.loop import LoopGraph
            patched.append((LoopGraph, "launch"))
        except ImportError:  # a tree whose loop runs on the host
            pass
        reads, spans = [0], []

        def timed(fn):
            def call(*args, **kw):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kw)
                end.record()
                marks.append((start, end))
                return out
            return call

        def counted(fn):
            def call(*args, **kw):
                reads[0] += 1
                return fn(*args, **kw)
            return call

        originals = [(cls, name, getattr(cls, name)) for cls, name in patched] if cuda else []
        if sharded:
            import pprx_torch.dist.sharded as sharded_mod
            import pprx_torch.dist.wl as wl_mod
            reads_at = [(m, "gather_stats") for m in (sharded_mod, wl_mod)
                        if hasattr(m, "gather_stats")]
            if cuda:
                reads_at.append((torch.cuda.Event, "synchronize"))
            originals += [(m, name, getattr(m, name)) for m, name in reads_at]
            # the engine's slide: the wl engines' slide_wl, the dense one's slide
            slide_name = "slide_wl" if drv._wl else "slide"
            slide = getattr(drv.eng, slide_name)

            def slide_wl(*args, **kw):
                t1 = time.perf_counter()
                out = slide(*args, **kw)
                spans[-1].append(t1)
                spans[-1].append(time.perf_counter())
                return out

            setattr(drv.eng, slide_name, slide_wl)
        for cls, name, fn in originals:
            wrap = counted if name in ("gather_stats", "synchronize") else timed
            setattr(cls, name, wrap(fn))
        caught = []
        k4_before = dict(k4)
        try:
            cs.sync(dev)
            it = drv.run(k)
            t0 = time.perf_counter()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if cuda and sharded:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    while True:
                        spans.append([time.perf_counter()])
                        if next(it, None) is None:
                            spans.pop()
                            break
                finally:
                    if cuda:
                        torch.cuda.set_sync_debug_mode(0)
            cs.sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for cls, name, fn in originals:
                setattr(cls, name, fn)
            if sharded:
                delattr(drv.eng, slide_name)
        slides = len(spans)
        out = {"slide_wall_ms": wall_ms / slides, "graph_launches": len(marks) / slides,
               "k4_launches_per_slide": {step: (k4[step] - k4_before[step]) / slides
                                         for step in k4}}
        if cuda:
            graph_ms = sum(start.elapsed_time(end) for start, end in marks)
            out.update(graph_device_ms=graph_ms / slides,
                       event_idle_share=1.0 - graph_ms / wall_ms)
        if sharded:
            out.update(host_reads_per_slide=reads[0] / slides,
                       sync_ops_per_slide=sum("synchroniz" in str(w.message)
                                              for w in caught) / slides,
                       driver_host_ms=sum(s[1] - s[0] for s in spans) * 1e3 / slides,
                       engine_ms=sum(s[2] - s[1] for s in spans) * 1e3 / slides)
        return out

    def arm_split(drv, reps=5):
        """A hybrid slide's loop split by arm: two slides with the
        prologue replayed apart (the first captures it), the second's
        prologue, its loop graph and its rebuild (if due) timed by CUDA
        events, the state each arm writes saved where the loop starts and
        where it ends, and each arm's captured graph replayed alone
        ``reps`` times from the saved start (median ms): with the loop's
        executions of each arm, what the arms take of the loop; then the
        heaviest arm's kernels, from one more replay under the profiler
        (``heaviest_arm``)."""
        g = getattr(drv, "round_graphs", None)
        if not cuda or g is None or not hasattr(g, "kept"):
            return None
        import numpy as np

        from pprx_torch.engine.graphs import RoundGraphs

        held = [drv.state.p, drv.state.r, g.cand, g.counts, *g._buffers.values()]
        got = {}
        run_loop, run_step = RoundGraphs.loop, RoundGraphs.run

        def events():
            return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def looped(self, prologue, branches, *args):
            got["pre"] = [t.clone() for t in held]
            got["branches"] = [k for k, _ in branches]
            start, end = events()
            start.record()
            out = run_loop(self, prologue, branches, *args)
            end.record()
            got["loop"] = (start, end)
            got["execs"] = out[0][cs.loop.EXECS:cs.loop.EXECS + len(branches)]
            got["post"] = [t.clone() for t in held]
            return out

        def ran(self, key, fn):
            start, end = events()
            start.record()
            run_step(self, key, fn)
            end.record()
            got["prologue" if "slide" in key else "rebuild"] = (start, end)

        RoundGraphs.loop, RoundGraphs.run = looped, ran
        g.split_prologue = True
        try:
            for _ in range(2):
                got.clear()
                if len(list(drv.run(1))) != 1:
                    raise AssertionError("no slide left in the stream")
        finally:
            RoundGraphs.loop, RoundGraphs.run = run_loop, run_step
            g.split_prologue = False
        torch.cuda.synchronize()
        out = {k: got[k][0].elapsed_time(got[k][1]) for k in ("prologue", "loop", "rebuild")
               if k in got}
        out = {f"{k}_ms": v for k, v in out.items()}
        arms = {}
        for key, execs in zip(got["branches"], got["execs"]):
            graph = g.kept[key][0]
            times = []
            for i in range(reps + 1):  # the first replay instantiates
                for t, v in zip(held, got["pre"]):
                    t.copy_(v)
                start, end = events()
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            arms[" ".join(map(str, key[4:]))] = {"ms": float(np.median(times[1:])),
                                                 "execs": execs}
        # the heaviest arm's kernels: one more replay from the saved start
        # under the profiler (a plain graph's kernels are traced one by one)
        name, key = max(zip(arms, got["branches"]),
                        key=lambda a: arms[a[0]]["ms"] * arms[a[0]]["execs"])
        for t, v in zip(held, got["pre"]):
            t.copy_(v)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            g.kept[key][0].replay()
            torch.cuda.synchronize()
        on_dev = sorted((e for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.self_device_time_total, reverse=True)
        out["heaviest_arm"] = {"arm": name, "kernels": [
            {"name": e.key[:80], "ms": e.self_device_time_total / 1e3, "calls": e.count}
            for e in on_dev[:12]]}
        for t, v in zip(held, got["post"]):
            t.copy_(v)
        torch.cuda.synchronize()
        out["arms"] = arms
        out["arms_ms_by_execs"] = sum(a["ms"] * a["execs"] for a in arms.values())
        return out

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if sh["tag"].startswith("hybrid"):
        from pprx_torch.graph.hybrid_stream import HybridStreamDriver

        if cuda and hasattr(cs, "build_all"):
            cs.build_all()
        for m in mods:
            m.reset_launches()
        n, w, b = sh["n"], sh["w"], sh["b"]
        src, dst, n = synthetic_powerlaw_stream(
            n, w + (sh["warmup"] + sh["steps"] + 6) * b, seed=sh["seed"])
        drv = HybridStreamDriver(src, dst, n, list(range(sh["s"])),
                                 PprConfig(alpha=0.15, eps=1e-6, max_rounds=sh["max_rounds"]),
                                 StreamConfig(window=w, slide=b),
                                 mode=REVERSE if sh["reverse"] else FORWARD,
                                 worklist=sh["worklist"], device=dev)
        res = cs.hybrid_timed(drv, sh["warmup"], sh["steps"])
        res["peak_mem_gib"] = peak()
        res["launches_by_entry"] = {e: m.launches(e) for m in mods for e in m.ENTRIES}
        res.update(evented_k1(drv, sharded=False))
        res["arm_split"] = arm_split(drv)
        res["profile"] = cs.profile_slides(drv, 1)
        g = getattr(drv, "round_graphs", None)  # a tree whose hybrid loops run on the host
        if g is not None:
            res["graphs"] = g.summary()
        return res
    if sh.get("sharded"):
        for m in mods:
            m.reset_launches()
        rep, drv = config5_run(n=sh["n"], w=sh["w"], b=sh["b"], s=sh["s"], steps=sh["steps"],
                               bf16d=sh["bf16d"], mode="reverse" if sh["reverse"] else "forward",
                               engine=sh.get("engine", "wl"), device=dev, extra_slides=2)
        res = {"updates_per_s": rep["updates_per_sec"], "wall_s": rep["wall_s"],
               "rounds_per_slide": rep["rounds"] / rep["steps"],
               "wl_rounds_per_slide": rep["wl_rounds"] / rep["steps"], "peak_mem_gib": peak(),
               "launches_by_entry": {e: m.launches(e) for m in mods for e in m.ENTRIES},
               "round_kinds": dict(getattr(drv.eng, "round_kinds", {}))}
        g = getattr(drv.eng, "round_graphs", None)  # a tree with the device loop
        if g is not None:
            res["graphs"] = g.summary()
        res.update(evented_k1(drv, sharded=True))
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res["profile"] = prof = cs.profile_slides(drv, sh["prof_steps"])
        res["slide_peak_gib"] = peak()
        if prof["device_busy_ms"] is not None:
            res["host_ms_per_round"] = (prof["wall_ms"] - prof["device_busy_ms"]) / sum(
                prof["rounds"])
        return res
    n, w, b = sh["n"], sh["w"], sh["b"]
    src, dst, n = synthetic_powerlaw_stream(
        n, w + (sh["warmup"] + sh["steps"] + sh["prof_steps"] + 3) * b, seed=sh["seed"])
    drv = FastStreamDriver(src, dst, n, list(range(sh["s"])),
                           PprConfig(alpha=0.15, eps=1e-6, max_rounds=2000),
                           StreamConfig(window=w, slide=b),
                           mode=REVERSE if sh["reverse"] else FORWARD, dtype=torch.float32,
                           rebuild_every=sh["rebuild_every"], bf16d=sh["bf16d"], device=dev)
    res = cs.run_stream(drv, sh["warmup"], sh["steps"])
    res["peak_mem_gib"] = peak()
    res["profile"] = cs.profile_slides(drv, sh["prof_steps"])
    res.update(event_slides(drv, 2, sharded=False))
    saved = (drv.state.p.clone(), drv.state.r.clone())
    res["refine_ms"], res["refine_rounds"] = [], []
    for _ in range(2):
        drv.state.p.copy_(saved[0])
        drv.state.r.copy_(saved[1])
        cs.sync(dev)
        t0 = time.perf_counter()
        st = drv.refine(5e-8)
        cs.sync(dev)
        res["refine_ms"].append((time.perf_counter() - t0) * 1e3)
        res["refine_rounds"].append(st.rounds)
    return res


# one turn: run in a tree's root, so that its chip_smoke and pprx_torch load
TURN = """
import json, sys, time, torch
import chip_smoke as cs
from pprx_torch.bench.run import config5_run
from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.engine.state import FORWARD, REVERSE
from pprx_torch.graph.fast_stream import FastStreamDriver
from pprx_torch.graph.io import synthetic_powerlaw_stream

{turn_record}
smi = cs.nvidia_smi()
for sh in json.loads(sys.argv[1]):
    res = turn_record(cs, sh, torch.device("cuda", 0))
    print(json.dumps({{"shape": sh["tag"], "nvidia_smi": smi, **res}}), flush=True)
"""

TURN_SUMMARY = ("updates_per_s", "rounds_per_slide", "syncs_per_slide",
                "graph_launches_per_slide", "graph_device_ms", "slide_wall_ms",
                "event_idle_share", "wall_per_round_ms",
                "peak_mem_gib", "slide_peak_gib", "kernel_launches_per_slide",
                "row_pass_launches_per_slide", "replays_per_round", "eager_rounds",
                "refine_ms", "refine_rounds", "round_kinds", "launches_by_entry",
                "host_reads_per_slide", "sync_ops_per_slide", "driver_host_ms", "engine_ms",
                "host_ms_per_round", "graph_launches", "graphs", "k4_launches_per_slide",
                "config4", "dense_driver", "wl_rounds_per_slide", "sparse_scans_per_slide",
                "dense_scans_per_slide", "counts_per_slide", "sparse_scans_by_tier_per_slide",
                "rebuilds", "k1_launches_per_slide", "k1_by_site_per_slide", "arm_split",
                "delivery_forms")
# phase 3c's numbers in a ``loop_control`` record
K4_SUMMARY = ("loop_round_ms", "graph_kernel_floor_ms", "conditional_overhead_ms_per_round",
              "body_kernel_ms")


def turns(argv: list[str]) -> int:
    """``--turns [--out FILE] [--shapes TAG,...] ROOT ...``: each root's
    shapes (``turn_shapes``, or those named) in turn."""
    out, names = os.devnull, None
    while argv[:1] in (["--out"], ["--shapes"]):
        opt, val, argv = argv[0], argv[1], argv[2:]
        if opt == "--out":
            out = val
            os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        else:
            names = val.split(",")
    shapes = turn_shapes() if names is None else [
        sh for sh in turn_shapes() + TURN_EXTRA if sh["tag"] in names]
    if names is not None and len(shapes) != len(names):
        raise SystemExit(f"--shapes: unknown among {names}")
    script = TURN.format(turn_record=inspect.getsource(turn_record))
    with open(out, "w") as rec_file:
        for i, root in enumerate(argv):
            root = os.path.abspath(root)
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-c", script, json.dumps(shapes)], cwd=root,
                                  env=dict(os.environ, PYTHONPATH=root),
                                  capture_output=True, text=True)
            for line in proc.stdout.splitlines():
                if not line.startswith("{"):
                    continue
                rec = {"turn": i, "root": root, **json.loads(line)}
                rec_file.write(json.dumps(rec) + "\n")
                prof, k4 = rec.get("profile", {}), rec.get("loop_control", {})
                print(json.dumps({"turn": i, "root": root, "shape": rec["shape"],
                                  **{k: rec[k] for k in TURN_SUMMARY if k in rec},
                                  **{k: k4[k] for k in K4_SUMMARY if k in k4},
                                  **{f"{k}_ms": v["ms"] for k, v in k4.items()
                                     if isinstance(v, dict) and "max_abs_err" in v},
                                  "idle": prof.get("device_idle_share"),
                                  "busy_ms": prof.get("device_busy_ms"),
                                  "api": prof.get("launches_per_slide")}), flush=True)
            print(json.dumps({"turn": i, "root": root, "rc": proc.returncode,
                              "seconds": time.perf_counter() - t0}), flush=True)
            if proc.returncode:
                print(proc.stderr[-4000:], file=sys.stderr)
                return proc.returncode
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turns"]:
        sys.exit(turns(sys.argv[2:]))
    main()
