"""Host driver of the sharded sliding-window stream (port of
``pprx.dist.stream``).

The slot bookkeeping is the reference's, on the host: each shard has
``ecap`` buffer slots and a free-slot stack; expiring edges free their slot,
new edges claim one. All per-slide host work is vectorised NumPy (grouping
by owner shard and flat-index packing into the padded ``[K, b]`` batch
rows); the only Python loops are over the K shards' stacks.

How the port differs: every process runs the same host bookkeeping over
the whole stream (it is deterministic, so the ranks agree), then uploads
only its own shard's row of the batch, as one int32 transfer a slide. The
wl engines' forward slide ships the shard's fresh edges, their reverse
slide its six batch rows, each followed by the slide's scalars
(``ShardedWlEngine.slide_tail``), into one tensor that every slide reuses
(a captured prologue reads it where it lies); the host keeps its own
counts. The dense engine's slide in a world of one shard uploads its
batch rows into one such tensor too, and hands the engine views of it.
The wl engines rebuild their snapshot in place
(``ShardedWlEngine.rebuild_``). ``host_p``, ``host_r`` and ``host_deg``
assemble the global arrays over the world.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from pprx_torch.config import PprConfig, StreamConfig
from pprx_torch.dist.mesh import RowMesh, all_gather_rows
from pprx_torch.dist.sharded import ShardedEngine
from pprx_torch.dist.wl import ShardedWlEngine
from pprx_torch.engine.state import FORWARD


def _group(owner: np.ndarray, n_shards: int, row_len: int):
    """Group b items by owner shard without sorting: each item gets its
    rank within its shard by one boolean compaction per shard. Returns
    (flat, counts): ``flat`` indexes the shard-major padded ``[K*row_len]``
    layout (shard k's items at [k*row_len, k*row_len + counts[k]), in stream
    order); arrays packed with the same ``flat`` align entry by entry."""
    rank = np.empty(owner.size, np.int64)
    counts = np.empty(n_shards, np.int64)
    for k in range(n_shards):
        idx = np.flatnonzero(owner == k)
        counts[k] = idx.size
        rank[idx] = np.arange(idx.size, dtype=np.int64)
    return owner.astype(np.int64) * row_len + rank, counts


def _pack(flat: np.ndarray, vals, n_rows: int, fillval: int = 0) -> np.ndarray:
    """Scatter values into the padded shard-major batch layout."""
    out = np.empty(n_rows, np.int32)
    out.fill(fillval)
    out[flat] = vals
    return out


class ShardedStreamDriver:
    """The sliding-window stream on the sharded engines: this process's
    shard of it (``mesh``). ``device=None`` is the card."""

    def __init__(
        self,
        stream_src: np.ndarray,
        stream_dst: np.ndarray,
        n: int,
        queries,
        cfg: PprConfig,
        scfg: StreamConfig,
        mesh: RowMesh,
        mode: int = FORWARD,
        ecap: int | None = None,
        dtype: torch.dtype = torch.float32,
        engine: str = "dense",
        ccap: int | None = None,
        fring: int | None = None,
        e_top: int | None = None,
        bf16d: bool = False,
        device: torch.device | str | None = None,
    ):
        """engine: 'dense' (reduce-scatter rounds, ``pprx_torch.dist.sharded``),
        'wl' (compact-frontier rounds with a bucketed all-to-all,
        ``pprx_torch.dist.wl``) or 'wlp' (wl with the memory-proportional
        carry and drain rounds: no ``[n_pad, S]`` array on the push path)."""
        if stream_src.shape[0] < scfg.window:
            raise ValueError("stream shorter than one window")
        if engine not in ("dense", "wl", "wlp"):
            raise ValueError(f"unknown sharded engine {engine!r}")
        self.stream_src = np.asarray(stream_src, dtype=np.int32)
        self.stream_dst = np.asarray(stream_dst, dtype=np.int32)
        self.n = n
        self.cfg = cfg
        self.scfg = scfg
        self.mode = mode
        self.mesh = mesh
        self._wl = engine in ("wl", "wlp")
        w = scfg.window
        queries = list(queries)
        common = dict(ecap=w if ecap is None else ecap, bcap=scfg.slide, cfg=cfg, mode=mode,
                      dtype=dtype, device=device)
        if self._wl:
            self.eng = ShardedWlEngine(mesh, n, len(queries), ccap=ccap, fring=fring,
                                       e_top=e_top, proportional=engine == "wlp", bf16d=bf16d,
                                       **common)
        else:
            self.eng = ShardedEngine(mesh, n, len(queries),
                                     ccap=2048 if ccap is None else ccap, **common)
        eng = self.eng
        self.device = eng.device
        self.p, self.r = eng.init_state(queries)
        self.deg, self.egl, self.eog, self.eva, counts = eng.device_graph(
            self.stream_src[:w], self.stream_dst[:w])
        if self._wl:
            self.snap = eng.rebuild(self.egl, self.eog, self.eva)
            self._fcnt_host = np.zeros(eng.n_rows, np.int64)
            self._since_rb = 0
        # host slot bookkeeping: stream position -> (owner shard, local slot)
        self._gather_key = (self.stream_src if mode == FORWARD else self.stream_dst) // eng.n_local
        self.pos_owner = np.full(self.stream_src.shape[0], -1, np.int32)
        self.pos_slot = np.full(self.stream_src.shape[0], -1, np.int32)
        gk0 = self._gather_key[:w]
        # the seed: a position's slot is its rank within its owner group
        fill = np.bincount(gk0, minlength=eng.n_rows).astype(np.int64)
        order = np.argsort(gk0, kind="stable")
        starts = np.zeros(eng.n_rows + 1, np.int64)
        np.cumsum(fill, out=starts[1:])
        self.pos_slot[order] = np.arange(w, dtype=np.int64) - np.repeat(starts[:-1], fill)
        self.pos_owner[:w] = gk0
        assert (fill == counts).all()
        # per-shard LIFO free-slot stacks: freed slots before untouched ones
        self._free_stack = [np.empty(eng.ecap, np.int32) for _ in range(eng.n_rows)]
        self._free_top = np.zeros(eng.n_rows, np.int64)
        for k in range(eng.n_rows):
            c = eng.ecap - int(fill[k])
            self._free_stack[k][:c] = np.arange(fill[k], eng.ecap, dtype=np.int32)
            self._free_top[k] = c
        self.head = w
        self.step_idx = 0
        self.ring = self._device_ring() if self._wl and mode == FORWARD else None
        self._pack = None  # the wl slides' upload, allocated at the first slide

    # -- helpers -------------------------------------------------------
    def _device_ring(self) -> dict:
        """The forward wl slide's slot ring (FIFO of occupied slots + free
        stack per shard) from the host bookkeeping: the host's schedule and
        the device's replay of it are the same push-freed/pop-top rule."""
        eng = self.eng
        k_rows, ecap = eng.n_rows, eng.ecap
        live = np.arange(self.head - self.scfg.window, self.head)
        own, slots = self.pos_owner[live], self.pos_slot[live]
        oring = np.full((k_rows, ecap + 2), ecap, np.int32)
        tl = np.zeros(k_rows, np.int32)
        fstack = np.full((k_rows, ecap + 1), ecap, np.int32)
        ftop = np.zeros(k_rows, np.int32)
        for k in range(k_rows):
            sl = slots[own == k]  # stream (= insertion) order
            oring[k, : sl.size] = sl
            tl[k] = sl.size
            t = int(self._free_top[k])
            fstack[k, :t] = self._free_stack[k][:t]
            ftop[k] = t
        return eng.make_ring(oring, np.zeros(k_rows, np.int32), tl, fstack, ftop)

    def _upload(self, rows: list[np.ndarray], tail: np.ndarray | None = None) -> torch.Tensor:
        """``[len(rows), b]``: this shard's row of each packed ``[K*b]``
        batch, as one transfer. With a ``tail`` (the wl slides' scalars,
        none for the dense engine's): the rows flat, then the tail, copied
        into the driver's one pack."""
        b, k = self.scfg.slide, self.mesh.row
        mine = np.stack([a[k * b:(k + 1) * b] for a in rows])
        if tail is None:
            return torch.from_numpy(mine).to(self.device)
        host = torch.from_numpy(np.concatenate([mine.reshape(-1), tail]))
        if self._pack is None:
            self._pack = torch.empty(host.shape, dtype=torch.int32, device=self.device)
        self._pack.copy_(host)
        return self._pack

    def seed(self) -> dict:
        if self._wl:
            self.p, self.r, rounds, pushes, epushes, wl = self.eng.push_wl(
                self.p, self.r, self.deg, self.snap)
            return {"rounds": rounds, "pushes": float(pushes), "edge_pushes": float(epushes),
                    "wl_rounds": wl}
        self.p, self.r, rounds, pushes, epushes = self.eng.push(
            self.p, self.r, self.deg, self.egl, self.eog, self.eva)
        return {"rounds": rounds, "pushes": float(pushes), "edge_pushes": float(epushes)}

    @property
    def steps_available(self) -> int:
        return (self.stream_src.shape[0] - self.head) // self.scfg.slide

    # -- the slide loop ------------------------------------------------
    def run(self, n_steps: int | None = None) -> Iterator[dict]:
        eng = self.eng
        b = self.scfg.slide
        n_local = eng.n_local
        total = self.steps_available if n_steps is None else n_steps
        for _ in range(total):
            if self.head + b > self.stream_src.shape[0]:
                return
            expire = np.arange(self.head - self.scfg.window, self.head - self.scfg.window + b)
            fresh = np.arange(self.head, self.head + b)
            k_rows = eng.n_rows
            trash = eng.trash_slot
            src, dstv = self.stream_src, self.stream_dst
            ones = np.ones(b, np.int32)
            # by-src-owner correction batches; in forward mode the gather
            # key is src, so the slot groupings coincide
            oo = src[expire] // n_local
            on = src[fresh] // n_local
            flat_o, cnt_o = _group(oo, k_rows, b)
            flat_n, cnt_n = _group(on, k_rows, b)
            go = self.pos_owner[expire]
            gn = self._gather_key[fresh]
            if self.mode == FORWARD:
                flat_c, cnt_c = flat_o, cnt_o
                flat_w, cnt_w = flat_n, cnt_n
            else:
                flat_c, cnt_c = _group(go, k_rows, b)
                flat_w, cnt_w = _group(gn, k_rows, b)
            clear_slots = _pack(flat_c, self.pos_slot[expire], k_rows * b, fillval=trash)
            alloc_rows = np.full(k_rows * b, trash, np.int32)
            for k in range(k_rows):  # O(K) slot-stack pushes/pops
                c_fr, c_al = int(cnt_c[k]), int(cnt_w[k])
                t = int(self._free_top[k])
                if c_fr:
                    self._free_stack[k][t : t + c_fr] = clear_slots[k * b : k * b + c_fr]
                    t += c_fr
                if c_al:
                    if t < c_al:
                        raise RuntimeError(
                            f"shard {k} edge buffer full (ecap={eng.ecap}); "
                            "raise ecap to absorb this degree skew")
                    alloc_rows[k * b : k * b + c_al] = self._free_stack[k][t - c_al : t][::-1]
                    t -= c_al
                self._free_top[k] = t
            self.pos_owner[fresh] = gn
            self.pos_slot[fresh] = alloc_rows[flat_w]
            write_slots = alloc_rows
            ins_u = _pack(flat_n, (src[fresh] - on * n_local).astype(np.int32), k_rows * b)
            if self._wl:
                # rebuild before the slide if the fresh ring would overflow
                # or the oldest fresh edge would outlive the window
                if ((self._fcnt_host + cnt_w > eng.fring).any()
                        or (self._since_rb + 1) * b > self.scfg.window):
                    eng.rebuild_(self.snap, self.egl, self.eog, self.eva)
                    self._fcnt_host[:] = 0
                    self._since_rb = 0
            if self._wl and self.mode == FORWARD:
                batch = [ins_u, _pack(flat_n, dstv[fresh].astype(np.int32), k_rows * b)]
                counts = (cnt_w, cnt_c)
            elif self._wl:
                batch = [
                    _pack(flat_o, (src[expire] - oo * n_local).astype(np.int32), k_rows * b),
                    ins_u, clear_slots, write_slots,
                    _pack(flat_w, (dstv[fresh] - gn * n_local).astype(np.int32), k_rows * b),
                    _pack(flat_w, src[fresh].astype(np.int32), k_rows * b),
                ]
                counts = (cnt_o, cnt_n, cnt_w)
            elif self.mode == FORWARD:
                batch = [
                    _pack(flat_o, (src[expire] - oo * n_local).astype(np.int32), k_rows * b),
                    _pack(flat_o, dstv[expire].astype(np.int32), k_rows * b),
                    _pack(flat_o, ones, k_rows * b),
                    ins_u,
                    _pack(flat_n, dstv[fresh].astype(np.int32), k_rows * b),
                    _pack(flat_n, ones, k_rows * b),
                    clear_slots, write_slots,
                ]
            else:
                batch = [
                    _pack(flat_o, (src[expire] - oo * n_local).astype(np.int32), k_rows * b),
                    _pack(flat_o, ones, k_rows * b),
                    ins_u,
                    _pack(flat_n, ones, k_rows * b),
                    clear_slots, write_slots,
                    _pack(flat_w, (dstv[fresh] - gn * n_local).astype(np.int32), k_rows * b),
                    _pack(flat_w, src[fresh].astype(np.int32), k_rows * b),
                    _pack(flat_w, ones, k_rows * b),
                ]
            extra = {}
            if self._wl:
                mine = [c[self.mesh.row] for c in counts]
                pack = self._upload(batch, eng.slide_tail(mine, self.ring, self.snap))
                (self.p, self.r, rounds, pushes, epushes, wl, self.deg, self.egl, self.eog,
                 self.eva, self.snap, self.ring) = eng.slide_wl(
                    self.p, self.r, self.deg, self.egl, self.eog, self.eva, self.snap,
                    pack, self.ring, mine)
                extra = {"wl_rounds": wl}
                self._fcnt_host += cnt_w
                self._since_rb += 1
            else:
                if eng.on_graphs:  # the loop graph reads the rows where they lie
                    rows = self._upload(batch, np.zeros(0, np.int32)).view(len(batch), b)
                else:
                    rows = self._upload(batch)
                (self.p, self.r, rounds, pushes, epushes, self.deg, self.egl, self.eog,
                 self.eva) = eng.slide(self.p, self.r, self.deg, self.egl, self.eog, self.eva,
                                       *rows.unbind(0))
            self.head += b
            self.step_idx += 1
            yield {"rounds": rounds, "pushes": float(pushes), "edge_pushes": float(epushes),
                   **extra}

    # -- host views ----------------------------------------------------
    def host_p(self) -> np.ndarray:
        return assemble(self.p, self.mesh)

    def host_r(self) -> np.ndarray:
        return assemble(self.r, self.mesh)

    def host_deg(self) -> np.ndarray:
        """The global degrees ``[n_pad]`` (every ``srcs`` shard holds them)."""
        return assemble(self.deg[:, None], self.mesh)[:, 0]


def assemble(block: torch.Tensor, mesh: RowMesh) -> np.ndarray:
    """The global ``[n_rows * n_local, n_srcs * s_loc]`` host array from
    every shard's ``[n_local, s_loc]`` block, gathered over the world: every
    rank takes part, and each gets the whole."""
    parts = all_gather_rows(block.contiguous(), mesh.world).cpu().numpy()
    n_local, s_loc = block.shape
    return (parts.reshape(mesh.n_rows, mesh.n_srcs, n_local, s_loc).transpose(0, 2, 1, 3)
            .reshape(mesh.n_rows * n_local, mesh.n_srcs * s_loc))
