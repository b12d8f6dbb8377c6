"""K1 (``segsum_gather_add_``) alone on a delivery-sorted view that the
benchmark builds from its own window, timed by CUDA events, and its share of
the bound that its bytes set on the card.

The byte count is ``chip_smoke.py`` phase 3's (``check_kernel_config4``):
every table row the edges name, read once; the edge list; ``rin`` read and
written; the row offsets. Over the HBM rate of one H100 SXM (NVIDIA's data
sheet, at its 700 W limit). It counts the function's work whatever
implements it.
"""

from __future__ import annotations

import subprocess
import sys

import torch

HBM_BYTES_PER_S = 3.35e12
REPS = 20


def power_limit() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=False)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def forward_view(src, dst, n: int, device):
    """The window's edges sorted by ``dst`` (stable), on ``device``: each
    edge's ``src`` (``gat``) and the offsets of rows ``0..n``, int32."""
    src = torch.as_tensor(src, device=device)
    dst_s, order = torch.sort(torch.as_tensor(dst, device=device), stable=True)
    gat = src[order].to(torch.int32)
    off = torch.searchsorted(dst_s, torch.arange(n + 1, dtype=dst_s.dtype, device=device),
                             out_int32=True)
    return gat, off


def k1_bytes(gat: torch.Tensor, n: int, s: int) -> int:
    rows = int(torch.unique(gat).numel())
    return rows * s * 4 + gat.numel() * 4 + 2 * n * s * 4 + (n + 1) * 4


def k1_probe(cell, info: dict) -> dict:
    """ms of one K1 call at the final window's forward view, width S, f32."""
    from pprx_torch.engine.segsum import segsum_gather_add_

    print(f"nvidia-smi: {power_limit()}", file=sys.stderr, flush=True)
    n, s, dev = info["n"], info["s"], cell.device
    gat_t, off_t = forward_view(info["src"], info["dst"], n, dev)
    gen = torch.Generator(device=dev).manual_seed(cell.seed % (1 << 63))
    table = torch.rand((n + 1, s), generator=gen, device=dev)
    rin = torch.rand((n, s), generator=gen, device=dev)
    for _ in range(3):
        segsum_gather_add_(rin, table, gat_t, off_t)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10_000_000)  # the queue runs ahead of the host's issuing
    start.record()
    for _ in range(REPS):
        segsum_gather_add_(rin, table, gat_t, off_t)
    end.record()
    torch.cuda.synchronize(dev)
    return {"ms": start.elapsed_time(end) / REPS, "bytes": k1_bytes(gat_t, n, s), "s": s}


def k1_share(k1: dict | None) -> float | None:
    """The share of the byte bound, in %."""
    if not k1:
        return None
    return 100.0 * (k1["bytes"] / HBM_BYTES_PER_S * 1e3) / k1["ms"]
