"""Process-group start-up (port of ``pprx.dist.init``).

One call per process, before the mesh is built:

    from pprx_torch.dist.init import init_distributed
    init_distributed("host0:29500", num_processes=4, process_id=i)

Under ``torchrun`` the arguments come from its environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), so
``init_distributed()`` is the whole call. The backend follows the device:
NCCL for the card (each process on ``cuda:LOCAL_RANK``), gloo for the CPU.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from pprx_torch.device import resolve_device


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Start the process group of a multi-process run.

    ``coordinator`` is ``host:port`` (a TCP store at process 0), or a
    ``tcp://`` or ``file://`` URL; the arguments fall back to torchrun's
    variables. ``device`` picks the backend: ``None`` is the card (NCCL,
    raises without one), ``"cpu"`` is gloo. Returns True when this call
    started the group, False for a single-process run (no coordinator and
    at most one process anywhere) or when a group already exists, so a
    second call is a no-op. A failed start raises: there is no quiet
    switch to another backend or to a single process."""
    if coordinator is None and "MASTER_ADDR" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if dist.is_initialized():
        return False
    if coordinator is None and (num_processes or 1) <= 1:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "init_distributed: a multi-process run needs a coordinator, the number of "
            f"processes and this process's id (got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r})")
    dev = resolve_device(device)
    if dev.type == "cuda":
        backend = "nccl"
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"init_distributed: no backend for device {dev}")
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, **kw)
    return True
