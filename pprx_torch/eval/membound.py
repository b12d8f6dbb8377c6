"""Per-shard memory accounting (port of ``pprx.eval.membound``).

The reference walks a function's jaxpr for the largest floating-point
intermediate inside any ``shard_map`` body: shapes there are per shard, so
the walk bounds a device's live arrays without running anything. Eager torch
has no program to walk. Here ``max_float_temp_size`` runs the function in
this process, which is one shard, under a dispatch mode that sees every op's
outputs, and reports the largest floating-point tensor any op returned. It
runs on the CPU, where the port's tests hold the wl and wlp engines to the
reference's bounds; on the card ``torch.cuda.max_memory_allocated`` around
a call says the same in bytes.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _LargestFloat(TorchDispatchMode):
    """Records the ``numel()`` of the largest floating-point op output."""

    def __init__(self):
        super().__init__()
        self.biggest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point():
                self.biggest = max(self.biggest, t.numel())
        return out


def max_float_temp_size(fn, *args) -> int:
    """Largest floating-point tensor (in elements) that any op returns while
    ``fn(*args)`` runs in this process: this shard's largest float array,
    its inputs not counted unless an op returns them (an in-place update
    does)."""
    mode = _LargestFloat()
    with mode:
        fn(*args)
    if mode.biggest == 0:
        raise AssertionError("no floating-point op ran")
    return mode.biggest
