"""The device's idle share of the window, in %: the wall less the device
time inside every graph launch and every eager span the harness marks
(CUDA events), over the wall."""

from benchmark.reference.perf import idle_share


def read(record: dict):
    marks = record.get("marks")
    if not marks:
        return None
    return idle_share(sum(m["ms"] for m in marks), record["window_s"] * 1e3)
