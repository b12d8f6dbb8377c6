"""The median slide of the window, in ms (host clock, each slide ending in a
device sync)."""

import numpy as np


def read(record: dict):
    slides = record.get("slides")
    return float(np.median([s["ms"] for s in slides])) if slides else None
