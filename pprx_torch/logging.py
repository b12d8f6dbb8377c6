"""JSONL per-event records of the command line (own copy of
``pprx.logging``: the same records, so a log means the same in both
packages)."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Optional


class JsonlLogger:
    """Appends one JSON object per event; stdout by default."""

    def __init__(self, path: Optional[str] = None):
        self._fh: IO = open(path, "a") if path else sys.stdout
        self._owns = path is not None
        self.t0 = time.perf_counter()

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "t": round(time.perf_counter() - self.t0, 6), **fields}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._owns:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
