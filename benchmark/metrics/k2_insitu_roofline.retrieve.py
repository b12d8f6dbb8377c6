"""K2 (``rowpass.scan_pass_``) inside the dense rounds, as a share of its
byte bound, in %: ``r``, ``p`` and ``deg`` read, ``r``, ``p`` and
``moving`` written, 5 (N+1) S 4 + (N+1) 4 bytes (``chip_smoke.py`` phase
3b's count), over the median ``k2`` stamp interval of the window's dense
rounds (``benchmark/flight.py``), by ``kernels.k1_share``'s arithmetic."""

from benchmark import flight, kernels


def probe(cell, info: dict) -> dict:
    rows = info["n"] + 1
    return {**flight.probe(cell), "k2_insitu_bytes": 5 * rows * info["s"] * 4 + rows * 4}


def read(record: dict):
    n_bytes, ms = record.get("k2_insitu_bytes"), flight.median_ms(record, "k2")
    return kernels.k1_share({"bytes": n_bytes, "ms": ms}) if n_bytes and ms else None
