"""Device ms of a reverse slide's row-sum sweep, from each ``rev.rowsum``
stamp to ``rev.corrections`` (the zero fill and K1's two launches over the
window's and the fresh ring's views; ``benchmark/flight.py``), summed over
the window and divided by its slides."""

from benchmark import flight, kernels_reverse


def probe(cell, info: dict) -> dict:
    return kernels_reverse.probe(cell, info)


def read(record: dict):
    got = flight.sums(record)
    if got is None or "rev.rowsum" not in got["stamp_ms"]:
        return None
    return flight.per(record, "slides", got["stamp_ms"]["rev.rowsum"]["sum"])
