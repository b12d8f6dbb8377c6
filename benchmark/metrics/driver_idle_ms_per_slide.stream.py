"""Device idle ms between the window's loops, on the program's one clock,
that falls inside the driver's host spans of a slide other than
``loop.wait`` (the rebuild's issue, the pack, the upload, the issue, the
mirror: ``benchmark/flight.py``), a slide."""

from benchmark import flight


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    got = flight.sums(record)
    return None if got is None else flight.per(record, "slides", got["driver_idle_ms"])
