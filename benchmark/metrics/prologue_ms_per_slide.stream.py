"""Device ms of a slide's prologue, from the loop graph's head stamp to the
end of ``prologue.first_count`` (the program's stamps,
``benchmark/flight.py``), a slide."""

from benchmark import flight


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    got = flight.sums(record)
    return None if got is None else flight.per(record, "slides", got["prologue_ms"]["ms"])
