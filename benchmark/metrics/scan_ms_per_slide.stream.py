"""Device ms in the scan rounds and their stats, from each ``round.scan``
and ``round.stats`` stamp to the next round's or the loop's end
(``benchmark/flight.py``), a slide."""

from benchmark import flight


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    got = flight.sums(record)
    if got is None:
        return None
    ms = got["rounds_ms"]
    return flight.per(record, "slides", ms.get("round.scan", 0.0) + ms.get("round.stats", 0.0))
