"""Device ms of a request's top-k, from the ``topk`` stamp to ``topk.end``
(``benchmark/flight.py``), averaged over the window's requests."""

from benchmark import flight


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    got = flight.sums(record)
    if got is None or "topk" not in got["apart_ms"]:
        return None
    return flight.per(record, "requests", got["apart_ms"]["topk"])
