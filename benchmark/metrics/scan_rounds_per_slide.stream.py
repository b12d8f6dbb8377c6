"""Scan rounds a slide: the executions of the loops' scan branch
(``round.scan``), which the program counts from each loop's carry
(``benchmark/flight.py``)."""

from benchmark import flight


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    got = flight.sums(record)
    return None if got is None else flight.per(record, "slides",
                                               got["round_execs"].get("round.scan", 0))
