"""The reverse row-sum sweep as a share of its byte bound, in %: the bytes
``benchmark/kernels_reverse.py`` counts on the reverse view of the run's
final window (``sweep_bytes``) over the median interval from the
``rev.rowsum`` stamp to ``rev.corrections`` (``benchmark/flight.py``)."""

from benchmark import kernels_reverse


def probe(cell, info: dict) -> dict:
    return kernels_reverse.probe(cell, info)


def read(record: dict):
    return kernels_reverse.share(record, "sweep", "rev.rowsum")
