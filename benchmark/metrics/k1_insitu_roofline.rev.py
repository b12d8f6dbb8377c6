"""K1 (``segsum_gather_add_``, its scaled entry) inside the reverse scan
rounds, as a share of its byte bound, in %: the bytes
``benchmark/kernels_reverse.py`` counts on the reverse view of the run's
final window with the row scale (``round_bytes``) over the median
``k1.window`` stamp interval of the window's scan rounds
(``benchmark/flight.py``)."""

from benchmark import kernels_reverse


def probe(cell, info: dict) -> dict:
    return kernels_reverse.probe(cell, info)


def read(record: dict):
    return kernels_reverse.share(record, "round", "k1.window")
