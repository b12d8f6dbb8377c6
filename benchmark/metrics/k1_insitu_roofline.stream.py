"""K1 (``segsum_gather_add_``) inside the scan rounds, as a share of its
byte bound, in %: the bytes that ``k1_roofline.stream``'s probe counted on
the run's final window (``benchmark/kernels.py``) over the median
``k1.window`` stamp interval of the window's scan rounds
(``benchmark/flight.py``)."""

from benchmark import flight, kernels


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    k1, ms = record.get("k1"), flight.median_ms(record, "k1.window")
    return kernels.k1_share({"bytes": k1["bytes"], "ms": ms}) if k1 and ms else None
