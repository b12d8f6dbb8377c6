"""K1 (``segsum_gather_add_``) inside the dense rounds, as a share of its
byte bound, in %: the bytes that ``k1_roofline.retrieve``'s probe counted
on the graph's forward view (``benchmark/kernels.py``) over the median
``k1`` stamp interval of the window's dense rounds
(``benchmark/flight.py``)."""

from benchmark import flight, kernels


def probe(cell, info: dict) -> dict:
    return flight.probe(cell)


def read(record: dict):
    k1, ms = record.get("k1"), flight.median_ms(record, "k1")
    return kernels.k1_share({"bytes": k1["bytes"], "ms": ms}) if k1 and ms else None
