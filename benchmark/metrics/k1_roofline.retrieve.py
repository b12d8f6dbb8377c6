"""K1 (``segsum_gather_add_``) alone on the forward delivery view of the
run's final window, at the cell's width, as a share of its byte bound, in %
(``benchmark/kernels.py``)."""

from benchmark import kernels


def probe(cell, info: dict) -> dict:
    return {"k1": kernels.k1_probe(cell, info)}


def read(record: dict):
    return kernels.k1_share(record.get("k1"))
