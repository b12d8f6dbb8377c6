"""Push rounds of a request's cold push (``PushStats.rounds``), averaged
over the window's requests."""


def read(record: dict):
    reqs = record.get("requests")
    return sum(r["rounds"] for r in reqs) / len(reqs) if reqs else None
