"""Device ms inside a request's loop graph (CUDA events around
``LoopGraph.launch``), averaged over the window's requests."""


def read(record: dict):
    marks, reqs = record.get("marks"), record.get("requests")
    if not marks or not reqs:
        return None
    return sum(m["ms"] for m in marks if m["phase"] == "request" and m["kind"] == "loop") / len(reqs)
