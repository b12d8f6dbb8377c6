"""Device ms inside the slides' loop graphs (CUDA events around
``LoopGraph.launch``), a slide."""


def read(record: dict):
    marks, slides = record.get("marks"), record.get("slides")
    if not marks or not slides:
        return None
    return sum(m["ms"] for m in marks if m["phase"] == "slide" and m["kind"] == "loop") / len(slides)
