"""Push rounds a slide (``PushStats.rounds``, read from the loop's carry),
averaged over the window's slides."""


def read(record: dict):
    slides = record.get("slides")
    return sum(s["rounds"] for s in slides) / len(slides) if slides else None
