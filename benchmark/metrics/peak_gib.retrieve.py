"""The window's peak of allocated device memory, in GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(record: dict):
    peak = record.get("peak_bytes_window")
    return None if peak is None else peak / float(1 << 30)
