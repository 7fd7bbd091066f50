"""The card's peak allocated bytes in the window:
``torch.cuda.max_memory_allocated()`` after a reset at its start."""


def read(record: dict):
    return record["peak_window_bytes"] if record.get("device_kind") else None
