"""The card's idle share of the traced window, in %: 1 - the profiler's
device-busy time (kernels, copies, fills) over the window."""


def read(record: dict):
    if not record.get("busy_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
