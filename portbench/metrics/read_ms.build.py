"""Corpus reads (``corpus/manifest.py``, ``io/``): the reader's ms per
build, summed over its windows (``--stats`` ``window_read_ms``), mean per
build.  Only the plans with a reader thread report it."""


def read(record: dict):
    per = [sum(s["window_read_ms"]) for s in record["builds"] if "window_read_ms" in s]
    return sum(per) / len(per) if per else None
