"""Emit and artifact pack (``text/formatter.py``, ``serve/artifact.py``):
``--stats`` ``phases_ms.emit``, mean per build."""


def read(record: dict):
    per = [s["phases_ms"]["emit"] for s in record["builds"] if "emit" in s["phases_ms"]]
    return sum(per) / len(per) if per else None
