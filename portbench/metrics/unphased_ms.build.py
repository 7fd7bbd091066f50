"""Set-up and teardown outside every phase (``models/inverted_index.py``
``InvertedIndexModel.run`` around its plan): the CLI's ``build_ms``, all
of ``build_index``, less the phases' ``total_ms``, mean per build."""


def read(record: dict):
    per = [s["build_ms"] - s["total_ms"] for s in record["builds"] if "build_ms" in s]
    return sum(per) / len(per) if per else None
