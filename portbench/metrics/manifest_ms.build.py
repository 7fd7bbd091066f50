"""CLI and manifest (``cli.py``, ``corpus/manifest.py`` ``read_manifest``,
which stats every file of the list): ``--stats`` ``manifest_ms``, mean
per build; only the CLI reports it."""


def read(record: dict):
    per = [s["manifest_ms"] for s in record["builds"] if "manifest_ms" in s]
    return sum(per) / len(per) if per else None
