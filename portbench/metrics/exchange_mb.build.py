"""The mesh exchange (``parallel/mesh.py`` ``all_to_all``, called by
``parallel/dist_device_streaming.py``): ``--stats`` ``exchange_bytes``,
every exchange's rows as sent from one shard to another, padding
included, in MB (10^6 B), mean per build; only the mesh's streaming
all-device plan reports it."""


def read(record: dict):
    per = [s["exchange_bytes"] / 1e6 for s in record["builds"] if "exchange_bytes" in s]
    return sum(per) / len(per) if per else None
