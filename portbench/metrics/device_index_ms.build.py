"""Device index (``ops/``): ``--stats`` ``phases_ms.device_index``, the
host's wait for the device's counts, mean per build."""


def read(record: dict):
    per = [s["phases_ms"]["device_index"] for s in record["builds"]
           if "device_index" in s["phases_ms"]]
    return sum(per) / len(per) if per else None
