"""The mesh exchange's fill, in %: the bytes of the rows that changed
shard (``--stats`` ``exchange_valid_bytes``) over the bytes sent
(``exchange_bytes``), mean per build; the rest is the padding of each
(source, destination) bucket up to the window's exchange capacity."""


def read(record: dict):
    per = [100.0 * s["exchange_valid_bytes"] / s["exchange_bytes"]
           for s in record["builds"] if s.get("exchange_bytes")]
    return sum(per) / len(per) if per else None
