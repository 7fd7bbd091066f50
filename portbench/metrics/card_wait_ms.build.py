"""The host's wait on the card (``ops/engine.py`` ``PendingFetch.wait``):
``--stats`` ``card_wait_ms``, the time a build blocked on the card's
events, mean per build; only builds that waited on the card report it."""


def read(record: dict):
    per = [s["card_wait_ms"] for s in record["builds"] if "card_wait_ms" in s]
    return sum(per) / len(per) if per else None
