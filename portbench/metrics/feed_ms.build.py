"""Host scan and feed (``native/tokenizer.cc``, ``models/inverted_index.py``):
the plan's feed phase (``feed``, ``stream_feed`` or ``tokenize_feed`` of
``--stats`` ``phases_ms``), mean per build."""

FEED = ("feed", "stream_feed", "tokenize_feed")


def read(record: dict):
    per = [sum(v for k, v in s["phases_ms"].items() if k in FEED)
           for s in record["builds"] if any(k in FEED for k in s["phases_ms"])]
    return sum(per) / len(per) if per else None
