"""Host scan and feed (``models/inverted_index.py``, ``ops/device_tokenizer.py``
``host_token_stats``): ms per build of the windows' pack and token scan
(``--stats`` ``window_scan_ms``, summed over the windows), mean per build.
In the streaming all-device plan the rest of ``stream_feed`` is the reads
(``read_ms.build``) and the feed to the card (the ``feed`` spans)."""


def read(record: dict):
    per = [sum(s["window_scan_ms"]) for s in record["builds"] if "window_scan_ms" in s]
    return sum(per) / len(per) if per else None
