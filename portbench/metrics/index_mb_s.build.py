"""The whole build's throughput, in MB/s: the document bytes (10^6 B) of
every build that ended well in the window over the window's time, the
checks between builds taken out."""


def read(record: dict):
    if not record["builds"] or not record.get("window_s"):
        return None
    return len(record["builds"]) * record["corpus_bytes"] / 1e6 / record["window_s"]
