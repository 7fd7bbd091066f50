"""The mesh's balance over its owners (the content hash of each word
row, ``parallel/dist_device_tokenizer.py`` ``_mix32``): the largest
owner's unique (word, doc) rows at the finalize over the mean owner's
(``--stats`` ``owner_rows``), mean per build; 1 is an even split, and
the largest owner sets the mesh's merge and finalize time."""


def read(record: dict):
    per = [max(s["owner_rows"]) * len(s["owner_rows"]) / sum(s["owner_rows"])
           for s in record["builds"] if sum(s.get("owner_rows") or [0])]
    return sum(per) / len(per) if per else None
