"""The mesh's largest peak over its cards: ``--stats`` ``card_peak_bytes``,
``torch.cuda.max_memory_allocated`` of each card the mesh holds at the
end of the plan (no reset of its own: since the process started, but
card 0's since the harness's reset before the window), the largest over
the cards and the builds.  ``peak_device_bytes.build`` reads card 0
alone."""


def read(record: dict):
    per = [max(s["card_peak_bytes"]) for s in record["builds"] if s.get("card_peak_bytes")]
    return max(per) if per else None
