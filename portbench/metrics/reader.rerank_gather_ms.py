"""reader.rerank_gather_ms: host milliseconds a batch in the program's
`rerank_gather` range (index/reader.py), over the traced batches."""


def read(rec):
    t, tc = rec.trace, rec.trace_counters
    if t is None or not tc.get("batches"):
        return None
    seconds, count = t.range_time("rerank_gather")
    if count == 0:
        return None
    return 1e3 * seconds / tc["batches"]
