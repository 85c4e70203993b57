"""index.waits_per_batch: the program's `reader.to_host` ranges (each
segment search's one wait for the device and copy back) a traced batch."""

from portbench import spans


def read(rec):
    batches = rec.trace_counters.get("batches")
    waits = spans.ranges(rec.trace, "reader.to_host")
    if waits is None or not batches:
        return None
    return len(waits) / batches
