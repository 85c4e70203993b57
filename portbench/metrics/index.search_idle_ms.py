"""index.search_idle_ms: the device's idle time inside the program's
`index.search` ranges (`VectorIndex.search`, the facade's whole call), in
milliseconds a traced batch: the gaps between the device's busy intervals,
clipped to those ranges."""

from portbench import spans


def read(rec):
    batches = rec.trace_counters.get("batches")
    s = spans.idle_seconds(rec.trace, "index.search")
    if s is None or not batches:
        return None
    return 1e3 * s / batches
