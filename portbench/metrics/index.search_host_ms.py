"""index.search_host_ms: host milliseconds a traced batch inside the
program's `index.search` ranges but outside the `reader.to_host` ranges
in them (the segment searches' waits for the device): the facade's and
the readers' own host work."""

from portbench import spans


def read(rec):
    batches = rec.trace_counters.get("batches")
    s = spans.host_seconds(rec.trace, "index.search", "reader.to_host")
    if s is None or not batches:
        return None
    return 1e3 * s / batches
