"""searcher.codes_walk_ms: host milliseconds a traced batch in the
program's `searcher.codes_walk` ranges (the plain graph walk over PQ
codes, whose steps each wait for the device)."""

from portbench import spans


def read(rec):
    batches = rec.trace_counters.get("batches")
    walks = spans.ranges(rec.trace, "searcher.codes_walk")
    if walks is None or not batches:
        return None
    return 1e3 * 1e-6 * sum(b - a for a, b in walks) / batches
