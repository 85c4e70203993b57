"""builder.search_s: seconds a flush in the graph builder's `search` phase
(the insert rounds' beam walks; `BuildCounters.phase_s`, traced runs
only), over the window's flushes."""


def read(rec):
    c = rec.counters
    if not c.get("flushes") or "search" not in c.get("phase_s", {}):
        return None
    return c["phase_s"]["search"] / c["flushes"]
