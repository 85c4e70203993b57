"""builder.backedges_host_s: seconds a flush in the graph builder's
`backedges_host` phase (`BuildCounters.phase_s`, kept only with
JVECTOR_TPU_BUILD_PROFILE=1, which traced runs set), over the window's
flushes."""


def read(rec):
    c = rec.counters
    if not c.get("flushes") or "backedges_host" not in c.get("phase_s", {}):
        return None
    return c["phase_s"]["backedges_host"] / c["flushes"]
