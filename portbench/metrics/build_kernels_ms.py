"""build_kernels_ms: device milliseconds of the graph build's two kernels
(`beam_search_kernel`, `robust_prune_kernel`) in the traced flush."""


def read(rec):
    t, tc = rec.trace, rec.trace_counters
    if t is None or not tc.get("flushes"):
        return None
    s = (t.device_time("beam_search_kernel")
         + t.device_time("robust_prune_kernel"))
    if s <= 0:
        return None
    return 1e3 * s / tc["flushes"]
