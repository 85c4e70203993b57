"""beam_search_roofline: the least time the traced batches' beam walks
allow (their bytes over 3.35 TB/s: `work.roofline.beam_search_bytes` from
the rows they scored and the adjacency rows they expanded) as a share of
the device time of `beam_search_kernel` in the trace."""

from portbench.work import roofline


def read(rec):
    t, tc = rec.trace, rec.trace_counters
    if t is None or not tc.get("queries"):
        return None
    device_s = t.device_time("beam_search_kernel")
    if device_s <= 0:
        return None
    cfg = rec.cell.config
    ef = cfg["search"].get("ef_search") or max(
        cfg["search"]["k"] * cfg["search"].get("overquery_factor", 5), 100)
    nbytes = roofline.beam_search_bytes(
        tc["visited"], tc["expanded"], tc["queries"],
        cfg["index"]["dim"], cfg["index"]["m"], ef)
    return 100.0 * roofline.least_seconds(nbytes) / device_s
