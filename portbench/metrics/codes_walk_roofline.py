"""codes_walk_roofline: the least time the traced batches' walks over PQ
codes allow (the larger of `work.codes_walk` bytes over 3.35 TB/s and its
operations over the float32 peak, from the rows they scored and the
adjacency rows they expanded) as a share of the device time of every
kernel launched inside the program's `searcher.codes_walk` ranges."""

from portbench.work import codes_walk, peaks, roofline


def read(rec):
    t, tc = rec.trace, rec.trace_counters
    if t is None or not tc.get("queries"):
        return None
    device_s = t.device_time_in_range("searcher.codes_walk")
    if device_s <= 0:
        return None
    cfg = rec.cell.config
    s, idx = cfg["search"], cfg["index"]
    r = s["k"] * s.get("overquery_factor", 5)
    pool = max(s.get("ef_search") or max(r, 100), r)  # the walk's L
    nbytes = codes_walk.codes_walk_bytes(
        tc["visited"], tc["expanded"], tc["queries"], idx["dim"],
        idx["num_pq_subspaces"], idx["m"], pool)
    ops = codes_walk.codes_walk_ops(tc["visited"], idx["dim"])
    return 100.0 * roofline.least_seconds(nbytes, ops,
                                          peaks.FP32_FLOP_S) / device_s
