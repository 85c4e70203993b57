"""approximate_roofline: the on_disk approximate phase of the traced
batches against its least time: the larger of 2 Q N d operations over the
bf16 tensor-core peak and the codes, codebooks and queries read once over
3.35 TB/s, as a share of the device time of every kernel launched inside
the program's `approximate` range, whichever rung ran."""

from portbench.work import peaks, roofline


def read(rec):
    t, tc = rec.trace, rec.trace_counters
    if t is None or not tc.get("batches"):
        return None
    device_s = t.device_time_in_range("approximate")
    if device_s <= 0:
        return None
    cfg = rec.cell.config
    q = tc["queries"] // tc["batches"]
    n, d = cfg["rows"], cfg["dim"]
    m = cfg["index"]["num_pq_subspaces"]
    least = tc["batches"] * roofline.least_seconds(
        roofline.pq_scan_bytes(q, n, d, m), roofline.scan_ops(q, n, d),
        peaks.BF16_FLOP_S)
    return 100.0 * least / device_s
