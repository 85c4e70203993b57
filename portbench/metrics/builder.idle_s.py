"""builder.idle_s: the device's idle seconds inside the program's
`writer.build` ranges (the flush's graph build), a traced flush."""

from portbench import spans


def read(rec):
    flushes = rec.trace_counters.get("flushes")
    s = spans.idle_seconds(rec.trace, "writer.build")
    if s is None or not flushes:
        return None
    return s / flushes
