"""qps: queries answered in the window over the window's seconds (host
clock, whole calls)."""


def read(rec):
    o = rec.outcome
    if o.unit != "queries" or o.window_s <= 0:
        return None
    return o.units / o.window_s
