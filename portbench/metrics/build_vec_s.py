"""build_vec_s: rows made searchable in the window (every add_batch +
flush it completed) over the window's seconds (host clock)."""


def read(rec):
    o = rec.outcome
    if o.unit != "rows" or o.window_s <= 0:
        return None
    return o.units / o.window_s
