"""idle_share.query: the device's idle share of the traced window in
the query cells, 1 - (the union of the device events' intervals / the window),
in percent."""

from portbench.trace import idle_percent


def read(rec):
    return idle_percent(rec.trace)
