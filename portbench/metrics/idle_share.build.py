"""idle_share.build: the device's idle share of the traced window in
the ingest cell, 1 - (the union of the device events' intervals / the window),
in percent."""

from portbench.trace import idle_percent


def read(rec):
    return idle_percent(rec.trace)
