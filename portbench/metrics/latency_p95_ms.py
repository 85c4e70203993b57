"""latency_p95_ms: the 95th percentile, over every call of the window, of
the time from the call's start to the return of its answer (host clock;
in the REST cell the client's clock, send to last byte)."""

from portbench.window import percentile


def read(rec):
    lat = [end - start for start, end in rec.outcome.calls]
    if not lat:
        return None
    return 1e3 * percentile(lat, 95.0)
