"""service.dispatch_rows: the mean over the window's answers of their
`profile.dispatch_rows`, the rows of the device dispatch that served each
request (the micro-batcher's batch)."""


def read(rec):
    rows = rec.counters.get("dispatch_rows")
    if not rows:
        return None
    return sum(rows) / len(rows)
