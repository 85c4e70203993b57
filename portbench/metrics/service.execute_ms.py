"""service.execute_ms: the program's `IndexManager.stage_seconds["execute"]`
gained over the window, per request, in milliseconds."""


def read(rec):
    c = rec.counters
    if not c.get("requests") or "execute_s" not in c:
        return None
    return 1e3 * c["execute_s"] / c["requests"]
