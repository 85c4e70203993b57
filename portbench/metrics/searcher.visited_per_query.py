"""searcher.visited_per_query: rows the search scored (the program's
`QueryResult.visited`, summed over the window) per query answered."""


def read(rec):
    c = rec.counters
    if not c.get("queries") or "visited" not in c:
        return None
    return c["visited"] / c["queries"]
