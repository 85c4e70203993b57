"""recall_at_10: over every judged answer, the share of the query's exact
top 10 (the benchmark's reference) among its 10 returned ids."""


def read(rec):
    return rec.recall
