"""writer.pq_train_ms: the program's `knn_quantization_training_time`
counter (PQ train + encode, whole milliseconds) gained over the window,
per flush."""


def read(rec):
    c = rec.counters
    if not c.get("flushes") or "pq_train_ms" not in c:
        return None
    return c["pq_train_ms"] / c["flushes"]
