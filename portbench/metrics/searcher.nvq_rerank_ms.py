"""searcher.nvq_rerank_ms: host milliseconds a traced batch in the
program's `searcher.nvq_rerank` ranges (the candidates' NVQ decode and
their float32 scores, queued on the device)."""

from portbench import spans


def read(rec):
    batches = rec.trace_counters.get("batches")
    reranks = spans.ranges(rec.trace, "searcher.nvq_rerank")
    if reranks is None or not batches:
        return None
    return 1e3 * 1e-6 * sum(b - a for a, b in reranks) / batches
