"""searcher.codes_walk_steps: the program's `knn_query_codes_walk_steps`
counter (steps of the plain walk over codes, a host wait each) over the
segment searches of one batch that `knn_query_count` counts (queries over
the mix's batch), both since the process started: the warm calls and the
window's."""


def read(rec):
    from opensearch_jvector_tpu_torch.api.stats import STATS

    snap = STATS.snapshot()
    steps = snap.get("knn_query_codes_walk_steps")
    queries = snap.get("knn_query_count")
    batch = rec.cell.traffic.get("batch")
    if not steps or not queries or not batch:
        return None
    return steps * batch / queries
