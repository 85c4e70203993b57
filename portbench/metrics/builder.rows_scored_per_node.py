"""builder.rows_scored_per_node: the program's `knn_graph_build_rows_scored`
counter (rows its flushes' insert walks scored) over
`knn_graph_build_nodes` (nodes those builds inserted), both counted since
the process started: the run's warm flush and its window's flushes."""


def read(rec):
    from opensearch_jvector_tpu_torch.api.stats import STATS

    snap = STATS.snapshot()
    rows = snap.get("knn_graph_build_rows_scored")
    nodes = snap.get("knn_graph_build_nodes")
    if rows is None or not nodes:
        return None
    return rows / nodes
