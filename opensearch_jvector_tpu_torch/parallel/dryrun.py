"""Multi-device dry run of the sharded search paths.

Port of the JAX package's dry run (`__graft_entry__.py`): over a given
mesh, the simple scatter-gather `sharded_search` on a small random graph
per shard, then one tiny `ShardedVectorIndex` per kind of shard (PQ with
an fp32 rerank, `nvq+pq` with NVQ rerank rows, and on_disk PQ with the
host rerank), each placed on the mesh in a temporary directory: add,
flush and search through the one sharded search path. The mesh is
whatever the caller passes: `dryrun(make_mesh(["cuda:0"] * 4))` on one
card, `["cpu"] * 4` in the tests. Unlike the reference, it never falls
back to other devices: a CUDA mesh without a card raises.

    python -m opensearch_jvector_tpu_torch.parallel.dryrun [device ...]
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.parallel import sharded
from opensearch_jvector_tpu_torch.parallel.distributed import ShardedVectorIndex

# the kinds of shard the dry run drives through ShardedVectorIndex.search
INDEX_KINDS = (dict(quantization_type="pq"),
               dict(quantization_type="nvq+pq"),
               dict(quantization_type="pq", mode="on_disk"))


def dryrun(mesh) -> None:
    """One distributed search step of each sharded path over `mesh`."""
    mesh = sharded.make_mesh(mesh)
    d_sh, n_local, dim, m, qn, k = len(mesh), 256, 32, 8, 4, 5
    rng = np.random.default_rng(0)

    def per_shard(arr, dtype):
        return [torch.as_tensor(arr[s], dtype=dtype).to(mesh[s])
                for s in range(d_sh)]

    adjacency = per_shard(rng.integers(0, n_local, size=(d_sh, n_local, m)),
                          torch.int32)
    live = per_shard(np.ones((d_sh, n_local), bool), torch.bool)
    entries = np.zeros(d_sh, np.int64)
    vectors = per_shard(rng.standard_normal((d_sh, n_local, dim)),
                        torch.float32)
    queries = torch.as_tensor(rng.standard_normal((qn, dim)),
                              dtype=torch.float32)
    ids, scores = sharded.sharded_search(
        mesh, adjacency, live, entries, vectors, queries,
        SearchParams(k=k, ef_search=32), SimilarityFunction.EUCLIDEAN)
    assert ids.shape == (qn, k) and bool(torch.isfinite(scores).all())
    assert 0 <= int(ids.min()) and int(ids.max()) < d_sh * n_local

    n = d_sh * 128  # 128 rows a shard: each trains its codebooks
    rows = rng.standard_normal((n, dim)).astype(np.float32)
    for kind in INDEX_KINDS:
        cfg = DiskAnnConfig(dim=dim, m=m, ef_construction=32,
                            num_pq_subspaces=8,
                            min_batch_size_for_quantization=64, **kind)
        with tempfile.TemporaryDirectory(prefix="dryrun_shards_") as root:
            idx = ShardedVectorIndex(root, cfg, n_shards=d_sh,
                                     device=mesh[0], mesh=mesh)
            try:
                assert [s.device for s in idx.shards] == mesh
                idx.add_batch(np.arange(n), rows)
                idx.flush()
                res = idx.search(queries.numpy(), SearchConfig(k=k,
                                                               ef_search=32))
            finally:
                idx.close()
        assert res.doc_ids.shape == (qn, k), kind
        assert np.isfinite(res.scores).all() and res.reranked > 0, kind
        assert 0 <= res.doc_ids.min() and res.doc_ids.max() < n, kind


if __name__ == "__main__":
    dryrun(sys.argv[1:] or None)
    print("dryrun ok")
