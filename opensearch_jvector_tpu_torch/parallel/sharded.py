"""Sharded search over a mesh: an ordered list of devices in one process.

Port of `opensearch_jvector_tpu/parallel/sharded.py`. The reference is
single-controller: one process drives every device of a JAX mesh, each
device runs the same beam-search program on its corpus shard, and the
per-shard [Q, k] lists ride an all_gather into one top-k merge. Here a mesh
is an ordered list of `torch.device`s (`make_mesh`): shard s lives on
mesh[s] and is searched there, and each shard's [Q, k] lists are copied to
mesh[0] and merged there, which stands in for the all_gather. Entries may
repeat: one CPU holds a 4-entry mesh in the tests, and one card holds
four shards, as one OpenSearch node holds several.

This module keeps the reference's library surface: `make_mesh`, the simple
`sharded_search` over stacked shard graphs (global ordinals shard * n +
ordinal, int64 where the reference's are int32) and `build_sharded`. A
sharded index (`parallel/distributed.py`) does not stack its segments into
one engine state as the reference's mesh path does: a mesh here is devices
in one process, so each shard's own `VectorIndex`, placed on its device,
already runs every tier of its segments there.
"""

from __future__ import annotations

import numpy as np
import torch

from opensearch_jvector_tpu_torch.index.index import resolve_device
from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.ops.topk import topk_scores


def make_mesh(devices=None) -> list[torch.device]:
    """The mesh: the given devices in order (entries may repeat), or every
    visible card. A CUDA entry without a card raises."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for a default mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _cross_shard_topk(scores: list[torch.Tensor], ids: list[torch.Tensor],
                      mesh, k: int):
    """Per-shard [Q, w] lists -> the best k on mesh[0] (the all_gather and
    the replicated merge of the reference)."""
    dev = mesh[0]
    return topk_scores(torch.cat([s.to(dev) for s in scores], 1),
                       torch.cat([i.to(dev) for i in ids], 1), k)


def sharded_search(mesh, adjacency, live, entries, vectors, queries,
                   params: SearchParams, simf: SimilarityFunction,
                   accept=None):
    """Scatter-gather exact beam search over stacked shards
    (adjacency [D, n, M], live [D, n], entries [D], vectors [D, n, d],
    accept [D, n]) -> (global ordinals [Q, k] on mesh[0], scores)."""
    d_sh, n_local = len(adjacency), adjacency[0].shape[0]
    q_host = torch.as_tensor(queries, dtype=torch.float32)
    r = max(params.k * params.overquery_factor, params.k)
    ef = max(params.ef_search, r)
    e = params.expansions_per_iter
    iters = params.max_iters or max(
        8, -(-max(params.ef_search, params.k) // e))
    ids_all, scores_all = [], []
    for s in range(d_sh):
        dev = mesh[s]
        q = q_host.to(dev)
        liv = live[s].to(dev)
        ids, scores, _, _ = searcher_mod.beam_search(
            adjacency[s].to(dev), liv, int(entries[s]),
            searcher_mod.ExactProvider(q, vectors[s].to(dev), simf),
            q.shape[0], liv if accept is None else accept[s].to(dev),
            L=ef, E=e, R=r, max_iters=iters)
        top_s, top_i = topk_scores(scores, ids, params.k)
        ids_all.append(torch.where(top_i >= 0, s * n_local + top_i, -1))
        scores_all.append(top_s)
    top_s, top_i = _cross_shard_topk(scores_all, ids_all, mesh, params.k)
    return top_i, top_s


def build_sharded(vectors_np, n_shards: int, builder_factory,
                  simf: SimilarityFunction, *,
                  device: torch.device | str = "cuda"):
    """Partition a corpus round-robin into shards and build one graph each
    on `device`. Returns stacked (adjacency [D, n, M], live [D, n],
    entries [D], vectors [D, n, d], global ids [D, n] on the host); the
    tail of a short shard repeats row 0 with live False."""
    dev = resolve_device(device)
    n = vectors_np.shape[0]
    n_local = -(-n // n_shards)
    adjs, lives, entries, vecs, gids = [], [], [], [], []
    for s in range(n_shards):
        idx = np.arange(s, n, n_shards)
        pad = n_local - idx.size
        sl = np.concatenate([idx, np.zeros(pad, idx.dtype)]) if pad else idx
        v = torch.as_tensor(np.asarray(vectors_np)[sl], dtype=torch.float32,
                            device=dev)
        g = builder_factory().build(v, simf)
        live = g.live[:n_local].clone()
        if pad:
            live[n_local - pad:] = False
        adjs.append(g.adjacency[:n_local])
        lives.append(live)
        entries.append(int(g.entry))
        vecs.append(v)
        gids.append(sl)
    return (torch.stack(adjs), torch.stack(lives),
            torch.as_tensor(entries, device=dev), torch.stack(vecs),
            np.stack(gids))
