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

Layout: `ShardedEngineState` keeps, for each field, one tensor [G, n, ...]
per shard on that shard's device: G segment slots (a shard with fewer
segments gets empty slots: nothing live, no docs) padded to the common
capacity n. The simple `sharded_search` returns global ordinals
shard * n + ordinal; the approx-only search returns locators
shard * (G * n) + segment * n + ordinal. Doc ids and locators are int64
(the reference's int32 limits come from JAX without 64-bit types).

The per-segment search is the port's `searcher.search` with the segment's
providers: the PQ codes with an fp32 or NVQ rerank, the scalar codes with
an fp32 rerank, or the exact fp32 rows; on_disk states run the PQ
approximate phase only, and the caller pages the candidates' rows and
reranks them in one pass (`paged_rerank`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from opensearch_jvector_tpu_torch.index.index import resolve_device
from opensearch_jvector_tpu_torch.models import pq as pq_mod
from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
from opensearch_jvector_tpu_torch.models.graph import pad_rows
from opensearch_jvector_tpu_torch.models.nvq import NVQVectors
from opensearch_jvector_tpu_torch.models.searcher import SearchParams
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
)
from opensearch_jvector_tpu_torch.ops.topk import topk_scores

NEG_INF = float("-inf")


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


# ---------------------------------------------------------------------------
# Full-engine sharded search: each shard runs the complete two-phase search
# of its segments (approximate phase, exact rerank, accept and tombstone
# masks, ordinal -> doc mapping), merges them locally, and only the [Q, k]
# doc and score lists cross to mesh[0].
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedEngineState:
    """Per-shard segment tensors for the mesh search: each field is a list
    with one tensor per shard, [G, n, ...] on that shard's device. `pq_*`
    are None for fp32 shards; NVQ ("nvq+pq") shards beam over the
    auxiliary PQ and rerank the NVQ-decoded rows (`vectors` then holds a
    [G, 1, d] placeholder, as it does for on_disk shards, whose rows stay
    in the host row stores: `approx_only`)."""

    adjacency: list[torch.Tensor]  # [G, n, M] int32
    live: list[torch.Tensor]  # [G, n] bool
    entries: list[torch.Tensor]  # [G] int64
    ord_to_doc: list[torch.Tensor]  # [G, n] int64 (-1: hole or deleted)
    vectors: list[torch.Tensor]  # [G, n, d] f32 (or [G, 1, d])
    pq_codes: list[torch.Tensor] | None = None  # [G, n, Msub] uint8
    pq_codebooks: list[torch.Tensor] | None = None  # [G, Msub, K, dsub]
    pq_center: list[torch.Tensor] | None = None  # [G, d]
    nvq_bytes: list[torch.Tensor] | None = None  # [G, n, d] uint8
    nvq_params: list[torch.Tensor] | None = None  # [G, n, Mn, 4] f32
    nvq_mean: list[torch.Tensor] | None = None  # [G, d] f32
    scalar_codes: list[torch.Tensor] | None = None  # [G, n, B] uint8
    scalar_thresholds: list[torch.Tensor] | None = None  # [G, levels, d]
    approx_only: bool = False

    @property
    def n_shards(self) -> int:
        return len(self.adjacency)

    @property
    def n_segments(self) -> int:
        return self.adjacency[0].shape[0]

    @property
    def n_local(self) -> int:
        return self.adjacency[0].shape[1]

    @property
    def use_pq(self) -> bool:
        return self.pq_codes is not None

    @property
    def use_nvq(self) -> bool:
        return self.nvq_bytes is not None

    @property
    def use_scalar(self) -> bool:
        return self.scalar_codes is not None


def homogenize_pq(shard_lists, similarity, cache=None):
    """Make a PQ / fp32-mixed segment set mesh-stackable.

    The minimum-batch policy leaves small fresh flushes fp32 beside PQ
    segments. Rather than dropping the whole index to the host loop, the
    fp32 segments' rows are encoded with a donor's codebooks (the largest
    PQ segment): the beam rides ADC codes everywhere and the rerank still
    reads the exact fp32 rows. `cache` maps (shard, segment name) to the
    synthetic PQVectors: segment names repeat across shards, and segments
    are immutable. Returns the lists with the replacements, or the input
    where there is no PQ / fp32 mix."""
    all_segs = [s for lst in shard_lists for s in lst]
    have = [s for s in all_segs if s.pqv is not None]
    need = [s for s in all_segs if s.pqv is None]
    if not have or not need:
        return shard_lists
    for s in need:
        if (s.nvq is not None or s.scalar_codes is not None
                or s.config.index_type == "flat"
                or (s.vectors is None and s.row_store is None)):
            return shard_lists  # other mixes: the host loop serves them
    donor = max(have, key=lambda s: s.docmap.num_ordinals).pqv.pq
    cache = cache if cache is not None else {}
    out = []
    for shard_idx, lst in enumerate(shard_lists):
        row = []
        for s in lst:
            if s.pqv is None:
                key = (shard_idx, s.name)
                pqv = cache.get(key)
                if pqv is None:
                    dev = s.device
                    if s.vectors is not None:
                        rows = s.vectors  # [capacity, d]
                    else:  # an on_disk flush: page its rows once
                        rows = pad_rows(torch.from_numpy(s.row_store.gather(
                            np.arange(s.row_store.num_rows))).to(dev),
                            s.capacity())
                    pq = pq_mod.ProductQuantization(
                        codebooks=donor.codebooks.to(dev),
                        center=donor.center.to(dev),
                        aniso_eta=donor.aniso_eta)
                    # the whole capacity: pad rows are not live, so their
                    # codes are never scored
                    pqv = pq_mod.PQVectors(
                        pq=pq, codes=pq_mod.encode(pq, rows, similarity))
                    cache[key] = pqv
                s = dataclasses.replace(s, pqv=pqv)
            row.append(s)
        out.append(row)
    return out


def _stack_mode(segments):
    """Validate the segment lists and the stacked shape parameters."""
    if segments and not isinstance(segments[0], (list, tuple)):
        shard_lists = [[s] for s in segments]
    else:
        shard_lists = [list(x) for x in segments]
    all_segs = [s for lst in shard_lists for s in lst]
    if not all_segs:
        raise ValueError("mesh path requires at least one segment")
    g_max = max(len(lst) for lst in shard_lists)
    n = max(s.capacity() for s in all_segs)
    use_pq = all_segs[0].pqv is not None
    use_nvq = all_segs[0].nvq is not None
    use_scalar = all_segs[0].scalar_codes is not None
    # on_disk shards: rows stay in the host row stores, the mesh runs the
    # PQ approximate phase only; small below-min-batch flushes keep their
    # fp32 rows on the device and are paged from there
    use_disk = any(s.row_store is not None for s in all_segs)
    for s in all_segs:
        if use_disk and s.row_store is None and s.vectors is None:
            raise ValueError("mesh path requires a row source per segment")
        if s.config.index_type == "flat":
            raise ValueError("flat segments have no graph to beam on the mesh")
        if ((s.scalar_codes is not None) != use_scalar
                or (s.nvq is not None) != use_nvq
                or (s.pqv is not None) != use_pq):
            raise ValueError("mesh path requires uniform quantization")
        if not use_nvq and not use_disk and s.vectors is None:
            raise ValueError("mesh path requires device-resident fp32 rows")
    if use_disk and (not use_pq or use_nvq or use_scalar):
        raise ValueError("on_disk mesh shards require the PQ beam")
    sc_shapes = cb_shape = None
    if use_scalar:
        shapes = {(tuple(np.shape(s.scalar_state.thresholds)),
                   int(s.scalar_codes.shape[1])) for s in all_segs}
        if len(shapes) != 1:
            raise ValueError("mesh path requires identical scalar shapes")
        sc_shapes = next(iter(shapes))
    if use_nvq:
        if not use_pq:
            raise ValueError("NVQ segments must carry an aux PQ (nvq+pq)")
        if len({s.nvq.num_subvectors for s in all_segs}) != 1:
            raise ValueError("mesh path requires identical NVQ subvectors")
    if use_pq:
        shapes = {tuple(s.pqv.pq.codebooks.shape) for s in all_segs}
        if len(shapes) != 1:
            raise ValueError("mesh path requires identical codebook shapes")
        cb_shape = next(iter(shapes))
    mode = dict(
        g_max=g_max, n=n, use_pq=use_pq, use_nvq=use_nvq, cb_shape=cb_shape,
        use_scalar=use_scalar, sc_shapes=sc_shapes, use_disk=use_disk,
        dim=all_segs[0].config.dim,
        m_deg=all_segs[0].graph.adjacency.shape[1],
        nvq_nsub=all_segs[0].nvq.num_subvectors if use_nvq else 0,
    )
    return shard_lists, mode


# grid key -> (ShardedEngineState field, fill of an empty slot or row,
# whether the key has a row axis of length n)
_GRID_FIELDS = dict(
    adj=("adjacency", -1, True), live=("live", False, True),
    ent=("entries", 0, False), o2d=("ord_to_doc", -1, True),
    v=("vectors", 0, True), codes=("pq_codes", 0, True),
    books=("pq_codebooks", 0, False), center=("pq_center", 0, False),
    nvq_b=("nvq_bytes", 0, True), nvq_p=("nvq_params", 0, True),
    nvq_m=("nvq_mean", 0, False), sc_c=("scalar_codes", 0, True),
    sc_t=("scalar_thresholds", 0, False),
)


def fit_rows(t: torch.Tensor, n: int, fill) -> torch.Tensor:
    """A row-indexed tensor cut or padded (with `fill`) to n rows."""
    if t.shape[0] >= n:
        return t[:n]
    return torch.cat([t, t.new_full((n - t.shape[0], *t.shape[1:]), fill)])


def _shard_grid(lst, mode, device: torch.device) -> dict:
    """One shard's segments (+ empty slots) -> {grid key: [G, ...] tensor
    on `device`}; keys whose mode is off are absent."""
    n, g_max = mode["n"], mode["g_max"]
    dim, placeholder = mode["dim"], mode["use_nvq"] or mode["use_disk"]

    def seg_row(s) -> dict:
        o2d = torch.from_numpy(s.docmap.ord_to_doc.astype(np.int64))
        row = dict(adj=s.graph.adjacency, live=s.graph.live,
                   ent=torch.tensor(int(s.graph.entry)), o2d=o2d,
                   v=(torch.zeros((1, dim)) if placeholder else s.vectors))
        if mode["use_nvq"]:
            row.update(nvq_b=s.nvq.bytes_, nvq_p=s.nvq.params,
                       nvq_m=s.nvq.global_mean)
        if mode["use_pq"]:
            row.update(codes=s.pqv.codes, books=s.pqv.pq.codebooks,
                       center=s.pqv.pq.center)
        if mode["use_scalar"]:
            row.update(sc_c=s.scalar_codes,
                       sc_t=torch.from_numpy(np.ascontiguousarray(
                           s.scalar_state.thresholds, np.float32)))
        return row

    rows = [seg_row(s) for s in lst]
    out = {}
    for key in rows[0]:
        _, fill, has_rows = _GRID_FIELDS[key]
        parts = []
        for r in rows:
            t = r[key].to(device)
            if has_rows and not (key == "v" and placeholder):
                t = fit_rows(t, n, fill)
            parts.append(t)
        empty = parts[0].new_full(parts[0].shape, fill)
        parts += [empty] * (g_max - len(parts))
        out[key] = torch.stack(parts)
    return out


def _state_from_grids(grids: list[dict], use_disk: bool) -> ShardedEngineState:
    fields = {f: ([g[k] for g in grids] if k in grids[0] else None)
              for k, (f, _, _) in _GRID_FIELDS.items()}
    return ShardedEngineState(**fields, approx_only=use_disk)


def stack_engine_state(segments, mesh) -> ShardedEngineState:
    """Per-shard segment lists (or one segment per shard) -> the mesh
    state, shard s on mesh[s]. Requirements (the caller serves the host
    loop otherwise, on the ValueError): uniformly quantized graph segments
    (all fp32, all PQ with one codebook shape, all NVQ with one subvector
    count, or all scalar with one code width); on_disk segments stack as
    an approx_only state."""
    shard_lists, mode = _stack_mode(segments)
    return _state_from_grids(
        [_shard_grid(lst, mode, mesh[s]) for s, lst in enumerate(shard_lists)],
        mode["use_disk"])


def _resized(state: ShardedEngineState, s: int, g_max: int, n: int) -> dict:
    """Shard s's grid cut or padded to G = g_max slots of n rows, on its
    device (its segments did not change: nothing is gathered again)."""
    out = {}
    for key, (field, fill, has_rows) in _GRID_FIELDS.items():
        vals = getattr(state, field)
        if vals is None:
            continue
        t = vals[s]
        if has_rows and not (key == "v" and t.shape[1] == 1
                             and (state.use_nvq or state.approx_only)):
            t = torch.stack([fit_rows(x, n, fill) for x in t])
        out[key] = fit_rows(t, g_max, fill)
    return out


def restack_engine_state(prev_state: ShardedEngineState | None, prev_names,
                         segments, names, mesh):
    """Incremental restack: re-gather only the shards whose segment-name
    lists changed; the others keep their tensors, cut or padded on their
    device when the slot count G or the capacity n moved. A full stack when
    there is no previous state or the shard count, quantization mode,
    degree, dimension or codebook / NVQ / scalar shapes differ.

    Returns (state, rebuilt shards); rebuilt == n_shards is a full
    restack, 0 means the previous state is returned as it was."""
    shard_lists, mode = _stack_mode(segments)
    d_sh = len(shard_lists)
    full = prev_state is None or prev_names is None
    if not full:
        p = prev_state
        full = (
            d_sh != p.n_shards or len(prev_names) != d_sh
            or mode["use_pq"] != p.use_pq or mode["use_nvq"] != p.use_nvq
            or mode["use_scalar"] != p.use_scalar
            or mode["use_disk"] != p.approx_only
            or mode["m_deg"] != p.adjacency[0].shape[2]
            or mode["dim"] != p.vectors[0].shape[-1]
            or (mode["use_pq"]
                and mode["cb_shape"] != tuple(p.pq_codebooks[0].shape[1:]))
            or (mode["use_nvq"]
                and mode["nvq_nsub"] != p.nvq_params[0].shape[-2])
            or (mode["use_scalar"] and (
                tuple(p.scalar_thresholds[0].shape[1:]) != mode["sc_shapes"][0]
                or p.scalar_codes[0].shape[-1] != mode["sc_shapes"][1])))
    if full:
        return stack_engine_state(segments, mesh), d_sh
    changed = [s for s in range(d_sh) if names[s] != prev_names[s]]
    same_shape = (mode["g_max"] == prev_state.n_segments
                  and mode["n"] == prev_state.n_local)
    if not changed and same_shape:
        return prev_state, 0
    grids = [_shard_grid(shard_lists[s], mode, mesh[s]) if s in changed
             else _resized(prev_state, s, mode["g_max"], mode["n"])
             for s in range(d_sh)]
    return _state_from_grids(grids, mode["use_disk"]), len(changed)


def _segment_params(params: SearchParams, approx: bool) -> SearchParams:
    """What one segment's search runs: the approximate phase alone keeps
    r = k * overquery candidates and no score cut."""
    if not approx:
        return params
    r = max(params.k * params.overquery_factor, params.k)
    return dataclasses.replace(params, k=r, overquery_factor=1,
                               threshold=0.0, rerank_floor=0.0)


def _full_local_search(state: ShardedEngineState, s: int, g: int,
                       queries: torch.Tensor, accept: torch.Tensor,
                       params: SearchParams, simf: SimilarityFunction,
                       approx: bool = False):
    """The two-phase search of segment g of shard s through the port's
    searcher -> (ordinals [Q, w], docs [Q, w], scores [Q, w],
    visited, expanded, reranked), w = k, or r = k * overquery for the
    approximate phase alone. Ordinals map to docs; unmapped ones and
    -inf scores come back as -1."""
    sources: dict = {}
    if state.use_pq:
        sources.update(pq_codes=state.pq_codes[s][g],
                       pq_codebooks=state.pq_codebooks[s][g],
                       pq_center=state.pq_center[s][g])
        if state.use_nvq:
            sources["nvq"] = NVQVectors(bytes_=state.nvq_bytes[s][g],
                                        params=state.nvq_params[s][g],
                                        global_mean=state.nvq_mean[s][g])
        elif not approx:
            sources["vectors"] = state.vectors[s][g]
    elif state.use_scalar:
        sources.update(scalar_codes=state.scalar_codes[s][g],
                       scalar_thresholds=state.scalar_thresholds[s][g],
                       vectors=state.vectors[s][g])
    else:
        sources["vectors"] = state.vectors[s][g]
    res = searcher_mod.search(
        state.adjacency[s][g], state.live[s][g], state.entries[s][g],
        queries, _segment_params(params, approx), simf, accept=accept,
        **sources)
    ids, scores = res.ids, res.scores
    keep = ids >= 0
    if approx and params.rerank_floor > 0.0:
        keep &= scores >= params.rerank_floor
    docs = torch.where(keep, state.ord_to_doc[s][g][ids.clamp(min=0)], -1)
    keep &= docs >= 0
    return (torch.where(keep, ids, -1), torch.where(keep, docs, -1),
            torch.where(keep, scores, NEG_INF), res.visited_count.sum(),
            res.expanded_count.sum(), res.reranked_count.sum())


def _shard_search(state, s, queries, accept, params, simf, approx):
    """All G segments of shard s, merged locally -> (docs, scores,
    locators or None, counters [3]) on mesh[s]."""
    g_n, n = state.n_segments, state.n_local
    width = (max(params.k * params.overquery_factor, params.k) if approx
             else params.k)
    outs = [_full_local_search(state, s, g, queries,
                               state.live[s][g] if accept is None
                               else accept[s][g], params, simf, approx)
            for g in range(g_n)]
    scores = torch.cat([o[2] for o in outs], 1)
    docs = torch.cat([o[1] for o in outs], 1)
    top_s, idx = torch.topk(scores, min(width, scores.shape[1]), dim=1)
    top_d = torch.gather(docs, 1, idx)
    locs = None
    if approx:
        locs = torch.cat([torch.where(o[0] >= 0, (s * g_n + g) * n + o[0], -1)
                          for g, o in enumerate(outs)], 1)
        locs = torch.gather(locs, 1, idx)
    counters = torch.stack([sum(o[k] for o in outs) for k in (3, 4, 5)])
    return top_d, top_s, locs, counters


def sharded_engine_search(mesh, state: ShardedEngineState, queries,
                          params: SearchParams, simf: SimilarityFunction,
                          accept=None):
    """Full-engine scatter-gather over the mesh: `accept` is one [G, n]
    ordinal mask per shard (default: `live`). Returns (doc ids [Q, k]
    int64, scores [Q, k] f32, counters [D, 3] = per shard visited,
    expanded, reranked), all on mesh[0]."""
    if state.approx_only:
        raise ValueError("approx_only (on_disk) states have no rerank rows "
                         "on the device: use sharded_engine_search_approx "
                         "and paged_rerank")
    q = torch.as_tensor(queries, dtype=torch.float32)
    docs, scores, counters = [], [], []
    for s in range(state.n_shards):
        d, sc, _, c = _shard_search(state, s, q.to(mesh[s]), accept, params,
                                    simf, approx=False)
        docs.append(d)
        scores.append(sc)
        counters.append(c.to(mesh[0]))
    top_s, top_d = _cross_shard_topk(scores, docs, mesh, params.k)
    return (torch.where(top_s > NEG_INF, top_d, -1), top_s,
            torch.stack(counters))


def sharded_engine_search_approx(mesh, state: ShardedEngineState, queries,
                                 params: SearchParams,
                                 simf: SimilarityFunction, accept=None):
    """The approximate phase of the on_disk mesh search: the PQ beam over
    every shard's codes, merged by approximate score. Returns (docs [Q, R],
    locators [Q, R], approximate scores [Q, R], counters [D, 3]) on
    mesh[0], R = k * overquery, locator = shard * (G * n) + segment * n +
    ordinal (-1 for empty slots); the caller pages the rows and reranks."""
    if not (state.approx_only and state.use_pq):
        raise ValueError("the approximate mesh phase needs an on_disk PQ "
                         "state")
    r = max(params.k * params.overquery_factor, params.k)
    q = torch.as_tensor(queries, dtype=torch.float32)
    docs, scores, locs, counters = [], [], [], []
    for s in range(state.n_shards):
        d, sc, lc, c = _shard_search(state, s, q.to(mesh[s]), accept, params,
                                     simf, approx=True)
        docs.append(d.to(mesh[0]))
        scores.append(sc.to(mesh[0]))
        locs.append(lc.to(mesh[0]))
        counters.append(c.to(mesh[0]))
    flat_s = torch.cat(scores, 1)
    top_s, idx = torch.topk(flat_s, min(r, flat_s.shape[1]), dim=1)
    keep = top_s > NEG_INF
    top_d = torch.where(keep, torch.gather(torch.cat(docs, 1), 1, idx), -1)
    top_l = torch.where(keep, torch.gather(torch.cat(locs, 1), 1, idx), -1)
    return top_d, top_l, top_s, torch.stack(counters)


def paged_rerank(queries: torch.Tensor, cand: torch.Tensor,
                 docs: torch.Tensor, k: int, threshold: float,
                 simf: SimilarityFunction):
    """Exact rerank of paged candidate rows in one device pass: queries
    [Q, d], cand [Q, R, d] fp32 (zero rows where docs is -1), docs [Q, R]
    -> (doc ids [Q, k], scores [Q, k], candidates scored per query)."""
    exact = batched_candidate_scores(queries, cand, simf)
    valid = docs >= 0
    exact = torch.where(valid, exact, NEG_INF)
    if threshold > 0.0:
        exact = torch.where(exact >= threshold, exact, NEG_INF)
    top_s, idx = torch.topk(exact, min(k, exact.shape[1]), dim=1)
    top_d = torch.where(top_s > NEG_INF, torch.gather(docs, 1, idx), -1)
    return top_d, top_s, valid.sum(1)


def dryrun_engine(mesh) -> None:
    """Tiny end-to-end run of the engine paths over `mesh`: synthetic PQ
    shards of two segments each (ADC beam + rerank + docmap + merge), the
    same with NVQ rerank rows, and the on_disk approx-only phase."""
    rng = np.random.default_rng(1)
    d_sh, g, n, m, dim, nsub, kq = len(mesh), 2, 128, 8, 32, 8, 5
    dsub = dim // nsub

    def per_shard(arr, dtype=None):
        return [torch.as_tensor(arr[s], dtype=dtype).to(mesh[s])
                for s in range(d_sh)]

    state = ShardedEngineState(
        adjacency=per_shard(rng.integers(0, n, size=(d_sh, g, n, m)),
                            torch.int32),
        live=per_shard(np.ones((d_sh, g, n), bool)),
        entries=per_shard(np.zeros((d_sh, g), np.int64)),
        ord_to_doc=per_shard(np.arange(d_sh * g * n).reshape(d_sh, g, n)),
        vectors=per_shard(rng.standard_normal((d_sh, g, n, dim)),
                          torch.float32),
        pq_codes=per_shard(rng.integers(0, 16, size=(d_sh, g, n, nsub)),
                           torch.uint8),
        pq_codebooks=per_shard(rng.standard_normal((d_sh, g, nsub, 16, dsub)),
                               torch.float32),
        pq_center=per_shard(np.zeros((d_sh, g, dim), np.float32)),
    )
    queries = torch.as_tensor(rng.standard_normal((4, dim)),
                              dtype=torch.float32)
    params = SearchParams(k=kq, ef_search=32)
    euclid = SimilarityFunction.EUCLIDEAN
    docs, _, counters = sharded_engine_search(mesh, state, queries, params,
                                              euclid)
    assert docs.shape == (4, kq) and counters.shape == (d_sh, 3)
    assert int(docs.max()) < d_sh * g * n and int(docs.min()) >= 0

    # NVQ shards: aux-PQ beam + NVQ-decoded rerank
    nvq_p = np.zeros((d_sh, g, n, 2, 4), np.float32)
    nvq_p[..., 0], nvq_p[..., 1] = 4.0, 0.5  # growth rate, midpoint
    nvq_p[..., 2], nvq_p[..., 3] = -3.0, 3.0  # min, max
    nvq_state = dataclasses.replace(
        state,
        vectors=per_shard(np.zeros((d_sh, g, 1, dim), np.float32)),
        nvq_bytes=per_shard(rng.integers(0, 256, size=(d_sh, g, n, dim)),
                            torch.uint8),
        nvq_params=per_shard(nvq_p),
        nvq_mean=per_shard(np.zeros((d_sh, g, dim), np.float32)))
    docs2, scores2, _ = sharded_engine_search(mesh, nvq_state, queries,
                                              params, euclid)
    assert docs2.shape == (4, kq) and bool(torch.isfinite(scores2).all())

    # on_disk shards: the approx-only phase returns candidate locators
    disk_state = dataclasses.replace(
        state, vectors=per_shard(np.zeros((d_sh, g, 1, dim), np.float32)),
        approx_only=True)
    docs3, locs3, _, ctr3 = sharded_engine_search_approx(
        mesh, disk_state, queries, params, euclid)
    r = max(params.k * params.overquery_factor, params.k)
    assert docs3.shape == (4, r) and locs3.shape == (4, r)
    assert int(locs3.max()) < d_sh * g * n and ctr3.shape == (d_sh, 3)


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
