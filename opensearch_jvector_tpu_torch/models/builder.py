"""Batched Vamana graph construction over fp32 rows.

Port of the fp32 path of `opensearch_jvector_tpu/models/builder.py`
`GraphIndexBuilder.build`: bulk-synchronous insert rounds. Each round
beam-searches candidate sets for a whole batch of pending inserts, adds
intra-round candidates, alpha-robust-prunes the batch, writes the forward
rows, and then computes reverse edges on the host; nodes whose lists
overflow are re-pruned. Rounds are pipelined as in the reference: round k's
search runs before round k-1's reverse edges land, so reverse edges land
one round late (docs/design.md, "pipelined insert rounds").
`add_nodes` delta-inserts new ordinals into an existing graph with the same
rounds (the incremental merge), `mark_deleted` tombstones nodes,
`refine_graph` re-searches and re-prunes every node of a finished graph,
and `cleanup` folds tombstones in (2-hop splice), enforces the degree bound
and links every live node that the entry cannot reach. A reverse edge is
appended only where the destination's row does not hold the source yet, so
no row carries a neighbour twice.

The adjacency lives on the build device and is updated in place; the host
keeps only the degree mirror and the small edge lists. There is no batch
padding: the reference pads rounds to power-of-two widths only to bound
XLA compiles. `build(..., pq={"decoded": cache})` scores the insert
rounds' beam candidates from a bf16 decoded-PQ cache (the on_disk flush's
build source) while every prune stays on the fp32 rows. A bf16 source is
passed through as it is (`_build_rows`): that is the quantized build, where
the decoded cache is the only corpus on the device, beam scoring reads it
as it is, and every prune, bootstrap and cleanup site upcasts the rows it
gathers, never the corpus. With `hierarchy_enabled`, `cleanup` adds the
coarse upper layer (`_build_upper_layer`).

The two compiled loops of the reference's build each run as one launch of
a hand-written CUDA kernel on a CUDA device: the insert rounds' beam walk
(`models/searcher.beam_search` over `ops/beam_kernel.py`) and every
alpha-robust prune (`ops/prune_kernel.robust_prune`, which reads the
candidates' rows by id, so the [B, C, d] gather and the [B, C, C]
distances stay off device memory); on the CPU both run their plain
versions.

`GraphIndexBuilder.counters` (`BuildCounters`) counts insert rounds and
inserted nodes. With `BUILD_PROFILE` on (`JVECTOR_TPU_BUILD_PROFILE=1` at
import, or the module attribute set), every phase of an insert round and of
`cleanup` waits for the device at its end and adds its wall-clock seconds
to `counters.phase_s`. That serialises the pipelined rounds, so it is for
diagnosis only; with it off, no phase adds a wait or a transfer.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
from opensearch_jvector_tpu_torch.models.graph import (
    VamanaGraph,
    bucket_capacity,
    pad_rows,
)
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    batched_candidate_scores,
    pairwise_scores,
)
from opensearch_jvector_tpu_torch.ops.prune_kernel import robust_prune

NEG_INF = float("-inf")

# Corpus-block width for the orphan-repair nearest-host scan: caps the
# [512, block] score slab at 0.5 GB.
ORPHAN_SCAN_BLOCK = 1 << 18
# Bounds the [B, C, d] candidate-row gather of one splice-prune chunk.
SPLICE_GATHER_BYTES = 1 << 30
# Beam expansions per iteration during insert rounds (the reference's
# construction default) and the default seed of the insert order.
CONSTRUCTION_EXPANSIONS = 8
BUILD_SEED = 42

BUILD_PROFILE = os.environ.get("JVECTOR_TPU_BUILD_PROFILE", "0") == "1"


def _sync(device: torch.device) -> None:
    """Wait for the work queued on `device` (the profile's phase edges)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _phase_start() -> float:
    return time.perf_counter() if BUILD_PROFILE else 0.0


def _build_rows(vectors: torch.Tensor) -> torch.Tensor:
    """Build-source rows: float32, or a bf16 source as it is (the quantized
    build's decoded-PQ cache)."""
    return vectors if vectors.dtype == torch.bfloat16 else vectors.float()


def _float_blocks(vectors: torch.Tensor):
    """(lo, rows as float32) over all of `vectors`: one block for a float32
    source, ORPHAN_SCAN_BLOCK rows at a time for a bf16 one, so a corpus-wide
    pass never holds a float32 copy of the corpus."""
    n = vectors.shape[0]
    step = ORPHAN_SCAN_BLOCK if vectors.dtype == torch.bfloat16 else n
    for lo in range(0, n, max(step, 1)):
        yield lo, vectors[lo: lo + step].float()


def _scores_to_rows(row: torch.Tensor, vectors: torch.Tensor,
                    simf: SimilarityFunction) -> torch.Tensor:
    """[1, d] float32 row against every row of `vectors` -> [n] scores."""
    return torch.cat([pairwise_scores(row, blk, simf)[0]
                      for _, blk in _float_blocks(vectors)])


def _nearest_hostable(ob: torch.Tensor, vectors: torch.Tensor,
                      hostable: torch.Tensor,
                      simf: SimilarityFunction) -> torch.Tensor:
    """Per orphan row, the most similar hostable node, scanned in
    ORPHAN_SCAN_BLOCK-wide corpus blocks. Returns [len(ob)] int64 ids."""
    cap = vectors.shape[0]
    cb = min(cap, ORPHAN_SCAN_BLOCK)
    rows = vectors[ob].float()
    best_s = torch.full((ob.shape[0],), NEG_INF, device=vectors.device)
    best_i = torch.zeros((ob.shape[0],), dtype=torch.long,
                         device=vectors.device)
    for lo in range(0, cap, cb):
        sc = pairwise_scores(rows, vectors[lo: lo + cb].float(), simf)
        sc = torch.where(hostable[lo: lo + cb][None, :], sc, NEG_INF)
        bs, bi = torch.max(sc, dim=1)
        take = bs > best_s
        best_s = torch.where(take, bs, best_s)
        best_i = torch.where(take, bi + lo, best_i)
    return best_i


def _reachable(adj: torch.Tensor, live: torch.Tensor,
               entry: int) -> torch.Tensor:
    """[capacity] bool: live nodes reachable from `entry` over live-node
    paths (frontier BFS on the device)."""
    cap = adj.shape[0]
    reach = torch.zeros((cap,), dtype=torch.bool, device=adj.device)
    reach[entry] = live[entry]
    frontier = reach.clone()
    while bool(frontier.any()):
        tgt = adj[frontier].reshape(-1).long()
        hit = torch.zeros_like(reach)
        hit[tgt[tgt >= 0]] = True
        frontier = hit & live & ~reach
        reach |= frontier
    return reach


class _DeviceAdj:
    """Device-resident adjacency + host degree mirror."""

    def __init__(self, adj: torch.Tensor, deg: np.ndarray):
        self.adj = adj  # int32 [capacity, cap_deg]
        self.deg = deg  # host int32 [capacity]

    @property
    def cap_deg(self) -> int:
        return self.adj.shape[1]

    def write_rows(self, ids: torch.Tensor, sel: torch.Tensor) -> None:
        """adj[ids] = sel padded with -1 to the row width."""
        rows = torch.full((ids.shape[0], self.cap_deg), -1,
                          dtype=torch.int32, device=self.adj.device)
        rows[:, : sel.shape[1]] = sel
        self.adj[ids] = rows

    def write_edges(self, dst, slot, src) -> None:
        """Reverse-edge scatter adj[dst, slot] = src (host index arrays)."""
        if len(dst) == 0:
            return
        dev = self.adj.device
        self.adj[torch.as_tensor(dst, device=dev),
                 torch.as_tensor(slot, device=dev)] = torch.as_tensor(
            src, dtype=torch.int32, device=dev)


@dataclasses.dataclass
class BuildCounters:
    """Insert rounds and inserted nodes over a GraphIndexBuilder's life,
    and under BUILD_PROFILE the seconds by phase. Nothing counts
    `nodes_deleted` (tombstones are folded in by `cleanup`, as in the
    reference)."""

    rounds: int = 0
    nodes_inserted: int = 0
    nodes_deleted: int = 0
    phase_s: dict = dataclasses.field(default_factory=dict)

    def _phase(self, name: str, dt: float) -> None:
        self.phase_s[name] = self.phase_s.get(name, 0.0) + dt


class GraphIndexBuilder:
    """Bulk-synchronous Vamana builder (fp32 rows).

    Usage:
        builder = GraphIndexBuilder(dim, max_degree=32, beam_width=100)
        graph = builder.build(vectors, simf)   # vectors on the build device
        graph = builder.add_nodes(graph, vectors, new_ids, simf)  # delta
        graph = builder.cleanup(graph, vectors, simf)  # prune + repair
    """

    def __init__(
        self,
        dim: int,
        max_degree: int = 32,
        beam_width: int = 100,
        alpha: float = 1.2,
        neighbor_overflow: float = 1.2,
        hierarchy_enabled: bool = False,
        batch_size: int | None = None,  # None -> auto by dim (see below)
        seed: int = BUILD_SEED,  # insert order, upper-layer member sample
        refine_passes: int = 0,  # refine_graph passes at the end of build
    ):
        self.hierarchy_enabled = bool(hierarchy_enabled)
        self.seed = int(seed)
        self.dim = dim
        self.max_degree = int(max_degree)
        self.beam_width = int(beam_width)
        self.alpha = float(alpha)
        self.overflow_degree = max(
            self.max_degree, int(self.max_degree * float(neighbor_overflow)))
        if batch_size is None:
            # the reference's auto-sizing: the largest power of two in
            # [2048, 16384] whose [B, C, d] prune gather stays ~1.5 GB
            c_width = self.beam_width + self.max_degree
            cap = int(1.5e9 / (max(1, dim) * 4 * max(1, c_width)))
            batch_size = 2048
            while batch_size * 2 <= min(cap, 16384):
                batch_size *= 2
        self.batch_size = int(batch_size)
        self.refine_passes = int(refine_passes)
        # overflow-prune extras per node per round: bounds the O(C^2) prune
        # width; back-edges beyond it in one round are dropped (cleanup
        # repairs any orphan)
        self.extra_width = min(2 * self.max_degree, 32)
        self.counters = BuildCounters()
        self._has_tombstones = False

    def _phase_end(self, name: str, t0: float, device) -> float:
        """Under BUILD_PROFILE: wait for `device`, add the seconds since
        `t0` to phase `name` and return the next phase's start. Nothing
        (no wait) when the profile is off."""
        if not BUILD_PROFILE:
            return 0.0
        _sync(device)
        t = time.perf_counter()
        self.counters._phase(name, t - t0)
        return t

    # -- scoring helpers ---------------------------------------------------

    def _search_candidates(self, adj, live_dev, entry, vectors, queries,
                           simf, pq=None):
        """Beam-search candidate pools (ids [B, R], scores [B, R]); with
        `pq` the candidates score from its decoded cache."""
        r = self.beam_width
        e = CONSTRUCTION_EXPANSIONS
        if pq is None and vectors.dtype == torch.bfloat16:
            pq = {"decoded": vectors}
        params = searcher_mod.SearchParams(
            k=r, ef_search=r, overquery_factor=1, expansions_per_iter=e,
            # the beam stops after ~ceil(ef/E) iterations; +8 covers
            # eviction-driven re-expansions
            max_iters=-(-r // e) + 8,
        )
        source = (dict(vectors=vectors) if pq is None
                  else dict(pq_decoded=pq["decoded"]))
        res = searcher_mod.search(
            adj, live_dev, entry, queries, params, simf,
            has_tombstones=self._has_tombstones, **source,
        )
        return res.ids, res.scores

    # -- adjacency application ----------------------------------------------

    @staticmethod
    def _edge_present(st: _DeviceAdj, ids_t: torch.Tensor,
                      sel: torch.Tensor) -> torch.Tensor:
        """[B, ms] bool: the row of `sel[b, j]` already holds `ids_t[b]`
        (a mutual selection: its reverse edge would be a duplicate)."""
        rows = st.adj[sel.clamp(min=0)]  # [B, ms, cap_deg]
        return (rows == ids_t[:, None, None]).any(-1) & (sel >= 0)

    def _compute_back_edges(self, deg, new_ids, selected, cap, present):
        """Host-side reverse-edge slot assignment (deterministic).

        Returns (dst, slot, src) fitting edges plus overflow prune work
        (overflow_ids, extras). Edges that don't fit become overflow-prune
        candidates, so the node chooses among (current neighbors ∪ new
        sources) instead of silently dropping them. `present` [B, ms] marks
        the edges whose destination row holds the source already
        (`_edge_present`): they are skipped, so no row gets a neighbour
        twice.
        """
        b, ms = selected.shape
        src = np.repeat(new_ids, ms)
        dst = selected.reshape(-1)
        keep = (dst >= 0) & ~present.reshape(-1)
        src, dst = src[keep], dst[keep]
        empty = (np.empty(0, np.int64),) * 3
        if dst.size == 0:
            return (*empty, np.empty(0, np.int64), np.empty((0, 0), np.int32))
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        group_start = np.searchsorted(dst, dst, side="left")
        rank = np.arange(dst.size) - group_start
        slot = deg[dst] + rank
        ok = slot < cap
        counts = np.bincount(dst, minlength=deg.shape[0])
        newdeg = np.minimum(deg + counts, cap)
        overflow_ids = np.unique(dst[newdeg[dst] >= cap])
        deg[:] = newdeg

        dropped = ~ok
        max_extra = self.extra_width  # bounds the overflow-prune C width
        extras = np.full((overflow_ids.size, max_extra), -1, np.int32)
        if dropped.any():
            ddst, dsrc = dst[dropped], src[dropped]
            dgs = np.searchsorted(ddst, ddst, side="left")
            drank = np.arange(ddst.size) - dgs
            sel_rows = np.searchsorted(overflow_ids, ddst)
            m = drank < max_extra
            extras[sel_rows[m], drank[m]] = dsrc[m]
        return dst[ok], slot[ok], src[ok], overflow_ids, extras

    def _prune_overflow(self, st: _DeviceAdj, node_ids, vectors, simf,
                        extras=None):
        """Re-prune `node_ids` to max_degree (rows written back) from their
        rows plus `extras` [len(node_ids), any width] (host array or device
        tensor, -1 padded).

        A node's prune reads only its own row and its extras, so chunking
        over `batch_size` nodes does not change the result."""
        if node_ids.size == 0:
            return
        dev = st.adj.device
        chunk = self.batch_size
        for s in range(0, node_ids.size, chunk):
            ids = node_ids[s: s + chunk]
            ids_t = torch.as_tensor(ids, device=dev)
            cand = st.adj[ids_t]
            if extras is not None and extras.shape[1]:
                ex = torch.as_tensor(extras[s: s + chunk], device=dev)
                cand = torch.cat([cand, ex.to(torch.int32)], dim=1)
            cand = cand.long()
            pvecs = vectors[ids_t].float()
            cvecs = vectors[cand.clamp(min=0)].float()
            scores = torch.where(
                cand >= 0, batched_candidate_scores(pvecs, cvecs, simf),
                NEG_INF)
            del cvecs
            sel = robust_prune(vectors, cand, scores, self.alpha,
                               self.max_degree, simf, point_ids=ids_t)
            st.write_rows(ids_t, sel)
            st.deg[ids] = (sel >= 0).sum(1).cpu().numpy()

    # -- insert round --------------------------------------------------------

    def _round_dispatch(self, st: _DeviceAdj, live_dev, entry, batch,
                        vectors, simf, pq=None):
        """Device half of an insert round: beam search, intra-round
        candidates, prune, forward rows + live mark. Returns the pending
        state for `_round_finish`."""
        dev = st.adj.device
        t0 = _phase_start()
        batch_t = torch.as_tensor(batch, device=dev)
        queries = vectors[batch_t].float()
        cand_ids, cand_scores = self._search_candidates(
            st.adj, live_dev, entry, vectors, queries, simf, pq)
        t0 = self._phase_end("search", t0, dev)
        b = batch.size
        top_r = min(b - 1, self.max_degree) if b > 1 else 0
        if top_r > 0:
            # intra-round candidates: the batch's own nearest members
            rr = pairwise_scores(queries, queries, simf)
            rr.fill_diagonal_(NEG_INF)
            rr_scores, rr_idx = torch.topk(rr, top_r, dim=1)
            del rr
            cand_ids = torch.cat([cand_ids, batch_t[rr_idx]], dim=1)
            cand_scores = torch.cat([cand_scores, rr_scores], dim=1)
        sel = robust_prune(vectors, cand_ids, cand_scores, self.alpha,
                           self.max_degree, simf, point_ids=batch_t)
        st.write_rows(batch_t, sel)
        live_dev[batch_t] = True
        self._phase_end("prune+fwd", t0, dev)
        return batch, sel

    def _round_finish(self, st: _DeviceAdj, pending, vectors, simf):
        """Host half of an insert round: fetch the prune output, compute
        reverse-edge slots, apply them, run overflow prunes."""
        new_ids, sel_dev = pending
        dev = sel_dev.device
        t0 = _phase_start()
        ids_t = torch.as_tensor(new_ids, device=dev)
        both = torch.stack([sel_dev,
                            self._edge_present(st, ids_t, sel_dev).long()])
        sel, present = both.cpu().numpy()  # one transfer
        t0 = self._phase_end("sel_fetch", t0, dev)
        st.deg[new_ids] = (sel >= 0).sum(axis=1)
        dst, slot, src, overflowed, extras = self._compute_back_edges(
            st.deg, new_ids, sel, self.overflow_degree, present.astype(bool))
        t0 = self._phase_end("backedges_host", t0, dev)
        st.write_edges(dst, slot, src)
        t0 = self._phase_end("apply", t0, dev)
        self._prune_overflow(st, overflowed, vectors, simf, extras=extras)
        self._phase_end("overflow", t0, dev)

    # -- public API --------------------------------------------------------

    def build(
        self,
        vectors: torch.Tensor,  # [N, d] on the build device, fp32 or bf16
        simf: SimilarityFunction,
        capacity: int | None = None,
        pq: dict | None = None,  # {"decoded": [N, d] bf16}: beam source
    ) -> VamanaGraph:
        """Fresh Vamana build over `vectors` (insertion in shuffled rounds).

        `capacity` (>= n) is rounded up to a power of two, the segment
        format's ordinal space. With `pq`, the insert rounds' beam
        candidates score from `pq["decoded"]`; prunes, bootstrap and
        cleanup score the fp32 rows. A bf16 `vectors` is the quantized
        build: it is the beam source too, and the prunes upcast the rows
        they gather."""
        n = int(vectors.shape[0])
        dev = vectors.device
        cap_deg = self.overflow_degree
        if n == 0:
            return VamanaGraph.empty(capacity or 0, cap_deg, dev)
        capacity = bucket_capacity(max(capacity or 0, n))
        source = vectors
        vectors = pad_rows(_build_rows(vectors), capacity)
        if pq is not None:
            # the quantized build passes its decoded rows as both: pad once
            pq = {"decoded": vectors if pq["decoded"] is source
                  else pad_rows(pq["decoded"], capacity)}

        st = _DeviceAdj(
            torch.full((capacity, cap_deg), -1, dtype=torch.int32,
                       device=dev),
            np.zeros((capacity,), np.int32),
        )
        live = np.zeros((capacity,), bool)
        live_dev = torch.zeros((capacity,), dtype=torch.bool, device=dev)
        self._has_tombstones = False

        # entry point: medoid approximation = nearest to the mean of the n
        # real rows (pad rows excluded)
        mean = torch.mean(vectors[:n], dim=0, keepdim=True,
                          dtype=torch.float32)
        escores = _scores_to_rows(mean, vectors, simf)
        escores[n:] = NEG_INF
        entry = int(torch.argmax(escores))

        rng = np.random.default_rng(self.seed)
        order = rng.permutation(n)
        # the entry must be in the bootstrap block: every round's beam
        # search starts there
        mpos = int(np.nonzero(order == entry)[0][0])
        order[[0, mpos]] = order[[mpos, 0]]
        b0 = min(n, max(self.max_degree + 1, min(1024, self.batch_size)))
        boot = order[:b0]
        self._bootstrap(st, boot, vectors, simf)
        live[boot] = True
        live_dev[torch.as_tensor(boot, device=dev)] = True

        # Round size ramps with graph size (a huge batch into a tiny graph
        # finds poor candidates). Pipelined: dispatch round k, then finish
        # round k-1, so reverse edges land one round late.
        pos = b0
        pending = None
        while pos < n:
            cur = min(self.batch_size, max(pos, 64))
            batch = order[pos: pos + cur]
            nxt = self._round_dispatch(st, live_dev, entry, batch, vectors,
                                       simf, pq)
            live[batch] = True
            if pending is not None:
                self._round_finish(st, pending, vectors, simf)
            pending = nxt
            pos += batch.size
            self.counters.rounds += 1
        if pending is not None:
            self._round_finish(st, pending, vectors, simf)
        self.counters.nodes_inserted += n

        graph = VamanaGraph(
            adjacency=st.adj,
            degrees=torch.as_tensor(st.deg, device=dev),
            live=torch.as_tensor(live, device=dev),
            entry=entry,
        )
        if self.refine_passes > 0:
            graph = self.refine_graph(graph, vectors, simf, pq,
                                      passes=self.refine_passes)
        return self.cleanup(graph, vectors, simf)

    def refine_graph(
        self,
        graph: VamanaGraph,
        vectors: torch.Tensor,
        simf: SimilarityFunction,
        pq: dict | None = None,
        passes: int = 1,
    ) -> VamanaGraph:
        """Second-pass refinement (DiskANN's two-pass build): re-search
        every live node over the finished graph, re-prune its list from
        (current neighbors ∪ the best 2 * max_degree fresh beam
        candidates), then re-apply reverse edges. The adjacency is updated
        in place."""
        dev = graph.adjacency.device
        st = _DeviceAdj(graph.adjacency, graph.degrees.cpu().numpy().copy())
        vectors = pad_rows(_build_rows(vectors), graph.capacity)
        if pq is not None:
            pq = {"decoded": pad_rows(pq["decoded"], graph.capacity)}
        ids_all = np.nonzero(graph.live.cpu().numpy())[0]
        rng = np.random.default_rng(self.seed + 1)
        for _ in range(passes):
            order = rng.permutation(ids_all)
            for s in range(0, order.size, self.batch_size):
                batch = order[s: s + self.batch_size]
                batch_t = torch.as_tensor(batch, device=dev)
                cand_ids, _ = self._search_candidates(
                    st.adj, graph.live, graph.entry, vectors,
                    vectors[batch_t].float(), simf, pq)
                self._prune_overflow(
                    st, batch, vectors, simf,
                    extras=cand_ids[:, : 2 * self.max_degree])
                sel = st.adj[batch_t][:, : self.max_degree].long()
                self._round_finish(st, (batch, sel), vectors, simf)
        return dataclasses.replace(
            graph, adjacency=st.adj,
            degrees=torch.as_tensor(st.deg, device=dev))

    def _delta_chunks(self, n: int) -> list[int]:
        """Round sizes of a delta insert: full `batch_size` rounds, then
        the remainder."""
        full, rem = divmod(int(n), self.batch_size)
        return [self.batch_size] * full + ([rem] if rem else [])

    def add_nodes(
        self,
        graph: VamanaGraph,
        vectors: torch.Tensor,  # full row storage covering new_ids
        new_ids: np.ndarray,
        simf: SimilarityFunction,
        pq: dict | None = None,  # {"decoded": bf16 rows}: beam source
    ) -> VamanaGraph:
        """Delta-insert `new_ids` into an existing graph (the incremental
        merge's append into the leading segment's graph). The input graph
        is left as it was."""
        dev = graph.adjacency.device
        st = _DeviceAdj(graph.adjacency.clone(),
                        graph.degrees.cpu().numpy().copy())
        live_dev = graph.live.clone()
        source = vectors
        vectors = pad_rows(_build_rows(vectors), graph.capacity)
        if pq is not None:
            pq = {"decoded": vectors if pq["decoded"] is source
                  else pad_rows(pq["decoded"], graph.capacity)}
        # tombstoned nodes that the loaded adjacency still references must
        # be masked out of the candidate pools: probed on the device, one
        # scalar read back
        adj = st.adj.long()
        self._has_tombstones = not bool(torch.all(
            (adj < 0) | live_dev[adj.clamp(min=0)]))
        del adj

        new_ids = np.asarray(new_ids)
        pos = 0
        pending = None
        for c in self._delta_chunks(new_ids.size):
            batch = new_ids[pos: pos + c]
            pos += c
            nxt = self._round_dispatch(st, live_dev, graph.entry, batch,
                                       vectors, simf, pq)
            if pending is not None:
                self._round_finish(st, pending, vectors, simf)
            pending = nxt
            self.counters.rounds += 1
        if pending is not None:
            self._round_finish(st, pending, vectors, simf)
        self.counters.nodes_inserted += new_ids.size
        return dataclasses.replace(
            graph, adjacency=st.adj,
            degrees=torch.as_tensor(st.deg, device=dev), live=live_dev)

    @staticmethod
    def mark_deleted(graph: VamanaGraph, ids: np.ndarray) -> VamanaGraph:
        """Tombstone nodes (folded into the adjacency at `cleanup`)."""
        live = graph.live.clone()
        live[torch.as_tensor(np.asarray(ids), dtype=torch.long,
                             device=live.device)] = False
        return dataclasses.replace(graph, live=live)

    def _bootstrap(self, st: _DeviceAdj, ids, vectors, simf):
        """All-pairs + prune over the first block (no graph to search)."""
        if len(ids) < 2:  # a single node has no candidates to prune
            return
        dev = st.adj.device
        ids_t = torch.as_tensor(ids, device=dev)
        v = vectors[ids_t].float()
        scores = pairwise_scores(v, v, simf)
        scores.fill_diagonal_(NEG_INF)
        cand_scores, idx = torch.topk(
            scores, min(len(ids) - 1, self.beam_width), dim=1)
        sel_t = robust_prune(vectors, ids_t[idx], cand_scores, self.alpha,
                             self.max_degree, simf, point_ids=ids_t)
        # forward rows, then reverse edges exactly like an insert round
        # (bidirectional links)
        st.write_rows(ids_t, sel_t)
        self._round_finish(st, (np.asarray(ids), sel_t), vectors, simf)

    def cleanup(self, graph: VamanaGraph, vectors: torch.Tensor,
                simf: SimilarityFunction) -> VamanaGraph:
        """Fold deletes in and enforce the degree bound (cleanup() parity).

        Dead neighbors are replaced by their own live neighbors (2-hop
        splice), every node that overflows or holds a neighbour twice is
        re-pruned to max_degree, a dead entry is replaced, and unreachable
        live nodes are linked in. The adjacency is updated in place."""
        dev = graph.adjacency.device
        t0 = _phase_start()
        st = _DeviceAdj(graph.adjacency, graph.degrees.cpu().numpy().copy())
        live = graph.live.cpu().numpy()
        live_dev = graph.live
        vectors = pad_rows(_build_rows(vectors), graph.capacity)

        adj = st.adj.long()
        has_dead = torch.any((adj >= 0) & ~live_dev[adj.clamp(min=0)], dim=1)
        del adj
        dead_nodes = np.nonzero(has_dead.cpu().numpy() & live)[0]
        t0 = self._phase_end("cleanup_fetch", t0, dev)
        if dead_nodes.size:
            width = st.cap_deg * (st.cap_deg + 1)
            chunk = max(64, min(self.batch_size, SPLICE_GATHER_BYTES
                                // (width * vectors.shape[1] * 4)))
            for s in range(0, dead_nodes.size, chunk):
                ids = dead_nodes[s: s + chunk]
                sel = self._splice_prune(st, torch.as_tensor(ids, device=dev),
                                         live_dev, vectors, simf)
                st.deg[ids] = (sel >= 0).sum(1).cpu().numpy()
        t0 = self._phase_end("cleanup_splice", t0, dev)

        # rows over the degree bound, and rows that hold a neighbour twice
        # (graphs written by the reference's builder can): the prune keeps
        # one occurrence
        srt = torch.sort(st.adj, dim=1).values
        has_dup = torch.any((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0),
                            dim=1).cpu().numpy()
        del srt
        over = np.nonzero((st.deg > self.max_degree) | (has_dup & live))[0]
        self._prune_overflow(st, over, vectors, simf)
        t0 = self._phase_end("cleanup_overflow", t0, dev)

        # entry repair: if the entry died, take the live node closest to
        # the mean of the live rows
        entry = int(graph.entry)
        if not live[entry] and live.any():
            lm = live_dev[:, None].float()
            mean = sum(torch.sum(blk * lm[lo: lo + blk.shape[0]], 0,
                                 keepdim=True)
                       for lo, blk in _float_blocks(vectors))
            mean = mean / torch.clamp(lm.sum(), min=1.0)
            s = _scores_to_rows(mean, vectors, simf)
            entry = int(torch.argmax(torch.where(live_dev, s, NEG_INF)))

        # reachability repair: overflow pruning can drop a node's only
        # in-path; link every unreachable live node from its nearest
        # reachable neighbor (3 passes is a safety bound)
        if live.any():
            for _ in range(3):
                if self._repair_orphans(st, live, vectors, simf, entry) == 0:
                    break
        self._phase_end("cleanup_orphans", t0, dev)

        upper = None
        if self.hierarchy_enabled:
            upper = self._build_upper_layer(vectors, live, entry, simf)
        return VamanaGraph(
            adjacency=st.adj,
            degrees=torch.as_tensor(st.deg, device=dev),
            live=torch.as_tensor(live, device=dev),
            entry=entry,
            upper_adjacency=upper,
        )

    def _build_upper_layer(self, vectors: torch.Tensor, live: np.ndarray,
                           entry: int, simf: SimilarityFunction):
        """Coarse hierarchy layer (hierarchy_enabled parity, HNSW-style).

        A Vamana graph over a sample of about 4*sqrt(n) live nodes (the
        entry included), expressed in the BASE ordinal space as a sparse
        full-height adjacency [capacity, m_up], so the same score providers
        drive both layers. The sample is the reference's host draw, so both
        packages pick the same members from the same live set. Rebuilt at
        every cleanup: it is orders of magnitude smaller than the base
        layer. None below 8 live nodes."""
        live_ids = np.nonzero(live)[0]
        n = live_ids.size
        if n < 8:
            return None
        rng = np.random.default_rng(self.seed + 7)
        s_size = min(n, max(64, int(4 * np.sqrt(n))))
        members = rng.choice(live_ids, s_size, replace=False)
        if entry not in members:
            members[0] = entry
        members = np.unique(members)
        m_up = min(16, self.max_degree)
        sub = GraphIndexBuilder(
            dim=self.dim, max_degree=m_up, beam_width=64, alpha=self.alpha,
            batch_size=min(self.batch_size, 1024), seed=self.seed + 11)
        dev = vectors.device
        members_t = torch.as_tensor(members, device=dev)
        sub_graph = sub.build(vectors[members_t].float(), simf)
        # the sub-build pads to its own capacity; only the first
        # len(members) rows are real nodes
        local = sub_graph.adjacency[: members.size, :m_up].long()
        translated = torch.where(local >= 0, members_t[local.clamp(min=0)],
                                 -1).to(torch.int32)
        upper = torch.full((live.shape[0], m_up), -1, dtype=torch.int32,
                           device=dev)
        upper[members_t] = translated
        return upper

    def _splice_prune(self, st: _DeviceAdj, ids: torch.Tensor,
                      live_dev: torch.Tensor, vectors: torch.Tensor,
                      simf: SimilarityFunction) -> torch.Tensor:
        """Replace dead neighbors with live 2-hop candidates and re-prune;
        rows are written back. Both sides are scored in float32."""
        rows = st.adj[ids].long()  # [B, cap]
        b, cap = rows.shape
        hop2 = st.adj[rows.clamp(min=0)].long().reshape(b, cap * cap)
        hop2 = torch.where((rows < 0).repeat_interleave(cap, dim=1), -1, hop2)
        cand = torch.cat([rows, hop2], dim=1)
        cand = torch.where(live_dev[cand.clamp(min=0)] & (cand >= 0), cand, -1)
        cand = torch.where(cand == ids[:, None], -1, cand)
        pvecs = vectors[ids].float()
        scores = batched_candidate_scores(
            pvecs, vectors[cand.clamp(min=0)].float(), simf)
        # one occurrence per id (sort + adjacent-equal), before the top-k
        order = torch.argsort(cand, dim=1, stable=True)
        sc = torch.gather(cand, 1, order)
        dup_sorted = torch.zeros_like(sc, dtype=torch.bool)
        dup_sorted[:, 1:] = (sc[:, 1:] == sc[:, :-1]) & (sc[:, 1:] >= 0)
        dup = torch.empty_like(dup_sorted).scatter_(1, order, dup_sorted)
        scores = torch.where((cand >= 0) & ~dup, scores, NEG_INF)
        # narrow to the best W candidates before the O(C^2) prune
        w = min(4 * self.max_degree, cand.shape[1])
        top_scores, top_idx = torch.topk(scores, w, dim=1)
        top_cand = torch.gather(cand, 1, top_idx)
        top_cand = torch.where(top_scores > NEG_INF, top_cand, -1)
        sel = robust_prune(vectors, top_cand, top_scores, self.alpha,
                           self.max_degree, simf, point_ids=ids)
        st.write_rows(ids, sel)
        return sel

    def _repair_orphans(self, st: _DeviceAdj, live, vectors, simf,
                        entry) -> int:
        """Link live nodes unreachable from `entry` from their nearest
        reachable neighbor. Returns the number of orphans repaired."""
        if not live[entry]:
            return 0
        dev = st.adj.device
        live_d = torch.as_tensor(live, device=dev)
        reach = _reachable(st.adj, live_d, entry).cpu().numpy()
        orphans = np.nonzero(live & ~reach)[0]
        if orphans.size == 0:
            return 0

        hostable = torch.as_tensor(live & reach, device=dev)
        host_of: dict[int, list[int]] = {}  # host -> its orphan group
        for s in range(0, orphans.size, 512):
            ob = orphans[s: s + 512]
            hosts = _nearest_hostable(torch.as_tensor(ob, device=dev),
                                      vectors, hostable, simf).cpu().numpy()
            for h, o in zip(hosts, ob):
                group = host_of.setdefault(int(h), [])
                if int(o) not in group:
                    group.append(int(o))

        # fetch only the rows the chained linking can touch
        need = np.unique(np.concatenate(
            [np.fromiter(host_of.keys(), np.int64, len(host_of)), orphans]))
        got = st.adj[torch.as_tensor(need, device=dev)].cpu().numpy()
        row_of = {int(nid): got[i] for i, nid in enumerate(need)}
        touched: dict[int, np.ndarray] = {}

        def _row(nid: int) -> np.ndarray:
            row = touched.get(nid)
            if row is None:
                row = row_of[nid].copy()
                touched[nid] = row
            return row

        def _link(src: int, dst: int) -> None:
            """One edge src -> dst: append below max_degree, else overwrite
            the tail slot (a single eviction per src)."""
            row = _row(src)
            if dst in row:
                return
            if st.deg[src] < self.max_degree:
                slot = int(st.deg[src])
                st.deg[src] += 1
            else:
                slot = self.max_degree - 1
            row[slot] = dst

        # CHAIN each host's orphan group: host -> o1 -> o2 -> ... so a whole
        # island costs the host one slot
        for h, group in host_of.items():
            _link(h, group[0])
            for prev, nxt in zip(group, group[1:]):
                _link(prev, nxt)
        if touched:
            hid = np.fromiter(touched.keys(), np.int64, len(touched))
            hrows = np.stack([touched[int(h)] for h in hid])
            st.adj[torch.as_tensor(hid, device=dev)] = torch.as_tensor(
                hrows, device=dev)
        return int(orphans.size)
