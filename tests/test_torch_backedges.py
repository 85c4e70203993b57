"""The graph build's reverse-edge slot assignment
(`GraphIndexBuilder._compute_back_edges`, torch on the build device)
against its plain numpy version, kept here as the reference.

Each case holds (dst, slot, src), the overflow ids, the extras and the
updated degrees exactly equal. A build, a delta insert and a cleanup with
the torch assignment give the adjacency, degrees, live mask and entry of
the same calls with the numpy assignment patched in, and the
`reverse_edges` / `overflow_nodes` counts of `BuildCounters`, and what a
flush and a merge publish of them, equal the reference's totals.
"""

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig
from opensearch_jvector_tpu_torch.api.stats import StatsRegistry
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy,
)
from opensearch_jvector_tpu_torch.models.builder import GraphIndexBuilder
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

torch.set_num_threads(2)


def reference_back_edges(deg, new_ids, selected, cap, present, max_extra):
    """The plain numpy assignment: `deg` (host int32) is updated in place;
    returns (dst, slot, src) of the fitting edges, the sorted overflow ids
    and their extras [len(overflow), max_extra] (-1 padded)."""
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
    extras = np.full((overflow_ids.size, max_extra), -1, np.int32)
    if dropped.any():
        ddst, dsrc = dst[dropped], src[dropped]
        dgs = np.searchsorted(ddst, ddst, side="left")
        drank = np.arange(ddst.size) - dgs
        sel_rows = np.searchsorted(overflow_ids, ddst)
        m = drank < max_extra
        extras[sel_rows[m], drank[m]] = dsrc[m]
    return dst[ok], slot[ok], src[ok], overflow_ids, extras


def _builder(extra_width=None):
    b = GraphIndexBuilder(dim=4, max_degree=16)
    if extra_width is not None:
        b.extra_width = extra_width
    return b


def assign(b, deg, new_ids, sel, cap, present):
    """The torch assignment on the inputs' device, cut to its counts:
    (dst, slot, src, overflow, extras) as numpy, and the degrees it left."""
    deg_t = torch.as_tensor(deg)
    out = b._compute_back_edges(deg_t, torch.as_tensor(new_ids),
                                torch.as_tensor(sel), cap,
                                torch.as_tensor(present))
    n_edges, n_over = out[-1].tolist()
    cut = [t[:n_edges] for t in out[:3]] + [out[3][:n_over], out[4][:n_over]]
    return (*(t.cpu().numpy() for t in cut), deg_t.cpu().numpy())


def random_round(rng, b, ms, capacity, cap, pad=0.2, present=0.0,
                 hot=None):
    """A round of `b` sources into `capacity` rows: destinations uniform
    (or over the first `hot` rows), a share `pad` of -1 pads, a share
    `present` of the edges marked present, degrees in [0, cap]."""
    deg = rng.integers(0, cap + 1, capacity).astype(np.int32)
    new_ids = rng.choice(capacity, b, replace=False).astype(np.int64)
    deg[new_ids] = 0
    sel = rng.integers(0, hot or capacity, (b, ms)).astype(np.int64)
    sel[rng.random((b, ms)) < pad] = -1
    pres = (rng.random((b, ms)) < present) & (sel >= 0)
    return deg, new_ids, sel, pres


CASES = {
    # (sources, width, capacity, cap, extra_width, round keywords)
    "random_pads": (256, 16, 4096, 19, 32, {}),
    "present_mask": (256, 16, 2048, 19, 32, {"present": 0.3}),
    "overflow": (512, 16, 1024, 19, 32, {"hot": 96}),
    "extra_width_cut": (300, 12, 2048, 14, 4, {"hot": 3, "pad": 0.0}),
    "empty_round": (64, 8, 512, 9, 16, {"pad": 1.0}),
    "all_present": (64, 8, 512, 9, 16, {"present": 1.0}),
    "insert_round": (16_384, 32, 1 << 19, 38, 32, {"pad": 0.05}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_assignment_equals_the_numpy_reference(case):
    b_n, ms, capacity, cap, width, kw = CASES[case]
    rng = np.random.default_rng(len(case))
    deg, new_ids, sel, present = random_round(rng, b_n, ms, capacity, cap,
                                              **kw)
    want_deg = deg.copy()
    want = reference_back_edges(want_deg, new_ids, sel, cap, present, width)
    got = assign(_builder(width), deg.copy(), new_ids, sel, cap, present)
    for w, g in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(g, w)
    if want[3].size:
        np.testing.assert_array_equal(got[4], want[4])
    else:
        assert got[4].size == 0
    np.testing.assert_array_equal(got[5], want_deg)
    if case == "empty_round" or case == "all_present":
        assert got[0].size == 0 and np.array_equal(got[5], deg)
    if case in ("overflow", "extra_width_cut"):
        assert want[3].size > 0 and (want[4] >= 0).any()
    if case == "extra_width_cut":
        # more dropped edges into one row than extras can carry
        assert (want[4] >= 0).all() and want[4].shape[1] == width


class NumpyAssignment:
    """`_compute_back_edges` in the torch layout, on the tensors' device,
    computed by the numpy reference; keeps the reference's totals."""

    def __init__(self):
        self.edges = self.overflow = 0

    def __call__(self, b, deg, new_ids, selected, cap, present):
        d = deg.cpu().numpy()
        dst, slot, src, over, extras = reference_back_edges(
            d, new_ids.cpu().numpy(), selected.cpu().numpy(), cap,
            present.cpu().numpy(), b.extra_width)
        deg.copy_(torch.as_tensor(d))
        self.edges += dst.size
        self.overflow += over.size
        ex = np.full((over.size, b.extra_width), -1, np.int32)
        ex[:, : extras.shape[1]] = extras
        out = (dst, slot, src, over, ex, np.array([dst.size, over.size]))
        return tuple(torch.as_tensor(a, device=deg.device) for a in out)

    def patch(self, monkeypatch):
        monkeypatch.setattr(GraphIndexBuilder, "_compute_back_edges",
                            lambda b, *args: self(b, *args))


def _rows(n, d=16, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((8, d)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


def _build_add_cleanup(b, rows, n, simf):
    g = b.build(rows[:n], simf, capacity=4096)
    g = b.add_nodes(g, rows, np.arange(n, rows.shape[0]), simf)
    return g, b.cleanup(b.mark_deleted(g, np.arange(0, n, 6)), rows, simf)


@pytest.mark.parametrize("simf,seed", [(SimilarityFunction.EUCLIDEAN, 1),
                                       (SimilarityFunction.COSINE, 2)],
                         ids=["euclidean", "cosine"])
def test_build_equals_the_numpy_assignment_build(simf, seed, monkeypatch):
    n = 2000
    rows = torch.from_numpy(_rows(n + 400, seed=seed))
    got_b = GraphIndexBuilder(dim=16, max_degree=10, beam_width=32,
                              batch_size=256)
    got = _build_add_cleanup(got_b, rows, n, simf)
    ref = NumpyAssignment()
    ref.patch(monkeypatch)
    want_b = GraphIndexBuilder(dim=16, max_degree=10, beam_width=32,
                               batch_size=256)
    want = _build_add_cleanup(want_b, rows, n, simf)
    for g, w in zip(got, want):
        assert torch.equal(g.adjacency, w.adjacency)
        assert torch.equal(g.degrees, w.degrees)
        assert g.degrees.dtype == w.degrees.dtype == torch.int32
        assert torch.equal(g.live, w.live) and g.entry == w.entry
    assert (got_b.counters.reverse_edges, got_b.counters.overflow_nodes) == (
        ref.edges, ref.overflow)
    assert ref.edges > 0 and ref.overflow > 0


def test_flush_and_merge_publish_the_reference_totals(monkeypatch, tmp_path):
    """`knn_graph_build_reverse_edges` / `_overflow_nodes` gain, over three
    flushes and then over the merge of their segments, what the numpy
    reference counts for the same builds."""
    per = 700
    rows = _rows(3 * per, seed=5)
    keys = ("knn_graph_build_reverse_edges", "knn_graph_build_overflow_nodes")

    def ingest(root, ref=None):
        reg = StatsRegistry()
        idx = VectorIndex(root, DiskAnnConfig(dim=16, m=12,
                                              ef_construction=48),
                          device="cpu", stats=reg,
                          merge_policy=ForceMergesOnlyMergePolicy())
        idx.writer.build_batch_size = 128
        snaps = [reg.snapshot()]
        for lo in range(0, 3 * per, per):
            idx.add_batch(np.arange(lo, lo + per), rows[lo: lo + per])
            idx.flush()
        snaps.append(reg.snapshot())
        at_flushes = None if ref is None else (ref.edges, ref.overflow)
        idx.force_merge()
        snaps.append(reg.snapshot())
        idx.close()
        gains = [tuple(b[k] - a[k] for k in keys)
                 for a, b in zip(snaps, snaps[1:])]
        return gains, at_flushes

    (flushes, merge), _ = ingest(tmp_path / "torch")
    ref = NumpyAssignment()
    ref.patch(monkeypatch)
    (ref_flushes, ref_merge), at_flushes = ingest(tmp_path / "numpy", ref)
    assert flushes == ref_flushes == at_flushes
    assert merge == ref_merge == (ref.edges - at_flushes[0],
                                  ref.overflow - at_flushes[1])
    assert min(flushes) > 0 and merge[0] > 0
