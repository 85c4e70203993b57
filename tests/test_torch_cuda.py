"""Card-only checks of the PyTorch port: the CUDA kernel against its plain
version, and the index path on a CUDA device against the same path on the
CPU. Every test here needs an NVIDIA GPU and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu_torch.api.config import DiskAnnConfig, SearchConfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import bf16_scores
from opensearch_jvector_tpu_torch.ops.adc import (
    adc_value_to_score,
    lookup_scan,
)
from opensearch_jvector_tpu_torch.ops.adc_kernel import (
    adc_scan,
    adc_scan_reference,
    kernel_error_bound,
    pick_group,
    prep_tables,
    prep_tables_reference,
)
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import (
    decode_scan,
    decode_scan_reference,
)
from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import (
    kernel_error_bound as decode_error_bound,
)
from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

pytestmark = pytest.mark.cuda
SETTING = "index.knn.advanced.scan_tier_max_codes"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# (Q, M, K, N): main-path shape (N cut), Q not a multiple of the query
# group, M not a multiple of 4 (byte-load path), K < 256, and the
# 2- and 1-query groups of wide M
KERNEL_SHAPES = [(512, 64, 256, 1 << 16), (3, 8, 64, 1000), (5, 6, 256, 777),
                 (7, 16, 100, 4097), (2, 192, 256, 4096), (3, 400, 256, 513)]


@pytest.mark.parametrize("shape", KERNEL_SHAPES, ids=str)
def test_adc_scan_kernel_matches_plain(shape, card):
    q, m, k, n = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    luts = 2.0 * torch.rand((q, m, k), generator=gen, device=card) - 0.5
    codes = torch.randint(0, k, (n, m), generator=gen, device=card,
                          dtype=torch.uint8)
    before = adc_scan.launches
    got = adc_scan(luts, codes)
    torch.cuda.synchronize()
    assert adc_scan.launches == before + 1
    err = (got - lookup_scan(luts, codes)).abs()
    assert bool((err <= kernel_error_bound(luts, codes)).all())


def test_adc_scan_code_slices_are_independent(card):
    """Scanning a row slice (the reader's blocked scan) equals slicing the
    full scan: no state leaks between launches or blocks."""
    gen = torch.Generator(device=card).manual_seed(1)
    luts = torch.rand((9, 32, 256), generator=gen, device=card)
    codes = torch.randint(0, 256, (10_000, 32), generator=gen, device=card,
                          dtype=torch.uint8)
    full = adc_scan(luts, codes)
    part = adc_scan(luts, codes[1234:7777])
    torch.testing.assert_close(part, full[:, 1234:7777], rtol=0, atol=0)


def test_adc_scan_rejects_inputs_the_kernel_does_not_take(card):
    luts = torch.rand((2, 8, 256), device=card)
    codes = torch.randint(0, 256, (100, 8), device=card, dtype=torch.uint8)
    bad = [
        (luts, codes.int()),  # int32 codes
        (luts.double(), codes),  # float64 tables
        (luts.transpose(0, 1).contiguous().transpose(0, 1), codes),
        (luts, codes[:, :4].contiguous()),  # subspace mismatch
        (torch.rand((2, 8, 300), device=card), codes),  # K > 256
        (luts.cpu(), codes),  # mixed devices never fall back
    ]
    for lt, cd in bad:
        with pytest.raises(ValueError):
            adc_scan(lt, cd)


@pytest.mark.parametrize("simf", list(SimilarityFunction),
                         ids=lambda s: s.name)
def test_adc_scan_fused_equals_raw_mapped_and_masked(simf, card):
    """The epilogue's score map and mask give exactly what the raw kernel
    followed by adc_value_to_score and the mask gives; masked rows are
    -inf. Also within the kernel's bound of the plain version."""
    gen = torch.Generator(device=card).manual_seed(4)
    q, m, k, n = 6, 64, 256, 5000
    luts = 2.0 * torch.rand((q, m, k), generator=gen, device=card)
    codes = torch.randint(0, k, (n, m), generator=gen, device=card,
                          dtype=torch.uint8)
    valid = torch.rand((n,), generator=gen, device=card) < 0.9
    before = adc_scan.launches
    fused = adc_scan(luts, codes, simf, valid)
    raw = adc_scan(luts, codes)
    torch.cuda.synchronize()
    assert adc_scan.launches == before + 2
    want = adc_value_to_score(raw, simf).masked_fill_(~valid[None, :],
                                                      float("-inf"))
    torch.testing.assert_close(fused, want, rtol=0, atol=0)
    assert bool(torch.isneginf(fused[:, ~valid]).all())
    assert bool(torch.isfinite(fused[:, valid]).all())
    # |map(a) - map(b)| <= |a - b| for sums >= 0 (both maps)
    plain = adc_scan_reference(luts, codes, simf, valid)
    err = (fused - plain)[:, valid].abs()
    assert bool((err <= kernel_error_bound(luts, codes)[:, valid]).all())


# (M, lo, hi): the main path's M from an aligned row (16-byte vectors), and
# M = 8 from an odd row, so the codes pointer is only 8-byte aligned (the
# narrower load variant)
@pytest.mark.parametrize("case", [(64, 1024, 7777), (8, 1235, 7777)],
                         ids=str)
def test_adc_scan_slices_are_independent_at_any_alignment(case, card):
    """A row slice, whatever its alignment, equals the full scan's columns
    exactly: every sum runs over m = 0 .. M-1 in order."""
    m, lo, hi = case
    gen = torch.Generator(device=card).manual_seed(5)
    luts = torch.rand((9, m, 256), generator=gen, device=card)
    codes = torch.randint(0, 256, (10_000, m), generator=gen, device=card,
                          dtype=torch.uint8)
    valid = torch.rand((10_000,), generator=gen, device=card) < 0.9
    full = adc_scan(luts, codes, SimilarityFunction.EUCLIDEAN, valid)
    part = adc_scan(luts, codes[lo:hi], SimilarityFunction.EUCLIDEAN,
                    valid[lo:hi])
    torch.testing.assert_close(part, full[:, lo:hi], rtol=0, atol=0)


@pytest.mark.parametrize("q", [1, 2, 3, 5])
def test_adc_scan_ragged_query_counts(q, card):
    """Q = 1 and 2 take groups of 1 and 2; 3 and 5 leave slots of a group
    of 4 empty."""
    assert pick_group(64, q) == {1: 1, 2: 2}.get(q, 4)
    gen = torch.Generator(device=card).manual_seed(q)
    luts = 2.0 * torch.rand((q, 64, 256), generator=gen, device=card) - 0.5
    codes = torch.randint(0, 256, (3001, 64), generator=gen, device=card,
                          dtype=torch.uint8)
    got = adc_scan(luts, codes)
    torch.cuda.synchronize()
    err = (got - lookup_scan(luts, codes)).abs()
    assert bool((err <= kernel_error_bound(luts, codes)).all())


# (Q, M, K, group): the cell's tables, ragged Q and K < 256 at each group
@pytest.mark.parametrize("case", [(512, 64, 256, 4), (5, 8, 100, 4),
                                  (3, 16, 256, 2), (1, 64, 77, 1)], ids=str)
def test_adc_prep_layout_matches_plain(case, card):
    q, m, k, group = case
    gen = torch.Generator(device=card).manual_seed(6)
    luts = torch.randn((q, m, k), generator=gen, device=card)
    got = prep_tables(luts, group)
    want = prep_tables_reference(luts, group)
    assert got.shape == want.shape == (-(-q // group), m, 256, group)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# (Q, N, M, K, dsub): the on_disk cell's widths (N cut), ragged Q and N
# with odd dsub and K < 256, Q = 1, dsub = 2 (the 128-d schedule), the
# JAX kernel test's Q > 128 shape, one query past an m16 tile and past
# the 128-query block tile, the crossover's Q = 64 at the cell's widths,
# odd N with dsub = 15, M = 200 (above the M the kernel stages in shared
# memory: codes read from global memory) and odd M (codes staged a byte
# at a time)
DECODE_SHAPES = [(512, 1 << 16, 64, 256, 15), (3, 1000, 8, 64, 21),
                 (1, 777, 64, 256, 2), (7, 300, 64, 256, 2),
                 (130, 1030, 12, 256, 16), (17, 1000, 16, 256, 4),
                 (129, 2048, 32, 200, 7), (64, 1 << 14, 64, 256, 15),
                 (5, 1003, 64, 256, 15), (5, 1003, 200, 256, 3),
                 (9, 1001, 7, 256, 3)]


@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=str)
def test_decode_scan_kernel_matches_plain(shape, card):
    q, n, m, k, dsub = shape
    gen = torch.Generator(device=card).manual_seed(sum(shape))
    q_c = torch.randn((q, m * dsub), generator=gen, device=card)
    codes = torch.randint(0, k, (n, m), generator=gen, device=card,
                          dtype=torch.uint8)
    cb = torch.randn((m, k, dsub), generator=gen, device=card)
    before = decode_scan.launches
    got = decode_scan(q_c, codes, cb)
    torch.cuda.synchronize()
    assert decode_scan.launches == before + 1
    err = (got - decode_scan_reference(q_c, codes, cb)).abs()
    assert bool((err <= decode_error_bound(q_c, codes, cb)).all())


# (M, dsub, lo, hi): the cell's widths; M = 8 from an odd row, so the
# codes pointer is only 8-byte aligned
@pytest.mark.parametrize("case", [(64, 15, 1234, 3777), (8, 16, 1235, 3777)],
                         ids=str)
def test_decode_scan_code_slices_are_independent(case, card):
    """Scanning a row slice equals slicing the full scan exactly: every
    element is summed in the same order wherever its row sits."""
    m, dsub, lo, hi = case
    gen = torch.Generator(device=card).manual_seed(2)
    q_c = torch.randn((9, m * dsub), generator=gen, device=card)
    codes = torch.randint(0, 256, (5000, m), generator=gen, device=card,
                          dtype=torch.uint8)
    cb = torch.randn((m, 256, dsub), generator=gen, device=card)
    full = decode_scan(q_c, codes, cb)
    part = decode_scan(q_c, codes[lo:hi], cb)
    torch.testing.assert_close(part, full[:, lo:hi], rtol=0, atol=0)


# every ragged edge of the kernel's 256-query x 128-row tile: Q and N one
# below, at and one past the tile's m64 and 256-query sizes and its
# 128-row / 256-row steps, N = 1, at the widths of the GIST cell (M = 64,
# dsub = 15, odd: pairs straddle subspaces) and of the 128-d schedule
# (dsub = 2)
@pytest.mark.parametrize("dsub", [2, 15])
@pytest.mark.parametrize("n", [1, 255, 4097])
@pytest.mark.parametrize("q", [1, 63, 64, 255, 256, 257, 512])
def test_decode_scan_ragged_tiles_match_plain(q, n, dsub, card):
    gen = torch.Generator(device=card).manual_seed(q * 7919 + n * 31 + dsub)
    q_c = torch.randn((q, 64 * dsub), generator=gen, device=card)
    codes = torch.randint(0, 256, (n, 64), generator=gen, device=card,
                          dtype=torch.uint8)
    cb = torch.randn((64, 256, dsub), generator=gen, device=card)
    got = decode_scan(q_c, codes, cb)
    torch.cuda.synchronize()
    assert got.shape == (q, n) and bool(torch.isfinite(got).all())
    err = (got - decode_scan_reference(q_c, codes, cb)).abs()
    assert bool((err <= decode_error_bound(q_c, codes, cb)).all())


def test_decode_scan_repeat_launches_are_identical(card):
    """Two launches on the same inputs give the same bits: no atomics,
    and the summation order does not depend on scheduling."""
    gen = torch.Generator(device=card).manual_seed(5)
    q_c = torch.randn((512, 64 * 15), generator=gen, device=card)
    codes = torch.randint(0, 256, (1 << 16, 64), generator=gen, device=card,
                          dtype=torch.uint8)
    cb = torch.randn((64, 256, 15), generator=gen, device=card)
    first = decode_scan(q_c, codes, cb)
    second = decode_scan(q_c, codes, cb)
    assert torch.equal(first, second)


def test_decode_scan_rejects_inputs_the_kernel_does_not_take(card):
    q_c = torch.randn((4, 64), device=card)
    codes = torch.randint(0, 256, (100, 8), device=card, dtype=torch.uint8)
    cb = torch.randn((8, 256, 8), device=card)
    bad = [
        (q_c.double(), codes, cb),  # float64 queries
        (q_c, codes.int(), cb),  # int32 codes
        (q_c, codes, cb.bfloat16()),  # bf16 codebooks
        (q_c.t().contiguous().t(), codes, cb),  # non-contiguous queries
        (q_c, codes.t().contiguous().t(), cb),  # non-contiguous codes
        (q_c[:, :60].contiguous(), codes, cb),  # d != M * dsub
        (q_c, codes, torch.randn((8, 300, 8), device=card)),  # K > 256
        (q_c.cpu(), codes, cb),  # mixed devices never fall back
    ]
    for args in bad:
        with pytest.raises(ValueError):
            decode_scan(*args)


def _latent(rng, n, d=32):
    a = rng.standard_normal((16, d)) / 4.0
    return (rng.standard_normal((n, 16)) @ a
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, 6000), _latent(rng, 64)


@pytest.mark.parametrize("beam", [False, True], ids=["scan", "beam"])
def test_index_on_card_reaches_recall_and_matches_cpu(beam, card, corpus,
                                                      tmp_path):
    """Build and search on the card; the CPU opens the same directory and
    agrees; both meet the recall band."""
    vectors, queries = corpus
    idx = VectorIndex(tmp_path, DiskAnnConfig(dim=32, num_pq_subspaces=16),
                      device=card)
    for lo in (0, 3000):
        idx.add_batch(np.arange(lo, lo + 3000), vectors[lo: lo + 3000])
        idx.flush()
    launches = adc_scan.launches
    GLOBAL_SETTINGS.put(SETTING, 0 if beam else -1)
    try:
        got = idx.search(queries, SearchConfig(k=10))
        cpu = VectorIndex(tmp_path, device="cpu").search(
            queries, SearchConfig(k=10))
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
    assert (adc_scan.launches > launches) != beam
    truth = ground_truth_topk(torch.from_numpy(queries),
                              torch.from_numpy(vectors), 10,
                              SimilarityFunction.EUCLIDEAN)
    assert recall_at_k(got.doc_ids, truth, 10) >= 0.95
    assert recall_at_k(got.doc_ids, cpu.doc_ids, 10) >= 0.99
    same = got.doc_ids == cpu.doc_ids
    np.testing.assert_allclose(got.scores[same], cpu.scores[same], rtol=1e-4,
                               atol=1e-6)


def test_bf16_scores_on_card_match_cpu(card):
    """The decoded-cache rung's product: one bf16 matmul with a float32
    result on the card, the upcast matmul on the CPU; both sum exact
    products in float32, so they differ only by summation order."""
    gen = torch.Generator().manual_seed(3)
    qb = torch.randn((37, 960), generator=gen).bfloat16()
    rows = torch.randn((5000, 960), generator=gen).bfloat16()
    want = bf16_scores(qb, rows)
    got = bf16_scores(qb.to(card), rows.to(card))
    assert got.dtype == torch.float32 and got.shape == (37, 5000)
    bound = 2.0 ** -12 * (qb.float().abs() @ rows.float().abs().T)
    assert bool(((got.cpu() - want).abs() <= bound).all())


def test_breaker_reads_device_memory(card):
    total, in_use = BREAKER.device_memory(card)
    assert total > 0 and 0 <= in_use <= total
    BREAKER.check(1 << 20, card)


def test_on_disk_codes_only_on_card_matches_cpu(card, corpus, tmp_path,
                                                monkeypatch):
    """A flat on_disk index searched on the card with the decoded cache
    refused: a 512-query batch takes decode_scan, an 8-query batch
    adc_scan; the CPU agrees on the same directory."""
    vectors, queries = corpus
    big = np.concatenate([queries] * 8)  # 512 queries
    idx = VectorIndex(tmp_path, DiskAnnConfig(
        dim=32, num_pq_subspaces=16, mode="on_disk", index_type="flat"),
        device=card)
    idx.add_batch(np.arange(vectors.shape[0]), vectors)
    idx.flush()
    reader = idx._reader(idx.segment_names[0])
    total = torch.cuda.mem_get_info(card)[1]
    # budget = in use + 128 KiB: codes_sq (32 KiB) fits, the 512 KiB
    # decoded cache does not
    in_use = BREAKER.device_memory(card)[1]
    monkeypatch.setattr(BREAKER, "device_memory",
                        lambda dev: (total, in_use))
    GLOBAL_SETTINGS.put("knn.memory.circuit_breaker.limit",
                        100.0 * (in_use + (128 << 10)) / total)
    try:
        fused, lut = decode_scan.launches, adc_scan.launches
        got = idx.search(big, SearchConfig(k=10))
        assert decode_scan.launches == fused + 1
        small = idx.search(queries[:8], SearchConfig(k=10))
        assert adc_scan.launches > lut
    finally:
        GLOBAL_SETTINGS.put("knn.memory.circuit_breaker.limit", 50.0)
    assert reader._pq_decoded is None
    assert reader.seg.row_store.is_native
    cpu = VectorIndex(tmp_path, device="cpu")
    for res, qs in ((got, big), (small, queries[:8])):
        want = cpu.search(qs, SearchConfig(k=10))
        assert recall_at_k(res.doc_ids, want.doc_ids, 10) >= 0.99
    truth = ground_truth_topk(torch.from_numpy(queries),
                              torch.from_numpy(vectors), 10,
                              SimilarityFunction.EUCLIDEAN)
    assert recall_at_k(got.doc_ids[:64], truth, 10) >= 0.95


def test_on_disk_reused_rerank_buffer_on_card_answers_as_fresh(
        card, corpus, tmp_path, monkeypatch):
    """The on_disk rerank gathers into its thread's reused block buffer:
    batches of 1, 64 (grown) and 7 queries (reused) answer bit for bit as
    the same reader does with a fresh block each batch."""
    vectors, queries = corpus
    idx = VectorIndex(tmp_path, DiskAnnConfig(
        dim=32, num_pq_subspaces=16, mode="on_disk", index_type="flat"),
        device=card)
    idx.add_batch(np.arange(vectors.shape[0]), vectors)
    idx.flush()
    sc = SearchConfig(k=10)
    reader = idx._reader(idx.segment_names[0])
    assert reader.seg.row_store.is_native
    got = [idx.search(queries[:q], sc) for q in (1, 64, 7)]
    assert reader._rerank_blocks.buf.size == 64 * 50 * 32
    monkeypatch.setattr(type(reader), "_rerank_buffer",
                        lambda self, size: np.empty(size, np.float32))
    for res, q in zip(got, (1, 64, 7)):
        want = idx.search(queries[:q], sc)
        assert res.doc_ids.tobytes() == want.doc_ids.tobytes()
        assert res.scores.tobytes() == want.scores.tobytes()


def test_adc_scan_valid_mask_follows_a_delete_on_card(card, corpus, tmp_path):
    """`delete` changes a segment's tombstones at run time: the next scan
    launches the kernel with the new fused `valid` mask, the deleted docs
    are gone, and the CPU agrees on the same directory."""
    vectors, queries = corpus
    idx = VectorIndex(tmp_path, DiskAnnConfig(dim=32, num_pq_subspaces=16),
                      device=card)
    idx.add_batch(np.arange(3000), vectors[:3000])
    idx.flush()
    sc = SearchConfig(k=10)
    first = idx.search(queries, sc)
    doomed = np.unique(first.doc_ids[:, :3])
    reader = idx._reader(idx.segment_names[0])
    assert reader._accept_cache[1] is None  # no tombstones: the live mask
    launches = adc_scan.launches
    idx.delete(doomed)
    assert idx.has_deletes
    got = idx.search(queries, sc)
    assert adc_scan.launches == launches + 1
    mask = reader._accept_cache[1]
    assert mask.is_cuda and int((~mask[:3000]).sum()) == doomed.size
    assert not np.isin(got.doc_ids, doomed).any()
    assert (got.doc_ids >= 0).all()
    idx.search(queries, sc)
    assert reader._accept_cache[1] is mask  # kept until the tombstones change
    cpu = VectorIndex(tmp_path, device="cpu").search(queries, sc)
    assert recall_at_k(got.doc_ids, cpu.doc_ids, 10) >= 0.99
    keep = np.setdiff1d(np.arange(3000), doomed)
    truth = keep[ground_truth_topk(torch.from_numpy(queries),
                                   torch.from_numpy(vectors[keep]), 10,
                                   SimilarityFunction.EUCLIDEAN)]
    assert recall_at_k(got.doc_ids, truth, 10) >= 0.95


def test_delete_merge_and_search_from_two_threads_on_card(card, corpus,
                                                          tmp_path):
    """A background merge (torch ops from the merge pool's thread) while
    two threads search (both kernels' launchers share the default stream
    and the launch counters): every answer is valid for the segment set it
    started from, no deleted doc comes back, and the counters add up."""
    import threading

    vectors, queries = corpus
    idx = VectorIndex(tmp_path, DiskAnnConfig(dim=32, num_pq_subspaces=16),
                      device=card)
    per = 1200  # above the minimum batch: PQ segments, so the scan tier
    for f in range(4):
        idx.add_batch(np.arange(f * per, (f + 1) * per),
                      vectors[f * per: (f + 1) * per])
        idx.flush()
    doomed = np.arange(0, 4 * per, 40)
    idx.delete(doomed)
    sc = SearchConfig(k=10)
    idx.search(queries, sc)  # opens the readers
    keep = np.setdiff1d(np.arange(5 * per), doomed)
    truth = keep[ground_truth_topk(torch.from_numpy(queries),
                                   torch.from_numpy(vectors[keep]), 10,
                                   SimilarityFunction.EUCLIDEAN)]
    rounds, failures, scans = 12, [], [0, 0]
    start = adc_scan.launches

    def searcher(slot):
        try:
            for _ in range(rounds):
                n_seg = len(idx.segment_names)
                res = idx.search(queries, sc)
                scans[slot] += 1
                assert not np.isin(res.doc_ids, doomed).any()
                assert (res.doc_ids >= 0).all()
                assert n_seg in (2, 5)
        except BaseException as e:  # noqa: BLE001 - reported by the test
            failures.append(e)

    idx.add_batch(np.arange(4 * per, 5 * per), vectors[4 * per: 5 * per])
    idx.flush()  # the fifth segment: a merge of four starts
    threads = [threading.Thread(target=searcher, args=(s,)) for s in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    idx.await_merges(timeout=600)
    assert not failures, failures
    assert scans == [rounds, rounds]
    # one launch per scanned segment and search: between 2 and 5 each
    launched = adc_scan.launches - start
    assert 2 * 2 * rounds <= launched <= 5 * 2 * rounds
    assert sorted(idx.segment_names) == ["merged_4segs_m1",
                                         "seg_000004_1200"]
    assert idx.doc_count() == keep.size and not idx.has_deletes
    got = idx.search(queries, sc)
    assert recall_at_k(got.doc_ids, truth, 10) >= 0.95
    cpu = VectorIndex(tmp_path, device="cpu").search(queries, sc)
    assert recall_at_k(got.doc_ids, cpu.doc_ids, 10) >= 0.99
    idx.close()
    assert idx._pins == {} and idx._retired == set()


# -- the other quantizers, anisotropic PQ and the hierarchy layer ----------------

def test_nvq_transcode_on_card_matches_cpu(card):
    """NVQ fit + encode and decode on CUDA tensors against the same on the
    CPU: the device compiler may fuse a multiply-add the CPU keeps apart,
    so the same grid point for >= 99 % of the subvectors and there bytes
    equal on >= 99.9 % of the elements, never more than 1 apart; the
    decode of given bytes within 2e-5 of the largest magnitude."""
    from opensearch_jvector_tpu_torch.ops import nvq as nvq_ops

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3000, 64))
         * rng.uniform(0.2, 3.0, (1, 64))).astype(np.float32)
    x -= x.mean(0)
    cb, cp = nvq_ops.nvq_encode(torch.from_numpy(x), 4)
    gb, gp = nvq_ops.nvq_encode(torch.from_numpy(x).to(card), 4)
    assert gb.device.type == "cuda" and gb.dtype == torch.uint8
    gb, gp = gb.cpu(), gp.cpu()
    assert torch.equal(gp[..., 2:], cp[..., 2:])  # min, max
    same = (gp[..., :2] == cp[..., :2]).all(-1)
    assert same.float().mean() >= 0.99
    diff = (gb.int() - cb.int()).abs()[same.repeat_interleave(16, 1)]
    assert (diff == 0).float().mean() >= 0.999 and int(diff.max()) <= 1
    mean = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    want = nvq_ops.nvq_decode(cb, cp, mean, 4)
    got = nvq_ops.nvq_decode(cb.to(card), cp.to(card), mean.to(card), 4).cpu()
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_scalar_codes_and_hamming_on_card_match_cpu(bits, card):
    """Bit packing and XOR + popcount are integer work: exact."""
    from opensearch_jvector_tpu_torch.models import scalar
    from opensearch_jvector_tpu_torch.ops.distances import hamming_scores

    x = np.random.default_rng(bits).standard_normal((5000, 50)).astype(
        np.float32)
    state = scalar.train_scalar_quantizer(x, bits)
    on_card = scalar.train_scalar_quantizer(torch.from_numpy(x).to(card),
                                            bits)
    np.testing.assert_array_equal(on_card.thresholds, state.thresholds)
    want = scalar.quantize_vectors(state, torch.from_numpy(x))
    got = scalar.quantize_vectors(state, torch.from_numpy(x).to(card))
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    q = want[:7].unsqueeze(1)
    rows = want[:700].reshape(7, 100, -1)
    assert torch.equal(hamming_scores(q.to(card), rows.to(card)).cpu(),
                       hamming_scores(q, rows))


def test_aniso_lloyd_step_on_card_matches_cpu(card):
    """One anisotropic Lloyd step (one-hot products and a batched solve)
    from shared centroids: rtol 1e-3 / atol 1e-4 (the card's matmuls sum
    in another order than the CPU's); the anisotropic encode: codes equal
    on >= 99.5 %."""
    from opensearch_jvector_tpu_torch.models import pq
    from opensearch_jvector_tpu_torch.ops import kmeans

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 4000, 8)).astype(np.float32))
    c = x[:, :64].clone() + 0.01
    want = kmeans._lloyd_iter_aniso(x, c, 3.7)
    got = kmeans._lloyd_iter_aniso(x.to(card), c.to(card), 3.7).cpu()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)
    state = pq.ProductQuantization(codebooks=want, center=torch.zeros(32),
                                   aniso_eta=3.7)
    rows = x.transpose(0, 1).reshape(4000, 32)
    codes = pq.encode_pq(state, rows)
    on_card = pq.encode_pq(pq.ProductQuantization(
        codebooks=want.to(card), center=torch.zeros(32, device=card),
        aniso_eta=3.7), rows.to(card)).cpu()
    assert (codes == on_card).float().mean() >= 0.995


@pytest.mark.parametrize("step", ["lloyd", "lloyd_aniso", "train_pq"])
def test_kmeans_on_card_is_deterministic(step, card):
    """The same inputs and seed give the same bits on a second run: the
    cluster sums are one-hot products, not atomic adds."""
    from opensearch_jvector_tpu_torch.models import pq
    from opensearch_jvector_tpu_torch.ops import kmeans

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((8, 20000, 4)).astype(
        np.float32)).to(card)
    c = x[:, :256].clone() + 0.01

    def run():
        if step == "lloyd":
            return kmeans._lloyd_iter(x, c)
        if step == "lloyd_aniso":
            return kmeans._lloyd_iter_aniso(x, c, 3.7)
        rows = x.transpose(0, 1).reshape(20000, 32)
        return pq.train_pq(rows, SimilarityFunction.EUCLIDEAN,
                           num_subspaces=8).codebooks

    first = run()
    assert torch.equal(first, run())


QUANT_MODES = {
    "nvq": dict(quantization_type="nvq+pq"),
    "nvq_on_disk": dict(quantization_type="nvq+pq", mode="on_disk"),
    "1bit": dict(quantization_type="1bit"),
    "4bit": dict(quantization_type="4bit"),
    "aniso": dict(pq_anisotropic_threshold=0.5,
                  similarity=SimilarityFunction.DOT_PRODUCT),
    "hierarchy": dict(hierarchy_enabled=True),
}


@pytest.mark.parametrize("beam", [False, True], ids=["scan", "beam"])
@pytest.mark.parametrize("mode", list(QUANT_MODES))
def test_quantizer_index_on_card_matches_cpu(mode, beam, card, corpus,
                                             tmp_path):
    """Build on the card, search there and on the CPU over the same
    directory: the same answers (recall of one against the other >= 0.99,
    scores of shared ids rtol 1e-4), each within the mode's recall floor;
    then a delete and a force_merge on the card."""
    vectors, queries = corpus
    cfg = DiskAnnConfig(dim=32, num_pq_subspaces=16, **QUANT_MODES[mode])
    idx = VectorIndex(tmp_path, cfg, device=card)
    for lo in (0, 3000):
        idx.add_batch(np.arange(lo, lo + 3000), vectors[lo: lo + 3000])
        idx.flush()
    sc = SearchConfig(k=10, overquery_factor=10)
    launches = adc_scan.launches
    GLOBAL_SETTINGS.put(SETTING, 0 if beam else -1)
    try:
        got = idx.search(queries, sc)
        cpu = VectorIndex(tmp_path, device="cpu").search(queries, sc)
        if mode in ("aniso", "hierarchy"):  # PQ segments: the ADC scan tier
            assert (adc_scan.launches > launches) != beam
        else:
            assert adc_scan.launches == launches
        assert (got.expanded > 0) == (beam or mode in ("1bit", "4bit"))
        assert got.reranked > 0 or (beam and mode in ("aniso", "hierarchy"))
        truth = ground_truth_topk(torch.from_numpy(queries),
                                  torch.from_numpy(vectors), 10,
                                  cfg.similarity)
        # one bit a dimension: 32 bits of signal a row
        floor = 0.4 if mode == "1bit" else 0.9
        assert recall_at_k(got.doc_ids, truth, 10) >= floor
        assert recall_at_k(got.doc_ids, cpu.doc_ids, 10) >= 0.99
        same = got.doc_ids == cpu.doc_ids
        np.testing.assert_allclose(got.scores[same], cpu.scores[same],
                                   rtol=1e-4, atol=1e-6)
        doomed = np.arange(0, 6000, 7)
        idx.delete(doomed)
        merged = idx.force_merge()
        seg = idx._reader(merged).seg
        assert seg.device.type == "cuda"
        assert seg.quantization_type == QUANT_MODES[mode].get(
            "quantization_type", "pq")
        after = idx.search(queries, sc)
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
    assert not np.isin(after.doc_ids, doomed).any()
    keep = np.setdiff1d(np.arange(6000), doomed)
    truth = keep[ground_truth_topk(torch.from_numpy(queries),
                                   torch.from_numpy(vectors[keep]), 10,
                                   cfg.similarity)]
    assert recall_at_k(after.doc_ids, truth, 10) >= floor - 0.1
    idx.close()


def test_rest_service_on_card_answers_as_the_inprocess_search(card,
                                                              tmp_path):
    """KnnService(device="cuda") over a 20,000-row index built in process:
    `_search` (single vector, micro-batched, and the 2-D batched body)
    answers with the in-process search's ids and scores, through the
    adc_scan kernel."""
    import http.client
    import json

    from opensearch_jvector_tpu_torch.service.http import KnnService

    rng = np.random.default_rng(5)
    vectors, queries = _latent(rng, 20_000), _latent(rng, 8)
    idx = VectorIndex(tmp_path / "svc" / "docs" / "vec",
                      DiskAnnConfig(dim=32), device=card)
    idx.add_batch(np.arange(20_000), vectors)
    idx.flush()
    want = idx.search(queries, SearchConfig(k=10))
    want_one = idx.search(queries[:1], SearchConfig(k=10))
    idx.close()
    svc = KnnService(tmp_path / "svc", device=card)
    svc.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", svc.port, timeout=120)

        def post(path, body):
            conn.request("POST" if body is not None else "PUT", path,
                         json.dumps(body or {"mappings": {"properties": {
                             "vec": {"type": "knn_vector",
                                     "dimension": 32}}}}))
            r = conn.getresponse()
            return r.status, json.loads(r.read())

        assert post("/docs", None)[0] == 200  # attaches the directory
        launches = adc_scan.launches
        st, one = post("/docs/_search", {"query": {"knn": {"vec": {
            "vector": queries[0].tolist(), "k": 10}}}})
        st2, many = post("/docs/_search", {"query": {"knn": {"vec": {
            "vector": queries.tolist(), "k": 10}}}})
        assert st == st2 == 200
        assert adc_scan.launches > launches
        got = [one["hits"]] + [r["hits"] for r in many["responses"]]
        rows = [(want_one, 0)] + [(want, r) for r in range(len(queries))]
        for hits, (res, r) in zip(got, rows, strict=True):
            assert [h["_id"] for h in hits["hits"]] == res.doc_ids[r].tolist()
            np.testing.assert_allclose([h["_score"] for h in hits["hits"]],
                                       res.scores[r], rtol=0, atol=1e-6)
        conn.close()
    finally:
        svc.stop()
        svc.manager.close()


@pytest.mark.parametrize("mode", ["in_memory", "on_disk"])
def test_mesh_on_card_matches_cpu(mode, card, corpus, tmp_path):
    """One 3-shard segment set (two segments a shard, some deletes),
    opened with its shards placed on a mesh of cuda:0 x 3 and of cpu x 3:
    every shard and segment on its mesh device, the same docs (recall of
    one against the other >= 0.99) and scores where the docs agree; the
    on_disk set reranks on the host either way."""
    from opensearch_jvector_tpu_torch.parallel.distributed import (
        ShardedVectorIndex,
    )

    vectors, queries = corpus
    cfg = DiskAnnConfig(dim=32, num_pq_subspaces=16, mode=mode,
                        min_batch_size_for_quantization=256)
    idx = ShardedVectorIndex(tmp_path, cfg, n_shards=3, device="cpu")
    for lo in (0, 3000):
        idx.add_batch(np.arange(lo, lo + 3000), vectors[lo: lo + 3000])
        idx.flush()
    idx.delete(np.arange(0, 6000, 50))
    idx.close()
    out = {}
    for dev in ("cpu", card):
        place = torch.device("cpu" if dev == "cpu" else "cuda:0")
        # the coordinator on the CPU: the shards go where the mesh says
        sidx = ShardedVectorIndex(tmp_path, device="cpu", mesh=[place] * 3)
        out[str(dev)] = sidx.search(queries, SearchConfig(k=10))
        assert sidx.mesh == [place] * 3
        for shard in sidx.shards:
            assert shard.device == place
            assert {shard._reader(n).seg.device
                    for n in shard.segment_names} == {place}
        sidx.close()
    cpu, got = out["cpu"], out[str(card)]
    assert not np.isin(got.doc_ids, np.arange(0, 6000, 50)).any()
    assert recall_at_k(got.doc_ids, cpu.doc_ids, 10) >= 0.99
    same = got.doc_ids == cpu.doc_ids
    np.testing.assert_allclose(got.scores[same], cpu.scores[same], rtol=1e-4,
                               atol=1e-6)


def test_quantized_build_and_device_rows_on_card(card, corpus, tmp_path):
    """flush(device_rows=...) from rows already on the card: the codes
    equal a host flush's on the card, the build source is the bf16
    decoded cache, and the segment reaches the recall band."""
    from opensearch_jvector_tpu_torch.models import builder as tbuilder

    vectors, queries = corpus
    rows = torch.as_tensor(vectors, device=card)
    cfg = DiskAnnConfig(dim=32, num_pq_subspaces=16, mode="on_disk")
    segs, opened = [], []
    for provider in (None, lambda lo, hi: rows[lo:hi]):
        idx = VectorIndex(tmp_path / str(provider is None), cfg, device=card)
        opened.append(idx)
        idx.writer.quantized_build_min_capacity = 1
        idx.add_batch(np.arange(6000), vectors)
        name = idx.flush(device_rows=provider)
        segs.append(idx._reader(name).seg)
        got = idx.search(queries, SearchConfig(k=10, overquery_factor=10))
    assert torch.equal(segs[0].pqv.codes, segs[1].pqv.codes)
    np.testing.assert_array_equal(segs[1].row_store.gather(np.arange(6000)),
                                  vectors)
    assert segs[1].graph.live[segs[1].graph.entry]
    truth = ground_truth_topk(torch.from_numpy(queries),
                              torch.from_numpy(vectors), 10,
                              SimilarityFunction.EUCLIDEAN)
    assert recall_at_k(got.doc_ids, truth, 10) >= 0.9
    seen = []
    real = tbuilder.GraphIndexBuilder.cleanup
    try:
        tbuilder.GraphIndexBuilder.cleanup = (
            lambda self, g, rows_, *a: seen.append(rows_.dtype)
            or real(self, g, rows_, *a))
        idx.add_batch(np.arange(6000, 7500), vectors[:1500])
        idx.flush()
    finally:
        tbuilder.GraphIndexBuilder.cleanup = real
        for i in opened:
            i.close()
    assert seen == [torch.bfloat16]


def test_build_profile_on_card_matches_cpu(card, monkeypatch):
    """A profiled build and delta insert count the same rounds, nodes and
    phases on the card as on the CPU. On the card, the graph and the
    reverse-edge and overflow counts equal those of the same calls with
    the numpy slot assignment patched in."""
    from test_torch_backedges import NumpyAssignment

    from opensearch_jvector_tpu_torch.models import builder as tbuilder

    monkeypatch.setattr(tbuilder, "BUILD_PROFILE", True)
    rows = _latent(np.random.default_rng(20), 21_000)
    seen, graphs = {}, {}

    def build_and_add(dev):
        b = tbuilder.GraphIndexBuilder(dim=32, max_degree=16, beam_width=48)
        x = torch.as_tensor(rows, device=dev)
        g = b.build(x[:20_000], SimilarityFunction.EUCLIDEAN, capacity=1 << 15)
        return b, b.add_nodes(g, x, np.arange(20_000, 21_000),
                              SimilarityFunction.EUCLIDEAN)

    for dev in ("cpu", card):
        b, graphs[dev] = build_and_add(dev)
        c = b.counters
        assert all(v >= 0.0 for v in c.phase_s.values())
        assert c.reverse_edges > 0 and c.overflow_nodes > 0
        seen[torch.device(dev).type] = (c.rounds, c.nodes_inserted,
                                        set(c.phase_s))
    assert seen["cuda"] == seen["cpu"]
    assert seen["cuda"][1] == 21_000 and len(seen["cuda"][2]) == 10

    ref = NumpyAssignment()
    ref.patch(monkeypatch)
    want_b, want = build_and_add(card)
    got = graphs[card]
    assert torch.equal(got.adjacency, want.adjacency)
    assert torch.equal(got.degrees, want.degrees)
    assert got.degrees.device == got.adjacency.device
    assert torch.equal(got.live, want.live) and got.entry == want.entry
    # the build under test counted what the reference assigned
    assert (b.counters.reverse_edges, b.counters.overflow_nodes) == (
        ref.edges, ref.overflow)


@pytest.mark.parametrize("kind", ["uniform", "present", "hot"])
def test_back_edges_on_card_equal_the_numpy_reference(kind, card):
    """One insert round at the ingest cell's shape (16,384 sources x 32
    into 2^19 rows, cap 38) assigned on the card equals the numpy
    reference: edges, overflow ids, extras and degrees."""
    from test_torch_backedges import assign, random_round, reference_back_edges

    from opensearch_jvector_tpu_torch.models.builder import GraphIndexBuilder

    kw = {"uniform": {"pad": 0.05}, "present": {"present": 0.3},
          "hot": {"hot": 20_000}}[kind]
    rng = np.random.default_rng(len(kind))
    deg, new_ids, sel, present = random_round(rng, 16_384, 32, 1 << 19, 38,
                                              **kw)
    want_deg = deg.copy()
    want = reference_back_edges(want_deg, new_ids, sel, 38, present, 32)
    b = GraphIndexBuilder(dim=128, max_degree=32)
    got = assign(b, *(torch.as_tensor(a, device=card)
                      for a in (deg, new_ids, sel)), 38,
                 torch.as_tensor(present, device=card))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[5], want_deg)
    if kind == "hot":
        assert want[3].size > 0 and (want[4] >= 0).any()


def test_ground_truth_stream_on_card_equals_the_scan(card):
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk_stream,
    )

    rng = np.random.default_rng(21)
    v = rng.standard_normal((20_000, 32)).astype(np.float32)
    q = torch.as_tensor(rng.standard_normal((64, 32)).astype(np.float32),
                        device=card)
    for simf in SimilarityFunction:
        want = ground_truth_topk(q, torch.as_tensor(v, device=card), 10, simf)
        got = ground_truth_topk_stream(
            q, ((s, v[s: s + 4096]) for s in range(0, 20_000, 4096)), 10,
            simf)
        np.testing.assert_array_equal(got, want)


# -- the graph build's two loops: beam walk and robust prune -----------------

def _walk_graph(card, n, d, m, seed):
    """A navigable graph over n latent rows on the card: each row's m - 4
    nearest rows, two random links and two -1 slots (ragged rows)."""
    from opensearch_jvector_tpu_torch.ops.distances import pairwise_sqdist

    rng = np.random.default_rng(seed)
    x = torch.as_tensor(_latent(rng, n, d), device=card)
    near = torch.cat([torch.topk(pairwise_sqdist(x[s: s + 4096], x), m - 3,
                                 largest=False).indices[:, 1:]
                      for s in range(0, n, 4096)])
    rand = torch.as_tensor(rng.integers(0, n, (n, 2)), device=card)
    pad = torch.full((n, 2), -1, device=card, dtype=torch.long)
    adj = torch.cat([near, rand, pad], 1).to(torch.int32).contiguous()
    return x, adj, torch.as_tensor(_latent(rng, 512, d), device=card)


def _provider(queries, x, dtype, simf):
    from opensearch_jvector_tpu_torch.models import searcher as tsearcher

    if dtype == "bf16":
        return tsearcher.PQDecodedProvider(queries, x.bfloat16(), simf)
    return tsearcher.ExactProvider(queries, x, simf)


def _hold_walk(adj, entry, prov, q, L, E, iters, launches=1):
    """The kernel's walk against the plain one: where the plain walk has
    no near tie (beam_kernel.kernel_error_bound; over codes
    codes_error_bound), the same pool as a set, scores within the bound,
    the same counters; elsewhere the pools overlap almost wholly. Returns
    the kernel's outputs."""
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    codes = hasattr(prov, "codebooks")
    error_bound = (beam_kernel.codes_error_bound if codes
                   else beam_kernel.kernel_error_bound)
    before = (beam_kernel.beam_search.launches,
              beam_kernel.beam_search.codes_launches)
    got = beam_kernel.beam_search(adj, entry, prov, q, L, E, iters)
    torch.cuda.synchronize()
    assert beam_kernel.beam_search.launches == before[0] + launches
    assert beam_kernel.beam_search.codes_launches == before[1] + (
        launches if codes else 0)
    ids, scores, vis, exp, near, bound = beam_kernel.beam_search_reference(
        adj, entry, prov, q, L, E, iters,
        tie_bound=lambda i: error_bound(prov, i))
    gi, gs, gv, ge = got
    assert gi.shape == (q, L) and gs.shape == (q, L)
    si, so = torch.sort(gi, 1)
    ri, ro = torch.sort(ids, 1)
    same = (si == ri).all(1) & (gv == vis) & (ge == exp)
    assert bool(same[~near].all()), (int((~same & ~near).sum()), q)
    gs_s, rs_s = torch.gather(gs, 1, so), torch.gather(scores, 1, ro)
    rb = torch.gather(bound, 1, ro)
    real = (ri >= 0) & same[:, None]
    assert bool(((gs_s - rs_s).abs() <= rb)[real].all())
    overlap = np.mean([len(np.intersect1d(a[a >= 0], b[b >= 0]))
                       / max(1, (b >= 0).sum())
                       for a, b in zip(gi.cpu().numpy(), ids.cpu().numpy())])
    assert overlap >= 0.98 and float(same.float().mean()) >= 0.8, (
        overlap, float(same.float().mean()), float(near.float().mean()))
    return got


# (Q, L, E, M, d, rows, simf, per-query entries): the build's insert round,
# the beam tier at ef 200, the hierarchy descent, L not a multiple of 32,
# the on_disk segment's L = 4,000 at overquery 20, d = 960, degree 48's
# cap_deg 57, bf16 rows (the decoded cache), all three similarities, and
# k = 1,000 at overquery 5 (L = 5,000, shared memory) and 10 (L = 10,000,
# past a block's shared memory: the state in a device-memory workspace)
WALK_SHAPES = [
    (512, 100, 8, 38, 128, "f32", "EUCLIDEAN", False),
    (256, 200, 16, 38, 128, "bf16", "EUCLIDEAN", True),
    (64, 16, 4, 16, 128, "f32", "COSINE", True),
    (200, 37, 4, 57, 960, "bf16", "COSINE", False),
    (8, 4000, 16, 57, 128, "f32", "DOT_PRODUCT", False),
    (96, 77, 16, 57, 960, "f32", "EUCLIDEAN", True),
    (128, 100, 8, 38, 100, "bf16", "DOT_PRODUCT", False),
    (64, 45, 8, 38, 36, "f32", "COSINE", False),
    (32, 5000, 16, 38, 128, "f32", "EUCLIDEAN", False),
    (16, 10_000, 16, 38, 128, "bf16", "COSINE", True),
]


@pytest.mark.parametrize("shape", WALK_SHAPES, ids=str)
def test_beam_kernel_matches_plain(shape, card):
    q, L, e, m, d, dtype, simf, per_query = shape
    x, adj, queries = _walk_graph(card, 20_000, d, m, seed=sum(shape[:5]))
    if simf == "DOT_PRODUCT":  # unit rows keep dot scores in [0, 1]
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    prov = _provider(queries[:q], x, dtype, SimilarityFunction[simf])
    entry = (torch.as_tensor(np.random.default_rng(q).integers(0, 20_000, q),
                             device=card) if per_query else 17)
    iters = max(8, -(-L // e))
    _hold_walk(adj, entry, prov, q, L, e, iters)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_beam_kernel_workspace_matches_plain(dtype, card, monkeypatch):
    """The kernel with its state in device memory (forced at the insert
    round's shape: no shared memory, a workspace of 8 queries a launch)
    walks as the plain version does."""
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 128, 38, seed=15)
    prov = _provider(queries[:64], x, dtype, SimilarityFunction.EUCLIDEAN)
    monkeypatch.setattr(beam_kernel, "SMEM_LIMIT", 0)
    monkeypatch.setattr(beam_kernel, "WORKSPACE_BYTES",
                        8 * beam_kernel.beam_smem_bytes(100, 8, 38, 21, 128))
    _hold_walk(adj, 3, prov, 64, 100, 8, 21, launches=8)


def test_search_at_k_1000_through_the_kernel(card, monkeypatch):
    """A user's search at k = 1,000 (L = 5,000; and 10,000 at overquery
    10, past a block's shared memory) runs through the kernel: recall@1000
    within 0.005 of the plain route's."""
    from opensearch_jvector_tpu_torch.models import searcher as tsearcher
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 128, 38, seed=16)
    q = queries[:32]
    simf = SimilarityFunction.EUCLIDEAN
    truth = ground_truth_topk(q, x, 1000, simf)
    live = torch.ones(20_000, dtype=torch.bool, device=card)
    recalls = {}
    for route in ("kernel", "plain"):
        if route == "plain":
            monkeypatch.setattr(beam_kernel, "beam_search",
                                lambda a, e, p, q_, L, E, it:
                                beam_kernel.beam_search_reference(
                                    a, e, p, q_, L, E, it))
        for over in (5, 10):
            before = getattr(beam_kernel.beam_search, "launches", 0)
            res = tsearcher.search(adj, live, 0, q, tsearcher.SearchParams(
                k=1000, overquery_factor=over), simf, vectors=x)
            assert res.ids.shape == (32, 1000)
            if route == "kernel":
                assert beam_kernel.beam_search.launches == before + 1
            recalls[route, over] = recall_at_k(res.ids.cpu().numpy(), truth,
                                               1000)
    for over in (5, 10):
        assert abs(recalls["kernel", over] - recalls["plain", over]) <= (
            0.005), recalls


def test_beam_kernel_readmits_an_evicted_node(card):
    """With a small pool, nodes scored once are evicted and reached again
    through later expansions: the plain walk scores them twice (dedup is
    against the current pool, not every node seen), and so does the
    kernel."""
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 32, 24, seed=11)
    prov = _provider(queries[:64], x, "f32", SimilarityFunction.EUCLIDEAN)
    seen = [[] for _ in range(64)]

    def spy(ids):
        for r, row in enumerate(ids.cpu().numpy()):
            seen[r].extend(int(i) for i in row if i >= 0)
        return prov(ids)

    beam_kernel.beam_search_reference(adj, 5, spy, 64, 6, 4, 30)
    again = [len(s) - len(set(s)) for s in seen]
    assert sum(again) > 0
    got = _hold_walk(adj, 5, prov, 64, 6, 4, 30)
    assert any(int(got[2][r]) > len(set(seen[r])) for r in range(64))


def test_beam_kernel_repeat_launches_are_identical(card):
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 128, 38, seed=12)
    prov = _provider(queries, x, "bf16", SimilarityFunction.EUCLIDEAN)
    first = beam_kernel.beam_search(adj, 3, prov, 512, 100, 8, 21)
    second = beam_kernel.beam_search(adj, 3, prov, 512, 100, 8, 21)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_beam_search_results_with_tombstones_match_plain(card, monkeypatch):
    """searcher.beam_search's accept/live mask and top-R over the kernel's
    pool: tombstoned nodes are walked but never returned, and the results
    equal the plain route's where no near tie (the top-R cut included)."""
    from opensearch_jvector_tpu_torch.models import searcher as tsearcher
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 128, 38, seed=13)
    live = torch.as_tensor(np.random.default_rng(13).random(20_000) > 0.2,
                           device=card)
    prov = _provider(queries, x, "f32", SimilarityFunction.EUCLIDEAN)
    entries = torch.nonzero(live)[:512, 0]
    args = (adj, live, entries, prov, 512, live)
    kw = dict(L=100, E=16, R=50, max_iters=12)
    ids, scores, vis, exp = tsearcher.beam_search(*args, **kw)
    assert bool(live[ids.clamp(min=0)][ids >= 0].all())
    monkeypatch.setattr(beam_kernel, "beam_search",
                        lambda a, e, p, q, L, E, it:
                        beam_kernel.beam_search_reference(a, e, p, q, L, E,
                                                          it))
    pids, pscores, pvis, pexp = tsearcher.beam_search(*args, **kw)
    pool, pool_s, _, _, near, bound = beam_kernel.beam_search_reference(
        adj, entries, prov, 512, 100, 16, 12,
        tie_bound=lambda i: beam_kernel.kernel_error_bound(prov, i))
    masked = torch.where(live[pool.clamp(min=0)] & (pool >= 0), pool_s,
                         float("-inf"))
    ok = ~near & ~beam_kernel._boundary_tie(masked, bound, 50)
    assert float(ok.float().mean()) >= 0.5
    assert torch.equal(torch.sort(ids[ok], 1).values,
                       torch.sort(pids[ok], 1).values)
    assert torch.equal(vis[ok], pvis[ok]) and torch.equal(exp[ok], pexp[ok])


def test_beam_smem_bytes_match_the_kernel_layout(card):
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    lib = beam_kernel._bind()
    for shape in [(100, 8, 38, 21, 128), (4000, 16, 57, 250, 960),
                  (16, 4, 16, 8, 128), (37, 4, 57, 10, 960),
                  (1, 1, 1, 0, 1)]:
        assert lib.beam_smem_bytes_c(*shape) == beam_kernel.beam_smem_bytes(
            *shape)


def test_beam_kernel_rejects_inputs_it_does_not_take(card):
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 5000, 32, 16, seed=14)
    prov = _provider(queries, x, "f32", SimilarityFunction.EUCLIDEAN)
    with pytest.raises(ValueError, match="L=300000000"):
        beam_kernel.beam_search(adj, 0, prov, 512, 300_000_000, 16, 600)
    with pytest.raises(ValueError):
        beam_kernel.beam_search(adj.long(), 0, prov, 512, 100, 8, 21)
    with pytest.raises(ValueError):  # mixed devices never fall back
        beam_kernel.beam_search(adj.cpu(), 0, prov, 512, 100, 8, 21)
    with pytest.raises(ValueError):
        beam_kernel.beam_search(adj, 0, prov, 100, 100, 8, 21)  # Q


# -- the walk over PQ codes (the `pq` provider) -----------------------------

def _codes_provider(x, queries, simf, msub):
    """A PQ of `msub` subspaces (K 256) trained on the card over rows `x`,
    and the codes provider of `queries` over its codes."""
    from opensearch_jvector_tpu_torch.models import pq as tpq
    from opensearch_jvector_tpu_torch.models import searcher as tsearcher

    pq = tpq.train_pq(x, simf, msub)
    assert pq.codebooks.shape[:2] == (msub, 256)
    prov = tsearcher.CodesProvider(queries, tpq.encode(pq, x, simf),
                                   pq.codebooks, pq.center, simf)
    prov.center = pq.center  # for a search built from the same PQ
    return prov


# (Q, L, E, degree, d, PQ M, simf, per-query entries): the NVQ deployment's
# batch (512 queries, ef 200, E 16, degree 32, PQ48 at d 96, cosine), ef
# 100 with an entry a query, PQ64 at d 128 (euclidean and dot), the
# hierarchy descent (16, 4, upper degree 16, 8), M 24 (codes read a byte at
# a time, dsub 5), and PQ192 at d 768, whose table and state outgrow a
# block's shared memory (the workspace)
CODES_SHAPES = [
    (512, 200, 16, 32, 96, 48, "COSINE", False),
    (256, 100, 16, 32, 96, 48, "EUCLIDEAN", True),
    (128, 200, 16, 38, 128, 64, "EUCLIDEAN", False),
    (128, 100, 8, 38, 128, 64, "DOT_PRODUCT", True),
    (64, 16, 4, 16, 96, 48, "COSINE", True),
    (64, 77, 8, 24, 120, 24, "EUCLIDEAN", False),
    (32, 200, 16, 38, 768, 192, "COSINE", False),
]


@pytest.mark.parametrize("shape", CODES_SHAPES, ids=str)
def test_codes_walk_kernel_matches_plain(shape, card):
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    q, L, e, m, d, msub, simf, per_query = shape
    x, adj, queries = _walk_graph(card, 20_000, d, m, seed=sum(shape[:6]))
    if simf == "DOT_PRODUCT":  # unit rows keep dot scores in [0, 1]
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    prov = _codes_provider(x, queries[:q], SimilarityFunction[simf], msub)
    entry = (torch.as_tensor(np.random.default_rng(q).integers(0, 20_000, q),
                             device=card) if per_query else 17)
    iters = max(8, -(-L // e))
    state = msub * 256
    shared = beam_kernel.beam_plan(L, e, m, iters, state)[1] == 0
    assert shared == (msub < 192)
    _hold_walk(adj, entry, prov, q, L, e, iters)


def test_codes_walk_kernel_workspace_matches_plain(card, monkeypatch):
    """The codes kernel with its table and state in device memory (forced
    at the deployment's shape: no shared memory, 8 queries a launch)."""
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 96, 32, seed=25)
    prov = _codes_provider(x, queries[:64], SimilarityFunction.COSINE, 48)
    monkeypatch.setattr(beam_kernel, "SMEM_LIMIT", 0)
    monkeypatch.setattr(beam_kernel, "WORKSPACE_BYTES", 8 * beam_kernel
                        .beam_smem_bytes(200, 16, 32, 13, 48 * 256))
    _hold_walk(adj, 3, prov, 64, 200, 16, 13, launches=8)


def test_codes_walk_repeat_launches_are_identical(card):
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 96, 32, seed=26)
    prov = _codes_provider(x, queries, SimilarityFunction.EUCLIDEAN, 48)
    first = beam_kernel.beam_search(adj, 3, prov, 512, 200, 16, 13)
    second = beam_kernel.beam_search(adj, 3, prov, 512, 200, 16, 13)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_the_hierarchy_descent_over_codes_on_card(card, monkeypatch):
    """`searcher.search` over PQ codes with an upper layer: two launches
    (the descent and the base walk), no plain step; the answers equal the
    plain route's on the card on almost every query."""
    from opensearch_jvector_tpu_torch.models import searcher as tsearcher
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 20_000, 96, 32, seed=27)
    prov = _codes_provider(x, queries, SimilarityFunction.COSINE, 48)
    upper = adj[:, :16].contiguous()
    live = torch.ones(20_000, dtype=torch.bool, device=card)
    kw = dict(pq_codes=prov.codes, pq_codebooks=prov.codebooks,
              pq_center=prov.center, vectors=x,
              upper_adjacency=upper)
    params = tsearcher.SearchParams(k=10, ef_search=200)
    before = beam_kernel.beam_search.codes_launches
    got = tsearcher.search(adj, live, 0, queries, params,
                           SimilarityFunction.COSINE, **kw)
    assert beam_kernel.beam_search.codes_launches == before + 2
    assert got.codes_walk_launches == 2 and got.codes_walk_steps == 0
    monkeypatch.setattr(beam_kernel, "beam_search",
                        lambda a, e, p, q, L, E, it, **k:
                        beam_kernel.beam_search_reference(
                            a, e, p, q, L, E, it,
                            on_steps=k.get("on_steps")))
    plain = tsearcher.search(adj, live, 0, queries, params,
                             SimilarityFunction.COSINE, **kw)
    assert plain.codes_walk_steps > 0 and plain.codes_walk_launches == 0
    same = (got.ids == plain.ids).all(1)
    assert float(same.float().mean()) >= 0.95
    assert recall_at_k(got.ids.cpu().numpy(), plain.ids.cpu().numpy(),
                       10) >= 0.995


def test_codes_walk_rejects_inputs_it_does_not_take(card):
    from opensearch_jvector_tpu_torch.models import searcher as tsearcher
    from opensearch_jvector_tpu_torch.ops import beam_kernel

    x, adj, queries = _walk_graph(card, 5000, 96, 16, seed=28)
    prov = _codes_provider(x, queries, SimilarityFunction.EUCLIDEAN, 48)
    with pytest.raises(ValueError, match="L=300000000"):
        beam_kernel.beam_search(adj, 0, prov, 512, 300_000_000, 16, 600)
    with pytest.raises(ValueError):  # mixed devices never fall back
        beam_kernel.beam_search(adj.cpu(), 0, prov, 512, 100, 8, 21)
    with pytest.raises(ValueError):  # codes must be uint8
        bad = tsearcher.CodesProvider(queries, prov.codes.int(),
                                      prov.codebooks, None,
                                      SimilarityFunction.EUCLIDEAN)
        beam_kernel.beam_search(adj, 0, bad, 512, 100, 8, 21)
    with pytest.raises(ValueError):  # Q
        beam_kernel.beam_search(adj, 0, prov, 100, 100, 8, 21)


def test_nvq_cosine_index_walks_codes_in_the_kernel_on_card(card, tmp_path):
    """An NVQ cosine segment (PQ48 at d 96) on the beam tier: on the card
    the walk is the kernel (`knn_query_codes_walk_launches` rises, the
    plain steps do not), on the CPU the plain walk over the same
    directory; recall@10 against the exact cosine top 10 within 0.002."""
    from opensearch_jvector_tpu_torch.api.stats import Counter, StatsRegistry

    rng = np.random.default_rng(29)
    rows, queries = _latent(rng, 6000, 96), _latent(rng, 200, 96)
    cfg = DiskAnnConfig(dim=96, similarity=SimilarityFunction.COSINE, m=32,
                        num_pq_subspaces=48, quantization_type="nvq+pq",
                        nvq_num_subvectors=2)
    sc = SearchConfig(k=10, ef_search=200)
    truth = ground_truth_topk(torch.from_numpy(queries),
                              torch.from_numpy(rows), 10,
                              SimilarityFunction.COSINE)
    GLOBAL_SETTINGS.put(SETTING, 0)
    try:
        stats = StatsRegistry()
        idx = VectorIndex(tmp_path, cfg, device=card, stats=stats)
        idx.add_batch(np.arange(6000), rows)
        idx.flush()
        got = idx.search(queries, sc)
        card_stats = stats.snapshot()
        cpu_stats = StatsRegistry()
        cpu = VectorIndex(tmp_path, device="cpu", stats=cpu_stats).search(
            queries, sc)
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
    assert card_stats["knn_query_codes_walk_launches"] == 1
    assert card_stats["knn_query_codes_walk_steps"] == 0
    assert cpu_stats.get(Counter.KNN_QUERY_CODES_WALK_STEPS) > 0
    assert cpu_stats.get(Counter.KNN_QUERY_CODES_WALK_LAUNCHES) == 0
    r_card = recall_at_k(got.doc_ids, truth, 10)
    r_cpu = recall_at_k(cpu.doc_ids, truth, 10)
    assert r_card >= 0.95 and abs(r_card - r_cpu) <= 0.002, (r_card, r_cpu)
    assert got.reranked > 0


def _prune_case(card, b, c, d, dtype, simf, seed):
    """Point rows and their C nearest corpus rows as candidates, with -1
    pads, repeated ids, a duplicated vector and the point itself among
    them; scores as the builder computes them."""
    from opensearch_jvector_tpu_torch.ops.distances import (
        batched_candidate_scores,
        pairwise_sqdist,
    )

    rng = np.random.default_rng(seed)
    n = 30_000
    x = torch.as_tensor(_latent(rng, n, d), device=card)
    x[7] = x[8]  # a duplicated vector
    if simf is SimilarityFunction.DOT_PRODUCT:
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    rows = x.bfloat16() if dtype == "bf16" else x
    pts = torch.as_tensor(rng.choice(n, b, replace=False), device=card)
    ids = torch.topk(pairwise_sqdist(x[pts], x), c, largest=False).indices
    ids[:, -5:] = -1
    ids[:, 3] = ids[:, 1]  # a repeated id
    ids[::7, 2] = pts[::7]  # the point itself
    ids[::5, 4] = 7
    ids[::5, 6] = 8
    cand = torch.where(ids >= 0, ids, 0)
    sc = batched_candidate_scores(rows[pts].float(), rows[cand].float(), simf)
    sc = torch.where(ids >= 0, sc, float("-inf"))
    return rows, ids, sc, pts


# (B, C, d, rows, simf): the insert round, the overflow prune, the splice,
# the bootstrap width, 256, d = 960, and the insert round at
# ef_construction 256 and 512 (C = 288, 544; past 256 columns a thread
# takes several)
PRUNE_SHAPES = [(2048, 132, 128, "f32", "EUCLIDEAN"),
                (1000, 70, 128, "bf16", "EUCLIDEAN"),
                (777, 128, 960, "f32", "COSINE"),
                (500, 100, 128, "f32", "DOT_PRODUCT"),
                (300, 256, 64, "bf16", "COSINE"),
                (64, 33, 960, "bf16", "EUCLIDEAN"),
                (1000, 288, 128, "f32", "EUCLIDEAN"),
                (400, 544, 128, "bf16", "DOT_PRODUCT")]


def _hold_prune(rows, ids, sc, pts, simf, launches=1):
    """The kernel's selections against the plain rule: each row a run of
    the rule on the plain distances but for comparisons within
    dcc_error_bound of equality (selection_margins share <= 1), most rows
    the plain version's, never the point, every id once, bit-equal on a
    repeat launch."""
    from opensearch_jvector_tpu_torch.ops import prune_kernel

    before = prune_kernel.robust_prune.launches
    got = prune_kernel.robust_prune(rows, ids, sc, 1.2, 32, simf,
                                    point_ids=pts)
    torch.cuda.synchronize()
    assert prune_kernel.robust_prune.launches == before + launches
    want = prune_kernel.robust_prune_reference(
        None, ids, rows[ids.clamp(min=0)].float(), sc, 1.2, 32, simf,
        point_ids=pts)
    _, share, _ = prune_kernel.selection_margins(rows, ids, sc, 1.2, simf,
                                                 pts, got)
    assert float(share.max()) <= 1.0, float(share.max())
    same = (got == want).all(1)
    assert float(same.float().mean()) >= 0.95
    assert not bool((got == pts[:, None]).any())
    for row in got.cpu().numpy():
        sel = row[row >= 0]
        assert sel.size > 0 and sel.size == np.unique(sel).size
    again = prune_kernel.robust_prune(rows, ids, sc, 1.2, 32, simf,
                                      point_ids=pts)
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", PRUNE_SHAPES, ids=str)
def test_robust_prune_kernel_matches_plain(shape, card):
    from opensearch_jvector_tpu_torch.ops import prune_kernel

    b, c, d, dtype, simf = shape
    simf = SimilarityFunction[simf]
    rows, ids, sc, pts = _prune_case(card, b, c, d, dtype, simf, sum(shape[:3]))
    _hold_prune(rows, ids, sc, pts, simf)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_robust_prune_kernel_workspace_matches_plain(dtype, card,
                                                     monkeypatch):
    """The kernel with its state in device memory (forced at the insert
    round's width: no shared memory, a workspace of 256 rows a launch)
    prunes as the plain version does."""
    from opensearch_jvector_tpu_torch.ops import prune_kernel

    simf = SimilarityFunction.EUCLIDEAN
    rows, ids, sc, pts = _prune_case(card, 1000, 132, 128, dtype, simf, 17)
    monkeypatch.setattr(prune_kernel, "SMEM_LIMIT", 0)
    monkeypatch.setattr(prune_kernel, "WORKSPACE_BYTES",
                        256 * prune_kernel.prune_smem_bytes(132, 128))
    _hold_prune(rows, ids, sc, pts, simf, launches=4)


def test_prune_smem_bytes_match_the_kernel_layout(card):
    from opensearch_jvector_tpu_torch.ops import prune_kernel

    lib = prune_kernel._bind()
    for c, d in [(132, 128), (70, 128), (544, 960), (10_512, 16_000),
                 (1, 1)]:
        assert lib.prune_smem_bytes_c(c, d) == prune_kernel.prune_smem_bytes(
            c, d)


def test_robust_prune_kernel_rejects_inputs_it_does_not_take(card):
    from opensearch_jvector_tpu_torch.ops import prune_kernel

    rows = torch.randn((1000, 32), device=card)
    ids = torch.randint(0, 1000, (8, 257), device=card)
    sc = torch.rand((8, 257), device=card)
    simf = SimilarityFunction.EUCLIDEAN
    with pytest.raises(ValueError, match="point_ids"):
        prune_kernel.robust_prune(rows, ids, sc, 1.2, 32, simf,
                                  point_ids=ids[:, 0][:5])
    with pytest.raises(ValueError):
        prune_kernel.robust_prune(rows.double(), ids[:, :10], sc[:, :10],
                                  1.2, 32, simf)
    with pytest.raises(ValueError):  # mixed devices never fall back
        prune_kernel.robust_prune(rows.cpu(), ids[:, :10], sc[:, :10], 1.2,
                                  32, simf)


def test_build_through_both_kernels_matches_the_plain_build(card,
                                                            monkeypatch):
    """A 20,000 x 128 build through the kernels: recall@10 within 0.005 of
    the same build with both routes on their plain versions, degree <= the
    bound, no self-loop, every live node reachable from the entry."""
    _hold_build(card, monkeypatch, 20_000, 100)


@pytest.mark.parametrize("beam", [256, 512])
def test_wide_beam_build_through_both_kernels(beam, card, monkeypatch):
    """The same at ef_construction 256 and 512 over 6,000 rows: the
    insert rounds walk pools of 256 and 512 and prune 288 and 544
    candidates."""
    _hold_build(card, monkeypatch, 6_000, beam)


def _hold_build(card, monkeypatch, n, beam):
    from opensearch_jvector_tpu_torch.models import builder as tbuilder
    from opensearch_jvector_tpu_torch.ops import beam_kernel, prune_kernel

    rng = np.random.default_rng(30)
    rows = _latent(rng, n, 128)
    queries = _latent(rng, 512, 128)
    x = torch.as_tensor(rows, device=card)
    q = torch.as_tensor(queries, device=card)
    simf = SimilarityFunction.EUCLIDEAN
    truth = ground_truth_topk(q, x, 10, simf)

    def build():
        from opensearch_jvector_tpu_torch.models import searcher as tsearcher

        b = tbuilder.GraphIndexBuilder(dim=128, max_degree=32,
                                       beam_width=beam)
        g = b.build(x, simf)
        res = tsearcher.search(g.adjacency, g.live, g.entry, q,
                               tsearcher.SearchParams(k=10), simf, vectors=x)
        return g, recall_at_k(res.ids.cpu().numpy(), truth, 10)

    launches = (beam_kernel.beam_search.launches,
                prune_kernel.robust_prune.launches)
    g, rec = build()
    assert beam_kernel.beam_search.launches > launches[0]
    assert prune_kernel.robust_prune.launches > launches[1]
    adj = g.adjacency[:n].long()
    assert int((adj >= 0).sum(1).max()) <= 32
    assert not bool((adj == torch.arange(n, device=card)[:, None]).any())
    assert bool(tbuilder._reachable(g.adjacency, g.live, g.entry)[:n].all())

    def plain_prune(rows_, ids, sc, alpha, m_out, simf_, point_ids=None):
        return prune_kernel.robust_prune_reference(
            None, ids, rows_[ids.clamp(min=0)].float(), sc, alpha, m_out,
            simf_, point_ids=point_ids)

    monkeypatch.setattr(beam_kernel, "beam_search",
                        lambda a, e, p, q_, L, E, it:
                        beam_kernel.beam_search_reference(a, e, p, q_, L, E,
                                                          it))
    monkeypatch.setattr(tbuilder, "robust_prune", plain_prune)
    _, plain_rec = build()
    assert abs(rec - plain_rec) <= 0.005, (rec, plain_rec)
    assert rec >= 0.95
