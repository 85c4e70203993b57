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
# and odd N with dsub = 15
DECODE_SHAPES = [(512, 1 << 16, 64, 256, 15), (3, 1000, 8, 64, 21),
                 (1, 777, 64, 256, 2), (7, 300, 64, 256, 2),
                 (130, 1030, 12, 256, 16), (17, 1000, 16, 256, 4),
                 (129, 2048, 32, 200, 7), (64, 1 << 14, 64, 256, 15),
                 (5, 1003, 64, 256, 15)]


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
