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
    """One anisotropic Lloyd step (scatter-adds and a batched solve) from
    shared centroids: rtol 1e-3 / atol 1e-4 (atomic adds sum in another
    order); the anisotropic encode: codes equal on >= 99.5 %."""
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
    searched on a mesh of cuda:0 x 3 and of cpu x 3: the same docs (recall
    of one against the other >= 0.99) and scores where the docs agree; the
    on_disk set runs the approx-only phase and the paged rerank."""
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
        sidx = ShardedVectorIndex(tmp_path, device=dev,
                                  mesh=[dev if dev == "cpu" else "cuda:0"] * 3)
        out[str(dev)] = sidx.search(queries, SearchConfig(k=10))
        assert sidx._mesh_state is not None
        assert sidx._mesh_state.approx_only == (mode == "on_disk")
        assert sidx.stats()["knn_mesh_restack_count"] == 3
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
    phases on the card as on the CPU."""
    from opensearch_jvector_tpu_torch.models import builder as tbuilder

    monkeypatch.setattr(tbuilder, "BUILD_PROFILE", True)
    rows = _latent(np.random.default_rng(20), 21_000)
    seen = {}
    for dev in ("cpu", card):
        b = tbuilder.GraphIndexBuilder(dim=32, max_degree=16, beam_width=48)
        x = torch.as_tensor(rows, device=dev)
        g = b.build(x[:20_000], SimilarityFunction.EUCLIDEAN, capacity=1 << 15)
        b.add_nodes(g, x, np.arange(20_000, 21_000),
                    SimilarityFunction.EUCLIDEAN)
        c = b.counters
        assert all(v >= 0.0 for v in c.phase_s.values())
        seen[torch.device(dev).type] = (c.rounds, c.nodes_inserted,
                                        set(c.phase_s))
    assert seen["cuda"] == seen["cpu"]
    assert seen["cuda"][1] == 21_000 and len(seen["cuda"][2]) == 10


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
