"""Port parity: distance, top-k and ADC ops of the PyTorch package against
the JAX package, on the same numpy inputs.

On the CPU the ADC wrapper runs its plain version (`lookup_scan`); the
CUDA kernel itself is checked against it in tests/test_torch_cuda.py. The
JAX side reaches its Pallas kernel in interpret mode, as
tests/test_pallas_kernels.py runs it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.ops import adc as jadc
from opensearch_jvector_tpu.ops import distances as jdist
from opensearch_jvector_tpu.ops import topk as jtopk
from opensearch_jvector_tpu.ops.pallas.adc_kernel import fused_adc_scan
from opensearch_jvector_tpu_torch.ops import adc as tadc
from opensearch_jvector_tpu_torch.ops import distances as tdist
from opensearch_jvector_tpu_torch.ops import topk as ttopk
from opensearch_jvector_tpu_torch.ops.adc_kernel import (
    adc_scan,
    kernel_error_bound,
    pick_group,
    prep_tables_reference,
)

torch.set_num_threads(2)

SIMFS = list(tdist.SimilarityFunction)
RTOL = 1e-5  # float32, same formulas; only summation order differs


def _jsimf(simf):
    return jdist.SimilarityFunction(simf.value)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_similarity_values_match_segment_ordinals():
    for simf in SIMFS:
        assert simf.value == _jsimf(simf).value
        assert tdist.SIMILARITY_ORDINALS[simf] == jdist.SIMILARITY_ORDINALS[
            _jsimf(simf)]
        assert simf.is_euclidean == _jsimf(simf).is_euclidean


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_pairwise_scores_match(simf):
    rng = np.random.default_rng(0)
    a, b = _rand(rng, 17, 24), _rand(rng, 33, 24)
    want = np.asarray(jdist.pairwise_scores(jnp.asarray(a), jnp.asarray(b),
                                            _jsimf(simf)))
    got = tdist.pairwise_scores(torch.from_numpy(a), torch.from_numpy(b),
                                simf).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_pairwise_sqdist_matches():
    rng = np.random.default_rng(1)
    a, b = _rand(rng, 9, 16), _rand(rng, 11, 16)
    want = np.asarray(jdist.pairwise_sqdist(jnp.asarray(a), jnp.asarray(b)))
    got = tdist.pairwise_sqdist(torch.from_numpy(a),
                                torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_batched_candidate_scores_match(simf):
    rng = np.random.default_rng(2)
    q, c = _rand(rng, 6, 20), _rand(rng, 6, 13, 20)
    want = np.asarray(jdist.batched_candidate_scores(
        jnp.asarray(q), jnp.asarray(c), _jsimf(simf)))
    got = tdist.batched_candidate_scores(torch.from_numpy(q),
                                         torch.from_numpy(c), simf).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)
    host = tdist.host_candidate_scores(q, c, simf)
    np.testing.assert_allclose(host, jdist.host_candidate_scores(
        q, c, _jsimf(simf)), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("space",
                         ["l2", "l1", "linf", "innerproduct", "cosinesimil"])
def test_exact_scores_match(space):
    rng = np.random.default_rng(3)
    q, v = _rand(rng, 12), _rand(rng, 40, 12)
    want = np.asarray(jdist.exact_scores(jnp.asarray(q), jnp.asarray(v),
                                         space))
    got = tdist.exact_scores(torch.from_numpy(q), torch.from_numpy(v),
                             space).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)


def test_topk_helpers_match():
    rng = np.random.default_rng(4)
    s = _rand(rng, 5, 50)
    ids = rng.permutation(250).reshape(5, 50).astype(np.int32)
    js, ji = jtopk.topk_scores(jnp.asarray(s), jnp.asarray(ids), 7)
    ts, ti = ttopk.topk_scores(torch.from_numpy(s),
                               torch.from_numpy(ids.astype(np.int64)), 7)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    mask = rng.random((5, 50)) < 0.5
    jm, jidx = jtopk.masked_topk(jnp.asarray(s), jnp.asarray(mask), 4)
    tm, tidx = ttopk.masked_topk(torch.from_numpy(s), torch.from_numpy(mask),
                                 4)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    s2 = _rand(rng, 5, 7)
    i2 = np.arange(1000, 1035, dtype=np.int32).reshape(5, 7)
    jms, jmi = jtopk.merge_topk(js, ji, jnp.asarray(s2), jnp.asarray(i2), 7)
    tms, tmi = ttopk.merge_topk(ts, ti, torch.from_numpy(s2),
                                torch.from_numpy(i2.astype(np.int64)), 7)
    np.testing.assert_array_equal(tms.numpy(), np.asarray(jms))
    np.testing.assert_array_equal(tmi.numpy(), np.asarray(jmi))


@pytest.mark.parametrize("euclidean", [True, False])
def test_build_luts_match(euclidean):
    rng = np.random.default_rng(5)
    qsub, cb = _rand(rng, 6, 8, 4), _rand(rng, 8, 64, 4)
    want = np.asarray(jadc.build_luts(jnp.asarray(qsub), jnp.asarray(cb),
                                      euclidean))
    got = tadc.build_luts(torch.from_numpy(qsub), torch.from_numpy(cb),
                          euclidean).numpy()
    assert got.shape == (6, 8, 64)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_adc_value_to_score_matches(simf):
    v = np.linspace(0.0, 3.0, 11, dtype=np.float32)
    want = np.asarray(jadc.adc_value_to_score(jnp.asarray(v), _jsimf(simf)))
    got = tadc.adc_value_to_score(torch.from_numpy(v), simf).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)


# (q, m, k, n): uint8 codes, a ragged N, and one query
SCAN_SHAPES = [(4, 8, 64, 300), (2, 4, 256, 128), (1, 8, 32, 1001)]


@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_lookup_scan_matches_jax_lookup_scan(shape):
    q, m, k, n = shape
    rng = np.random.default_rng(6)
    luts = _rand(rng, q, m, k)
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    want = np.asarray(jadc.lookup_scan(jnp.asarray(luts),
                                       jnp.asarray(codes, jnp.int32)))
    before = adc_scan.launches
    for fn in (tadc.lookup_scan, adc_scan):  # CPU tensors: plain version
        got = fn(torch.from_numpy(luts), torch.from_numpy(codes)).numpy()
        assert got.shape == (q, n) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5)
    assert adc_scan.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("shape", SCAN_SHAPES[:2], ids=str)
def test_adc_scan_matches_pallas_kernel(shape):
    """Against the TPU kernel's numerics (bf16 tables, interpret mode):
    the tolerance of tests/test_pallas_kernels.py."""
    q, m, k, n = shape
    rng = np.random.default_rng(7)
    luts = _rand(rng, q, m, k)
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    want = np.asarray(fused_adc_scan(jnp.asarray(luts), jnp.asarray(codes),
                                     block_n=128))
    tl, tc = torch.from_numpy(luts), torch.from_numpy(codes)
    got = adc_scan(tl, tc).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=4e-3 * m)
    # the TPU kernel's bf16 tables also stay within the CUDA kernel's bound
    assert (np.abs(want - got) <= kernel_error_bound(tl, tc).numpy()).all()


def test_lookup_scan_widens_uint8_codes():
    """A uint8 index tensor would act as a boolean mask: the plain version
    must gather by value (code 1 picks column 1, not a masked row)."""
    luts = torch.arange(2 * 1 * 4, dtype=torch.float32).reshape(2, 1, 4)
    codes = torch.tensor([[1], [0], [3]], dtype=torch.uint8)
    got = tadc.lookup_scan(luts, codes)
    np.testing.assert_array_equal(got.numpy(), [[1, 0, 3], [5, 4, 7]])


def test_adc_scan_group_and_tolerance():
    assert pick_group(64) == 4  # 128 KB of bf16 tables per block
    assert pick_group(192) == 2
    assert pick_group(400) == 1
    with pytest.raises(ValueError):
        pick_group(500)
    luts = torch.full((1, 64, 256), -0.5)
    codes = torch.zeros((3, 64), dtype=torch.uint8)
    bound = kernel_error_bound(luts, codes)
    assert bound.shape == (1, 3)
    assert torch.allclose(bound, torch.full((1, 3), 2.0**-8 * 64 * 0.5))
    # bf16 tables (the kernel's numerics) stay within the bound
    rng = np.random.default_rng(8)
    luts = torch.from_numpy(_rand(rng, 4, 16, 256))
    codes = torch.from_numpy(rng.integers(0, 256, (500, 16)).astype(np.uint8))
    err = (tadc.lookup_scan(luts.bfloat16().float(), codes)
           - tadc.lookup_scan(luts, codes)).abs()
    assert bool((err <= kernel_error_bound(luts, codes)).all())


def test_adc_scan_refuses_mixed_devices():
    """A CUDA tensor never falls back to the plain version; on a host
    without a card a meta tensor stands in for the foreign device."""
    luts = torch.zeros((1, 2, 4))
    codes = torch.zeros((3, 2), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        adc_scan(luts, codes)



@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_adc_scan_fused_score_and_mask_match_jax(simf):
    """The fused mode (score map and validity mask in the epilogue) against
    the reference's lookup_scan -> adc_value_to_score -> where(valid)."""
    rng = np.random.default_rng(9)
    q, m, k, n = 5, 8, 64, 301
    luts = rng.random((q, m, k), dtype=np.float32)  # sums of like sign
    codes = rng.integers(0, k, size=(n, m)).astype(np.uint8)
    valid = rng.random(n) < 0.8
    vals = jadc.lookup_scan(jnp.asarray(luts), jnp.asarray(codes, jnp.int32))
    want = np.asarray(jnp.where(jnp.asarray(valid)[None, :],
                                jadc.adc_value_to_score(vals, _jsimf(simf)),
                                -jnp.inf))
    before = adc_scan.launches
    got = adc_scan(torch.from_numpy(luts), torch.from_numpy(codes), simf,
                   torch.from_numpy(valid)).numpy()
    assert adc_scan.launches == before  # no kernel on the CPU
    assert got.shape == (q, n) and got.dtype == np.float32
    assert np.isneginf(got[:, ~valid]).all()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_adc_scan_group_follows_the_queries():
    """One query stages one table set, two queries two; three and more
    fill a group of 4 (wide M still caps the group)."""
    assert [pick_group(64, q) for q in (1, 2, 3, 4, 5, 512)] == [
        1, 2, 4, 4, 4, 4]
    assert pick_group(64, 0) == 1
    assert [pick_group(192, q) for q in (1, 3, 9)] == [1, 2, 2]
    assert pick_group(400, 7) == 1


@pytest.mark.parametrize("group", [1, 2, 4])
def test_adc_prep_reference_layout(group):
    """The prep layout's plain version: [ceil(Q/G), M, 256, G] bf16 with
    entry [qg, m, c, g] = bf16(luts[qg*G + g, m, c]), zero past K and Q."""
    rng = np.random.default_rng(10)
    q, m, k = 5, 3, 40
    luts = torch.from_numpy(_rand(rng, q, m, k))
    lb = prep_tables_reference(luts, group)
    groups = -(-q // group)
    assert lb.shape == (groups, m, 256, group) and lb.dtype == torch.bfloat16
    assert lb.is_contiguous()
    bf = luts.bfloat16()
    for qi in range(groups * group):
        got = lb[qi // group, :, :, qi % group]
        if qi < q:
            assert torch.equal(got[:, :k], bf[qi])
            assert not got[:, k:].any()
        else:
            assert not got.any()


def test_adc_scan_rejects_bad_validity_masks():
    luts = torch.zeros((2, 4, 16))
    codes = torch.zeros((10, 4), dtype=torch.uint8)
    for valid in (torch.ones(9, dtype=torch.bool),  # wrong length
                  torch.ones(10, dtype=torch.uint8),  # not bool
                  torch.ones((1, 10), dtype=torch.bool)):  # not 1-D
        with pytest.raises(ValueError):
            adc_scan(luts, codes, valid=valid)
