"""Port parity for the other quantizers: NVQ (nvq+pq), scalar 1/2/4-bit with
the Hamming provider, and anisotropic PQ, from the operators up to whole
indexes.

The same seeded numpy inputs go through the JAX package and the PyTorch
package. Tolerances:
  * `logistic_nqt` / `logit_nqt`: bit for bit against the reference run
    operator by operator (`jax.disable_jit`);
  * `nvq_decode` of the reference's bytes and parameters: bit for bit
    against the reference run operator by operator; against its compiled
    program (XLA fuses multiply-adds on the CPU, and the inverse logistic
    amplifies a last-place difference near 1) every element within 2e-5 of
    the largest magnitude and 99 % within 2e-6 of it;
  * `nvq_encode`: the same grid point for >= 99 % of the subvectors, there
    bytes equal on >= 99.9 % of the elements and never more than 1 apart;
    reconstruction error within 1 % of the reference's;
  * scalar thresholds, stored codes and query codes: byte for byte;
    `hamming_scores`: exact;
  * `aniso_assign_scores` and one `_lloyd_iter_aniso` step from shared
    centroids: rtol 1e-4 / atol 1e-5; the anisotropic encode on shared
    codebooks: codes equal on >= 99.5 % of the entries (near ties);
    `eta_from_config`: equal;
  * a segment written by one package and opened by the other: files
    byte-identical after a rewrite; searches return the same ids up to
    score ties, scores atol 1e-5, and the same visited / expanded /
    reranked counts, on both tiers. That holds for scalar segments too,
    whose Hamming scores tie in long runs, because the port's beam search
    then selects as `lax.top_k` does (the lower slot wins); their scores
    are also each doc's exact fp32 score;
  * whole slice (add -> flush -> search -> delete -> force_merge ->
    reopen) per mode: recall@10 against exact ground truth within 0.05 of
    the JAX package's on the same data and above the mode's floor.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.api import config as jconfig
from opensearch_jvector_tpu.api.settings import GLOBAL_SETTINGS as JSETTINGS
from opensearch_jvector_tpu.index import segment as jsegment
from opensearch_jvector_tpu.index.index import VectorIndex as JIndex
from opensearch_jvector_tpu.index.scheduler import ForceMergesOnlyMergePolicy
from opensearch_jvector_tpu.models import nvq as jnvq
from opensearch_jvector_tpu.models import pq as jpq
from opensearch_jvector_tpu.models import scalar as jscalar
from opensearch_jvector_tpu.models.searcher import _encode_scalar_queries
from opensearch_jvector_tpu.ops import kmeans as jkmeans
from opensearch_jvector_tpu.ops import nvq as jnvq_ops
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu.ops.distances import hamming_scores as jhamming
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
from opensearch_jvector_tpu_torch.convert import (
    nvq_from_numpy,
    pq_from_numpy,
    scalar_from_numpy,
    segment_from_numpy,
)
from opensearch_jvector_tpu_torch.index import segment as tsegment
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.index.reader import SegmentReader
from opensearch_jvector_tpu_torch.index.scheduler import (
    ForceMergesOnlyMergePolicy as TForceOnly,
)
from opensearch_jvector_tpu_torch.models import nvq as tnvq
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.models import scalar as tscalar
from opensearch_jvector_tpu_torch.ops import kmeans as tkmeans
from opensearch_jvector_tpu_torch.ops import nvq as tnvq_ops
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    hamming_scores,
)
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    recall_at_k,
)

torch.set_num_threads(2)

FIXTURES = Path(__file__).parent / "fixtures"
SETTING = "index.knn.advanced.scan_tier_max_codes"
D, PER_FLUSH, FLUSHES, Q, K = 16, 600, 2, 24, 10
CFG = dict(dim=D, m=12, ef_construction=48, num_pq_subspaces=8,
           min_batch_size_for_quantization=256)
DOT = SimilarityFunction.DOT_PRODUCT
MODES = {
    "nvq": dict(quantization_type="nvq+pq"),
    "nvq_on_disk": dict(quantization_type="nvq+pq", mode="on_disk"),
    "1bit": dict(quantization_type="1bit"),
    "2bit": dict(quantization_type="2bit"),
    "4bit": dict(quantization_type="4bit"),
    "aniso": dict(pq_anisotropic_threshold=0.5, similarity=DOT),
}
SCALAR = ("1bit", "2bit", "4bit")
# recall@10 floors per mode at the default SearchConfig on this corpus
# (one-bit Hamming over 16 dimensions carries 16 bits of signal: the
# reference reads the same recall on the same data, which is what is held)
FLOOR = {"nvq": 0.9, "nvq_on_disk": 0.9, "1bit": 0.4, "2bit": 0.7,
         "4bit": 0.8, "aniso": 0.9}


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


# -- operators: NVQ -----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logistic_nqt_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    v = (3 * rng.standard_normal(4000)).astype(np.float32)
    a = (np.abs(rng.standard_normal(4000)) + 0.1).astype(np.float32)
    x0 = rng.standard_normal(4000).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jnvq_ops.logistic_nqt(*map(jnp.asarray, (v, a, x0))))
    got = tnvq_ops.logistic_nqt(_t(v), _t(a), _t(x0)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logit_nqt_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.001, 0.999, 4000).astype(np.float32)
    a = (np.abs(rng.standard_normal(4000)) + 0.1).astype(np.float32)
    x0 = rng.standard_normal(4000).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jnvq_ops.logit_nqt(*map(jnp.asarray, (s, a, x0))))
    got = tnvq_ops.logit_nqt(_t(s), _t(a), _t(x0)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _nvq_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d))
         * rng.uniform(0.2, 3.0, (1, d))).astype(np.float32)
    return x - x.mean(0)


@pytest.fixture(scope="module")
def jax_nvq():
    """The reference's encode of one corpus: rows, bytes, params."""
    x = _nvq_rows(1500, 48, 0)
    b, p = jnvq_ops.nvq_encode(jnp.asarray(x), 4)
    return x, np.asarray(b), np.asarray(p)


def test_nvq_decode_of_reference_bytes(jax_nvq):
    x, b, p = jax_nvq
    mean = np.random.default_rng(1).standard_normal(48).astype(np.float32)
    got = tnvq_ops.nvq_decode(_t(b), _t(p), _t(mean), 4).numpy()
    bs = jnp.asarray(b).reshape(-1, 4, 12)

    def dec(bb, pp):
        return jnvq_ops.nvq_decode_subvector(bb, pp[0], pp[1], pp[2], pp[3])

    with jax.disable_jit():
        eager = np.asarray(jax.vmap(jax.vmap(dec))(bs, jnp.asarray(p)))
    eager = eager.reshape(-1, 48) + mean
    np.testing.assert_array_equal(_bits(got), _bits(eager))
    compiled = np.asarray(jnvq_ops.nvq_decode(
        jnp.asarray(b), jnp.asarray(p), jnp.asarray(mean), 4))
    err = np.abs(got - compiled) / np.abs(compiled).max()
    assert err.max() <= 2e-5, err.max()
    assert (err <= 2e-6).mean() >= 0.99
    # and it is a reconstruction of the rows
    assert np.mean((got - mean - x) ** 2) < 1e-3 * np.mean(x ** 2)


@pytest.mark.parametrize("n, d, m", [(1500, 48, 4), (700, 30, 3),
                                     (400, 16, 1)])
def test_nvq_encode_matches_reference(n, d, m):
    x = _nvq_rows(n, d, n)
    jb, jp = (np.asarray(a) for a in jnvq_ops.nvq_encode(jnp.asarray(x), m))
    tb, tp_ = (a.numpy() for a in tnvq_ops.nvq_encode(_t(x), m))
    assert tb.dtype == np.uint8 and tb.shape == (n, d)
    assert tp_.shape == (n, m, 4)
    # min and max do not depend on the fit
    np.testing.assert_array_equal(tp_[..., 2:], jp[..., 2:])
    same_grid = (tp_[..., :2] == jp[..., :2]).all(-1)  # [n, m]
    assert same_grid.mean() >= 0.99
    there = np.repeat(same_grid, d // m, axis=1)
    diff = np.abs(tb.astype(int) - jb.astype(int))[there]
    assert (diff == 0).mean() >= 0.999 and diff.max() <= 1

    def mse(b, p):
        rec = tnvq_ops.nvq_decode(_t(b), _t(p), torch.zeros(d), m).numpy()
        return float(np.mean((rec - x) ** 2))

    assert abs(mse(tb, tp_) - mse(jb, jp)) <= 0.01 * mse(jb, jp)


def test_nvq_fit_takes_the_first_minimum():
    """A constant subvector reconstructs exactly at every grid point: the
    fit keeps the first, as the reference's argmin does."""
    x = np.full((5, 8), 0.75, np.float32)
    _, jp = jnvq_ops.nvq_encode(jnp.asarray(x), 2)
    _, tp_ = tnvq_ops.nvq_encode(_t(x), 2)
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp))


def test_nvq_chunked_encode_equals_one_pass(monkeypatch):
    x = _nvq_rows(300, 16, 7)
    b1, p1 = tnvq_ops.nvq_encode(_t(x), 2)
    d1 = tnvq_ops.nvq_decode(b1, p1, torch.zeros(16), 2)
    monkeypatch.setattr(tnvq_ops, "NVQ_CHUNK_BYTES", 16 * 4 * 64)
    b2, p2 = tnvq_ops.nvq_encode(_t(x), 2)
    assert torch.equal(b1, b2) and torch.equal(p1, p2)
    assert torch.equal(d1, tnvq_ops.nvq_decode(b2, p2, torch.zeros(16), 2))


@pytest.mark.parametrize("d, asked, used", [(30, 4, 3), (16, 2, 2),
                                            (7, 3, 1)])
def test_train_nvq_subvector_rule(d, asked, used):
    rng = np.random.default_rng(d)
    v = (rng.standard_normal((300, d)) + 2.0).astype(np.float32)
    jn = jnvq.train_nvq(jnp.asarray(v), asked)
    tn = tnvq.train_nvq(_t(v), asked)
    assert tn.num_subvectors == jn.num_subvectors == used
    np.testing.assert_allclose(tn.global_mean.numpy(),
                               np.asarray(jn.global_mean), rtol=1e-6,
                               atol=1e-6)
    jm = float(jnvq.reconstruction_mse(jn, jnp.asarray(v)))
    tm = float(tnvq.reconstruction_mse(tn, _t(v)))
    assert abs(tm - jm) <= 0.02 * jm


def test_decode_rows_gathers_then_decodes(jax_nvq):
    _, b, p = jax_nvq
    nvq = nvq_from_numpy(b, p, np.zeros(48, np.float32), device="cpu")
    ids = torch.tensor([[3, 0, 1499], [7, 7, 2]])
    got = nvq.decode_rows(ids)
    assert got.shape == (2, 3, 48)
    assert torch.equal(got, nvq.decode()[ids])


# -- operators: scalar quantization and Hamming -------------------------------

@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 13])
def test_scalar_thresholds_and_codes_byte_for_byte(bits, d):
    x = np.random.default_rng(bits * d).standard_normal((1200, d)).astype(
        np.float32)
    js = jscalar.train_scalar_quantizer(x, bits, sample_size=500)
    ts = tscalar.train_scalar_quantizer(x, bits, sample_size=500)
    from_tensor = tscalar.train_scalar_quantizer(_t(x), bits, sample_size=500)
    assert ts.bits == js.bits == bits
    np.testing.assert_array_equal(ts.thresholds, js.thresholds)
    np.testing.assert_array_equal(from_tensor.thresholds, js.thresholds)
    want = jscalar.quantize_vectors(js, x)
    got = tscalar.quantize_vectors(ts, _t(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape[1] == -(-(d * (2 ** bits - 1)) // 8)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_scalar_query_codes_match_reference(bits):
    x = np.random.default_rng(bits).standard_normal((400, 13)).astype(
        np.float32)
    state = jscalar.train_scalar_quantizer(x, bits)
    want = np.asarray(_encode_scalar_queries(
        jnp.asarray(x[:9]), jnp.asarray(state.thresholds)))
    got = tscalar.thermometer_codes(_t(x[:9]), _t(state.thresholds))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scalar_encode_is_chunked_without_effect(monkeypatch):
    x = np.random.default_rng(3).standard_normal((500, 16)).astype(np.float32)
    state = tscalar.train_scalar_quantizer(x, 4)
    want = tscalar.quantize_vectors(state, _t(x))
    monkeypatch.setattr(tscalar, "ENCODE_SLAB_BYTES", 15 * 16 * 7)
    assert torch.equal(tscalar.quantize_vectors(state, _t(x)), want)


@pytest.mark.parametrize("width", [16, 15, 3, 240])
def test_hamming_scores_exact(width):
    rng = np.random.default_rng(width)
    q = rng.integers(0, 256, width, dtype=np.uint8)
    c = rng.integers(0, 256, (300, width), dtype=np.uint8)
    want = np.asarray(jhamming(jnp.asarray(q), jnp.asarray(c)))
    np.testing.assert_array_equal(hamming_scores(_t(q), _t(c)).numpy(), want)
    # the provider's batched form: one query code per row of candidates
    qs = rng.integers(0, 256, (4, 1, width), dtype=np.uint8)
    got = hamming_scores(_t(qs), _t(c[:12].reshape(4, 3, width))).numpy()
    for i in range(4):
        np.testing.assert_array_equal(
            got[i], np.asarray(jhamming(jnp.asarray(qs[i, 0]),
                                        jnp.asarray(c[3 * i: 3 * i + 3]))))


def test_hamming_search_matches_reference():
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 256, (200, 30), dtype=np.uint8)
    _, want = jscalar.hamming_search(codes[3], codes, 7)
    ids, got = tscalar.hamming_search(_t(codes[3]), _t(codes), 7)
    np.testing.assert_array_equal(got, want)
    assert ids[0] == 3


def test_quantization_state_cache_evicts_by_weight_and_age():
    cache = tscalar.QuantizationStateCache(max_bytes=300, ttl_seconds=3600)
    state = tscalar.QuantizationState(1, np.zeros((1, 32), np.float32))
    cache.put("a", state)
    cache.put("b", state)
    assert cache.get("a") is state  # refreshes a: b is now the oldest
    cache.put("c", state)
    assert cache.get("b") is None and cache.get("a") is state
    assert cache.stats()["weight_bytes"] <= 300
    arrays = state.to_arrays()
    assert tscalar.QuantizationState.from_arrays(arrays).bits == 1


# -- operators: anisotropic k-means and PQ --------------------------------------

def test_aniso_assign_scores_match_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((900, 6)).astype(np.float32)
    c = x[rng.choice(900, 20, replace=False)] + 0.01
    want = np.asarray(jkmeans.aniso_assign_scores(
        jnp.asarray(x), jnp.asarray(c), jnp.float32(3.7)))
    got = tkmeans.aniso_assign_scores(_t(x), _t(c), 3.7).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_lloyd_iter_aniso_step_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((900, 6)).astype(np.float32)
    c = x[rng.choice(900, 20, replace=False)] + 0.01
    c[5] = 100.0  # an empty cluster keeps its centroid
    want = np.asarray(jkmeans._lloyd_iter_aniso(
        jnp.asarray(x), jnp.asarray(c), jnp.float32(3.7)))
    got = tkmeans._lloyd_iter_aniso(_t(x)[None], _t(c)[None], 3.7)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[5], c[5])


@pytest.fixture(scope="module")
def jax_aniso_pq():
    x = np.random.default_rng(4).standard_normal((1500, 24)).astype(
        np.float32)
    jp = jpq.train_pq(jnp.asarray(x), JSim.DOT_PRODUCT, num_subspaces=4,
                      anisotropic_eta=3.7)
    return x, jp, pq_from_numpy(np.asarray(jp.codebooks),
                                np.asarray(jp.center),
                                aniso_eta=np.asarray(jp.aniso_eta),
                                device="cpu")


def test_aniso_encode_on_shared_codebooks(jax_aniso_pq):
    x, jp, tp_ = jax_aniso_pq
    assert tp_.aniso_eta == float(np.asarray(jp.aniso_eta))
    want = np.asarray(jpq.encode(jp, jnp.asarray(x), JSim.DOT_PRODUCT))
    got = tpq.encode(tp_, _t(x), DOT).numpy()
    assert (got == want).mean() >= 0.995
    plain = tpq.encode(tpq.ProductQuantization(tp_.codebooks, tp_.center),
                       _t(x), DOT).numpy()
    assert (plain != got).any()  # the loss really takes part


def test_aniso_refine_matches_reference(jax_aniso_pq):
    x, jp, tp_ = jax_aniso_pq
    want = jpq.refine_pq(jp, jnp.asarray(x), JSim.DOT_PRODUCT)
    got = tpq.refine_pq(tp_, _t(x), DOT)
    assert got.aniso_eta == tp_.aniso_eta
    np.testing.assert_allclose(got.codebooks.numpy(),
                               np.asarray(want.codebooks), rtol=1e-3,
                               atol=1e-4)


def test_aniso_training_quality_matches_reference(jax_aniso_pq):
    """Seeds differ (torch.Generator against jax.random), so trained
    codebooks are compared by their anisotropic loss: within 5 %."""
    x, jp, _ = jax_aniso_pq
    tp_ = tpq.train_pq(_t(x), DOT, num_subspaces=4, anisotropic_eta=3.7)
    assert tp_.aniso_eta == float(np.float32(3.7))

    def loss(pq):
        xs = _t(x).reshape(-1, 4, 6).transpose(0, 1)
        return float(tkmeans.aniso_assign_scores(
            xs, pq.codebooks, pq.aniso_eta).amin(-1).mean())

    theirs = pq_from_numpy(np.asarray(jp.codebooks), np.asarray(jp.center),
                           aniso_eta=3.7, device="cpu")
    assert abs(loss(tp_) - loss(theirs)) <= 0.05 * loss(theirs)
    # eta <= 1 means plain PQ
    assert tpq.train_pq(_t(x[:300]), DOT, num_subspaces=4,
                        anisotropic_eta=1.0).aniso_eta is None


@pytest.mark.parametrize("threshold", [None, 0.0, 0.2, 0.5, 0.9])
def test_eta_from_config_equal(threshold):
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((2000, 6)) @ rng.standard_normal((6, 40))
         + 0.05 * rng.standard_normal((2000, 40))).astype(np.float32)
    jcfg = jconfig.DiskAnnConfig(dim=40, pq_anisotropic_threshold=threshold)
    tcfg = tconfig.DiskAnnConfig(dim=40, pq_anisotropic_threshold=threshold)
    want = jpq.eta_from_config(jcfg, jnp.asarray(x))
    assert tpq.eta_from_config(tcfg, _t(x)) == want
    assert tpq.eta_from_config(tcfg, x) == want
    if threshold == 0.9:
        assert want > 1.0
        assert tpq.estimate_intrinsic_dim(_t(x), max_rows=500) == (
            jpq.estimate_intrinsic_dim(x, max_rows=500))


# -- whole indexes, crossing between the packages ---------------------------------

def assert_same_up_to_ties(ids_a, s_a, ids_b, s_b, tol=1e-5):
    """Scores agree; doc ids differ only where the score is tied."""
    np.testing.assert_allclose(s_a, s_b, rtol=tol, atol=tol)
    for r in range(ids_a.shape[0]):
        for j in np.nonzero(ids_a[r] != ids_b[r])[0]:
            tied = np.abs(s_a[r] - s_a[r, j]) <= tol
            tied[j] = False
            assert tied.any(), (r, j, ids_a[r], ids_b[r])


def _latent(rng, n):
    a = rng.standard_normal((8, D)) / np.sqrt(8)
    return (rng.standard_normal((n, 8)) @ a
            + 0.05 * rng.standard_normal((n, D))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, PER_FLUSH * FLUSHES), _latent(rng, Q)


def _fill(index, vectors):
    for f in range(FLUSHES):
        lo = f * PER_FLUSH
        index.add_batch(np.arange(lo, lo + PER_FLUSH),
                        vectors[lo: lo + PER_FLUSH])
        index.flush()


def _jcfg(mode):
    kw = dict(MODES[mode])
    if "similarity" in kw:
        kw["similarity"] = JSim.DOT_PRODUCT
    return jconfig.DiskAnnConfig(**CFG, **kw)


def _tcfg(mode):
    return tconfig.DiskAnnConfig(**CFG, **MODES[mode])


@pytest.fixture(scope="module")
def jax_dirs(corpus, tmp_path_factory):
    """One index directory per mode, written by the JAX package."""
    out = {}
    for mode in MODES:
        root = tmp_path_factory.mktemp(f"jax_{mode}")
        idx = JIndex(root, _jcfg(mode),
                     merge_policy=ForceMergesOnlyMergePolicy())
        _fill(idx, corpus[0])
        idx.close()
        out[mode] = root
    return out


@pytest.fixture(scope="module")
def port_dirs(corpus, tmp_path_factory):
    """One index directory per mode, written by the port."""
    out = {}
    for mode in MODES:
        root = tmp_path_factory.mktemp(f"port_{mode}")
        idx = VectorIndex(root, _tcfg(mode), device="cpu",
                          merge_policy=TForceOnly())
        _fill(idx, corpus[0])
        idx.close()
        out[mode] = root
    return out


@pytest.fixture(params=[False, True], ids=["scan", "beam"])
def tier(request):
    """Default routing, then every segment on the beam tier, in both
    packages."""
    bound = 0 if request.param else -1
    GLOBAL_SETTINGS.put(SETTING, bound)
    JSETTINGS.put(SETTING, bound)
    try:
        yield request.param
    finally:
        GLOBAL_SETTINGS.put(SETTING, -1)
        JSETTINGS.put(SETTING, -1)


def _exact_scores(queries, vectors, doc_ids, simf):
    rows = vectors[np.clip(doc_ids, 0, None)]
    if simf is DOT:
        return (1.0 + np.einsum("qd,qkd->qk", queries, rows)) / 2.0
    return 1.0 / (1.0 + ((rows - queries[:, None, :]) ** 2).sum(-1))


def _compare(mode, corpus, jres, tres, simf):
    """Both packages' answers over one directory."""
    vectors, queries = corpus
    assert_same_up_to_ties(jres.doc_ids, jres.scores, tres.doc_ids,
                           tres.scores)
    assert (jres.visited, jres.expanded, jres.reranked) == (
        tres.visited, tres.expanded, tres.reranked)
    if mode in SCALAR:
        np.testing.assert_allclose(
            tres.scores, _exact_scores(queries, vectors, tres.doc_ids, simf),
            rtol=1e-4, atol=1e-6)
        assert tres.reranked > 0


@pytest.mark.parametrize("mode", list(MODES))
def test_port_opens_jax_index(mode, corpus, jax_dirs, tier):
    jidx = JIndex(jax_dirs[mode], merge_policy=ForceMergesOnlyMergePolicy())
    tidx = VectorIndex(jax_dirs[mode], device="cpu")
    assert tidx.segment_names == jidx.segment_names
    seg = tidx._reader(tidx.segment_names[0]).seg
    assert seg.quantization_type == MODES[mode].get("quantization_type", "pq")
    got = tidx.search(corpus[1], tconfig.SearchConfig(k=K))
    if tier or mode in SCALAR:
        assert got.expanded > 0  # really the beam tier
    assert got.reranked > 0 or (mode == "aniso" and tier)
    _compare(mode, corpus, jidx.search(corpus[1], jconfig.SearchConfig(k=K)),
             got, seg.config.similarity)


@pytest.mark.parametrize("mode", list(MODES))
def test_jax_opens_port_index(mode, corpus, port_dirs, tier):
    jidx = JIndex(port_dirs[mode], merge_policy=ForceMergesOnlyMergePolicy())
    tidx = VectorIndex(port_dirs[mode], device="cpu")
    assert jidx.segment_names == tidx.segment_names
    _compare(mode, corpus, jidx.search(corpus[1], jconfig.SearchConfig(k=K)),
             tidx.search(corpus[1], tconfig.SearchConfig(k=K)),
             _tcfg(mode).similarity)


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(Path(d).iterdir())}


@pytest.mark.parametrize("mode", list(MODES))
def test_segment_bytes_identical_both_ways(mode, jax_dirs, port_dirs,
                                           tmp_path):
    """Rewriting a segment read from the other package reproduces its
    files byte for byte; an NVQ segment has no row file in either mode."""
    jname = JIndex(jax_dirs[mode]).segment_names[0]
    seg = tsegment.read_segment(jax_dirs[mode] / jname, "cpu")
    tsegment.write_segment(tmp_path / "t", seg)
    assert _files(tmp_path / "t" / jname) == _files(jax_dirs[mode] / jname)

    tname = VectorIndex(port_dirs[mode], device="cpu").segment_names[0]
    jseg = jsegment.read_segment(port_dirs[mode] / tname)
    jsegment.write_segment(tmp_path / "j", jseg)
    files = _files(port_dirs[mode] / tname)
    assert _files(tmp_path / "j" / tname) == files
    assert "rows.f32" not in files
    expect = {"nvq": "vectors.jvtpu", "nvq_on_disk": "vectors.jvtpu",
              "aniso": "pq.jvtpu"}.get(mode, "scalar.jvtpu")
    assert expect in files


@pytest.mark.parametrize("mode", SCALAR)
def test_scalar_files_equal_across_packages(mode, jax_dirs, port_dirs):
    """The same flush in either package trains the same thresholds and
    packs the same codes: `scalar.jvtpu` is byte-identical."""
    for name in JIndex(jax_dirs[mode]).segment_names:
        assert ((jax_dirs[mode] / name / "scalar.jvtpu").read_bytes()
                == (port_dirs[mode] / name / "scalar.jvtpu").read_bytes())


def test_aniso_eta_travels_with_the_segment(jax_dirs, port_dirs):
    for root in (jax_dirs["aniso"], port_dirs["aniso"]):
        idx = VectorIndex(root, device="cpu")
        etas = [idx._reader(n).seg.pqv.pq.aniso_eta
                for n in idx.segment_names]
        assert all(e is not None and e > 1.0 for e in etas), etas
    jseg = jsegment.read_segment(
        port_dirs["aniso"] / VectorIndex(port_dirs["aniso"],
                                         device="cpu").segment_names[0])
    assert float(jseg.pqv.pq.aniso_eta) > 1.0


def test_segment_from_numpy_carries_every_state(jax_dirs, corpus, tier):
    """The JAX package's state handed across as numpy arrays searches as
    the segment directory does."""
    for mode in ("nvq", "4bit", "aniso"):
        name = JIndex(jax_dirs[mode]).segment_names[0]
        j = jsegment.read_segment(jax_dirs[mode] / name)
        kw = {}
        if j.nvq is not None:
            kw.update(nvq_bytes=np.asarray(j.nvq.bytes_),
                      nvq_params=np.asarray(j.nvq.params),
                      nvq_global_mean=np.asarray(j.nvq.global_mean))
        if j.scalar_state is not None:
            kw.update(scalar_bits=j.scalar_state.bits,
                      scalar_thresholds=j.scalar_state.thresholds,
                      scalar_codes=np.asarray(j.scalar_codes))
        if j.pqv is not None:
            kw.update(codebooks=np.asarray(j.pqv.pq.codebooks),
                      center=np.asarray(j.pqv.pq.center),
                      codes=np.asarray(j.pqv.codes),
                      aniso_eta=(None if j.pqv.pq.aniso_eta is None
                                 else np.asarray(j.pqv.pq.aniso_eta)))
        seg = segment_from_numpy(
            name, j.config.to_meta(), np.asarray(j.graph.adjacency),
            np.asarray(j.graph.degrees), np.asarray(j.graph.live),
            j.graph.entry, j.docmap.ord_to_doc,
            vectors=None if j.vectors is None else np.asarray(j.vectors),
            **kw, device="cpu")
        sc = tconfig.SearchConfig(k=K)
        want = SegmentReader.open(jax_dirs[mode] / name, "cpu").search(
            corpus[1], sc)
        got = SegmentReader(seg).search(corpus[1], sc)
        np.testing.assert_array_equal(got.doc_ids, want.doc_ids)
        np.testing.assert_array_equal(got.scores, want.scores)
    state, codes = scalar_from_numpy(2, np.zeros((3, 4)), np.zeros((5, 2)),
                                     device="cpu")
    assert state.bits == 2 and codes.dtype == torch.uint8


def test_bwc_v2_scalar_fixture_opens_and_searches():
    seg_dir = FIXTURES / "bwc_v2_segment_root" / "v2seg"
    v = np.load(FIXTURES / "bwc_v2_vectors.npy")
    assert tsegment.check_integrity(seg_dir)
    seg = tsegment.read_segment(seg_dir, "cpu")
    jseg = jsegment.read_segment(seg_dir)
    n = seg.docmap.num_ordinals
    assert seg.quantization_type == jseg.quantization_type
    assert seg.scalar_state.bits == jseg.scalar_state.bits
    np.testing.assert_array_equal(seg.scalar_state.thresholds,
                                  jseg.scalar_state.thresholds)
    np.testing.assert_array_equal(seg.scalar_codes.numpy(),
                                  np.asarray(jseg.scalar_codes))
    np.testing.assert_array_equal(seg.vectors[:n].numpy(), v[:n])
    # the port's encode of the fixture's rows gives the stored codes
    np.testing.assert_array_equal(
        tscalar.quantize_vectors(seg.scalar_state, seg.vectors[:n]).numpy(),
        seg.scalar_codes[:n].numpy())
    res = SegmentReader(seg).search(v[:4], tconfig.SearchConfig(
        k=3, ef_search=32))
    assert (res.doc_ids[np.arange(4), 0] == np.arange(4)).all()
    assert res.reranked > 0


# -- the slice as a whole ---------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_whole_slice_per_mode(mode, corpus, jax_dirs, tmp_path):
    """add -> flush -> search -> delete -> force_merge -> reopen in the
    port; recall against exact ground truth beside the JAX package's on
    the same data."""
    vectors, queries = corpus
    cfg = _tcfg(mode)
    simf = cfg.similarity
    sc = tconfig.SearchConfig(k=K)
    idx = VectorIndex(tmp_path / "t", cfg, device="cpu",
                      merge_policy=TForceOnly())
    _fill(idx, vectors)
    truth = ground_truth_topk(_t(queries), _t(vectors), K, simf)
    res = idx.search(queries, sc)
    recall = recall_at_k(res.doc_ids, truth, K)
    jres = JIndex(jax_dirs[mode]).search(queries, jconfig.SearchConfig(k=K))
    jrecall = recall_at_k(jres.doc_ids, truth, K)
    assert recall >= FLOOR[mode] and abs(recall - jrecall) <= 0.05, (
        recall, jrecall)
    assert res.reranked > 0

    dead = np.arange(0, 300)
    idx.delete(dead)
    merged = idx.force_merge()
    assert idx.segment_names == [merged] and not idx.has_deletes
    seg = idx._reader(merged).seg
    assert seg.quantization_type == MODES[mode].get("quantization_type", "pq")
    files = {p.name for p in (tmp_path / "t" / merged).iterdir()}
    assert "rows.f32" not in files
    if mode.startswith("nvq"):
        assert seg.vectors is None and seg.nvq is not None
        assert seg.nvq.bytes_.shape == (seg.capacity(), D)
    if mode == "aniso":
        assert seg.pqv.pq.aniso_eta > 1.0
    live = np.arange(300, vectors.shape[0])
    truth = live[ground_truth_topk(_t(queries), _t(vectors[live]), K, simf)]
    after = idx.search(queries, sc)
    assert not np.isin(after.doc_ids, dead).any()
    assert recall_at_k(after.doc_ids, truth, K) >= FLOOR[mode] - 0.05
    idx.close()
    again = VectorIndex(tmp_path / "t", device="cpu")
    np.testing.assert_array_equal(again.search(queries, sc).doc_ids,
                                  after.doc_ids)
    # and the JAX package opens what the port merged
    jafter = JIndex(tmp_path / "t").search(queries, jconfig.SearchConfig(k=K))
    assert not np.isin(jafter.doc_ids, dead).any()
    assert abs(recall_at_k(jafter.doc_ids, truth, K)
               - recall_at_k(after.doc_ids, truth, K)) <= 0.05


@pytest.mark.parametrize("mode", ["nvq", "4bit"])
def test_port_merges_a_jax_index(mode, corpus, jax_dirs, tmp_path):
    """A directory the JAX package wrote, merged by the port: NVQ is
    decoded and retrained, scalar thresholds and codes recomputed as the
    reference's own merge computes them."""
    vectors, queries = corpus
    for pkg in ("t", "j"):
        shutil.copytree(jax_dirs[mode], tmp_path / pkg)
    tidx = VectorIndex(tmp_path / "t", device="cpu",
                       merge_policy=TForceOnly())
    jidx = JIndex(tmp_path / "j", merge_policy=ForceMergesOnlyMergePolicy())
    name = tidx.force_merge()
    assert jidx.force_merge() == name
    truth = ground_truth_topk(_t(queries), _t(vectors), K,
                              SimilarityFunction.EUCLIDEAN)
    tr = recall_at_k(tidx.search(queries, tconfig.SearchConfig(k=K)).doc_ids,
                     truth, K)
    jr = recall_at_k(jidx.search(queries, jconfig.SearchConfig(k=K)).doc_ids,
                     truth, K)
    assert tr >= FLOOR[mode] and abs(tr - jr) <= 0.05, (tr, jr)
    if mode == "4bit":
        # an incremental merge keeps the lead's ordinals, so both packages
        # quantize the same rows in the same order
        assert ((tmp_path / "t" / name / "scalar.jvtpu").read_bytes()
                == (tmp_path / "j" / name / "scalar.jvtpu").read_bytes())


def test_rerank_floor_and_threshold_cut(corpus, port_dirs, tier):
    """`rerank_floor` keeps candidates whose approximate score misses it
    out of the rerank; `threshold` cuts the final scores."""
    queries = corpus[1]
    for mode in ("nvq", "4bit"):
        idx = VectorIndex(port_dirs[mode], device="cpu")
        base = idx.search(queries, tconfig.SearchConfig(k=K))
        assert base.reranked > 0
        none = idx.search(queries, tconfig.SearchConfig(k=K,
                                                        rerank_floor=2.0))
        assert none.reranked == 0 and (none.doc_ids == -1).all()
        assert np.isneginf(none.scores).all()
        cut = float(np.median(base.scores))
        kept = idx.search(queries, tconfig.SearchConfig(k=K, threshold=cut))
        assert (kept.scores[kept.doc_ids >= 0] >= cut).all()
        assert 0 < (kept.doc_ids >= 0).sum() < base.doc_ids.size
        # a rising floor qualifies fewer and fewer candidates
        counts = [idx.search(queries, tconfig.SearchConfig(
            k=K, rerank_floor=f)).reranked
            for f in (0.01, 0.02, 0.05, 0.1, 0.2, 0.5)]
        assert counts == sorted(counts, reverse=True)
        assert counts[0] <= base.reranked
        assert any(0 < c < base.reranked for c in counts), counts


def test_nvq_flush_below_the_minimum_batch_keeps_fp32(tmp_path):
    v = _latent(np.random.default_rng(9), 100)
    idx = VectorIndex(tmp_path, _tcfg("nvq_on_disk"), device="cpu")
    idx.add_batch(np.arange(100), v)
    name = idx.flush()
    seg = idx._reader(name).seg
    assert seg.nvq is None and seg.pqv is None and seg.vectors is not None
    res = idx.search(v[:3], tconfig.SearchConfig(k=1))
    assert res.doc_ids[:, 0].tolist() == [0, 1, 2]
