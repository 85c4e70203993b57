"""Port parity: product quantization and k-means of the PyTorch package
against the JAX package.

Encoding, decoding, query LUTs and the ADC scan are compared exactly on
JAX-trained codebooks handed across as numpy arrays. Training draws its
k-means++ seeds from another generator (jax.random cannot be reproduced),
so trained codebooks are compared by reconstruction error within a band.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.models import pq as jpq
from opensearch_jvector_tpu.ops import kmeans as jkm
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu_torch.convert import pq_from_numpy
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.ops import kmeans as tkm
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

torch.set_num_threads(2)

N, D, M = 2000, 32, 8
SIMFS = list(SimilarityFunction)


def _latent(rng, n, d=D):
    a = rng.standard_normal((8, d)).astype(np.float32) / np.sqrt(8)
    return (rng.standard_normal((n, 8)).astype(np.float32) @ a
            + 0.05 * rng.standard_normal((n, d))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    return _latent(rng, N), _latent(rng, 16)


@pytest.fixture(scope="module")
def jax_pqs(corpus):
    vectors, _ = corpus
    return {simf: jpq.train_pq(jnp.asarray(vectors), JSim(simf.value),
                               num_subspaces=M)
            for simf in SIMFS}


def _port_pq(jq):
    return pq_from_numpy(np.asarray(jq.codebooks), np.asarray(jq.center),
                         device="cpu")


def test_default_num_subspaces_identical():
    for d in range(1, 2049):
        assert tpq.default_num_subspaces(d) == jpq.default_num_subspaces(d)


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_encode_identical_under_jax_codebooks(simf, corpus, jax_pqs):
    vectors, _ = corpus
    jq = jax_pqs[simf]
    want = np.asarray(jpq.encode(jq, jnp.asarray(vectors), JSim(simf.value)))
    got = tpq.encode(_port_pq(jq), torch.from_numpy(vectors), simf).numpy()
    assert got.dtype == np.uint8 and got.shape == (N, M)
    np.testing.assert_array_equal(got, want)


def test_encode_slabs_do_not_change_codes(corpus, jax_pqs, monkeypatch):
    vectors, _ = corpus
    pq = _port_pq(jax_pqs[SimilarityFunction.EUCLIDEAN])
    whole = tpq.encode_pq(pq, torch.from_numpy(vectors))
    monkeypatch.setattr(tpq, "ENCODE_SLAB_BYTES", 300 * M * 256 * 4)
    np.testing.assert_array_equal(
        tpq.encode_pq(pq, torch.from_numpy(vectors)).numpy(), whole.numpy())


@pytest.mark.parametrize("simf", SIMFS, ids=lambda s: s.name)
def test_luts_scan_and_decode_match(simf, corpus, jax_pqs):
    vectors, queries = corpus
    jq = jax_pqs[simf]
    codes = np.array(jpq.encode(jq, jnp.asarray(vectors), JSim(simf.value)))
    jv = jpq.PQVectors(pq=jq, codes=jnp.asarray(codes))
    tv = tpq.PQVectors(pq=_port_pq(jq), codes=torch.from_numpy(codes))
    q = torch.from_numpy(queries)
    np.testing.assert_allclose(
        tv.build_query_luts(q, simf).numpy(),
        np.asarray(jv.build_query_luts(jnp.asarray(queries),
                                       JSim(simf.value))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tv.score_scan(q, simf, lo=5, hi=1500).numpy(),
        np.asarray(jv.score_scan(jnp.asarray(queries), JSim(simf.value),
                                 lo=5, hi=1500)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.decode().numpy(), np.asarray(jv.decode()),
                               rtol=1e-6, atol=1e-6)


def _mse(pq_codes_decoded, vectors):
    return float(np.mean((pq_codes_decoded - vectors) ** 2))


def test_train_pq_reconstruction_within_band(corpus, jax_pqs):
    """Same data, same schedule: the port's codebooks reconstruct the
    corpus within 5 % of the reference's mean squared error."""
    vectors, _ = corpus
    simf = SimilarityFunction.EUCLIDEAN
    jq = jax_pqs[simf]
    jcodes = jpq.encode(jq, jnp.asarray(vectors), JSim.EUCLIDEAN)
    jmse = _mse(np.asarray(jpq.PQVectors(pq=jq, codes=jcodes).decode()),
                vectors)
    tq = tpq.train_pq(torch.from_numpy(vectors), simf, num_subspaces=M)
    assert tuple(tq.codebooks.shape) == tuple(jq.codebooks.shape)
    np.testing.assert_allclose(tq.center.numpy(), np.asarray(jq.center),
                               rtol=1e-5, atol=1e-6)
    tcodes = tpq.encode(tq, torch.from_numpy(vectors), simf)
    tmse = _mse(tpq.PQVectors(pq=tq, codes=tcodes).decode().numpy(), vectors)
    assert abs(tmse - jmse) <= 0.05 * jmse, (tmse, jmse)


def test_train_pq_small_corpus_and_sampling():
    """K = min(256, n) below 256 rows; a sampled training set above
    max_train keeps the center of ALL rows."""
    rng = np.random.default_rng(3)
    small = _latent(rng, 100, 16)
    tq = tpq.train_pq(torch.from_numpy(small), SimilarityFunction.EUCLIDEAN)
    jq = jpq.train_pq(jnp.asarray(small), JSim.EUCLIDEAN)
    assert tuple(tq.codebooks.shape) == tuple(jq.codebooks.shape)
    big = _latent(rng, 600, 16)
    tq = tpq.train_pq(torch.from_numpy(big), SimilarityFunction.EUCLIDEAN,
                      num_subspaces=4, max_train=300)
    np.testing.assert_allclose(tq.center.numpy(), big.mean(0), rtol=1e-5,
                               atol=1e-6)


def test_lloyd_iter_matches_from_same_centroids():
    """One Lloyd step from the same seeds gives the same centroids."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 500, 4)).astype(np.float32)
    c0 = x[:, :16].copy()
    want = np.stack([np.asarray(jkm._lloyd_iter(jnp.asarray(x[i]),
                                                jnp.asarray(c0[i])))
                     for i in range(3)])
    got = tkm._lloyd_iter(torch.from_numpy(x), torch.from_numpy(c0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_kmeanspp_seeds_are_corpus_rows_and_seeded():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 300, 4)).astype(np.float32))
    a = tkm.train_kmeans_subspaces(x, 16, iters=0,
                                   gen=torch.Generator().manual_seed(7))
    b = tkm.train_kmeans_subspaces(x, 16, iters=0,
                                   gen=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for m in range(2):
        is_row = (a[m][:, None, :] == x[m][None, :, :]).all(-1).any(1)
        assert bool(is_row.all())
        assert torch.unique(a[m], dim=0).shape[0] == 16
