"""Port parity: the fused decode-then-score scan and the PQ pieces of the
on_disk tier against the JAX package.

`decode_scan` on CPU tensors runs its plain version; it is compared with
the JAX `fused_decode_scan` (interpreted on the CPU, as the JAX package's
own tests run it) at that file's five shapes and tolerance, and with an
unrounded float32 oracle within the stated per-element bound. Chunked
`decode` / `decode_bf16`, host-corpus `train_pq` and the streamed encode
are compared with the JAX functions on the same inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.models import pq as jpq
from opensearch_jvector_tpu.ops import adc as jadc
from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu.ops.pallas.pq_scan_kernel import fused_decode_scan
from opensearch_jvector_tpu_torch.convert import pq_from_numpy
from opensearch_jvector_tpu_torch.index.reader import _euclidean_fold
from opensearch_jvector_tpu_torch.models import pq as tpq
from opensearch_jvector_tpu_torch.ops.adc import lookup_scan
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import (
    decode_scan,
    decode_scan_reference,
    kernel_error_bound,
)

torch.set_num_threads(2)

# the five shapes of tests/test_pq_scan_kernel.py, plus the ragged and odd
# shapes the card checks use
SHAPES = [
    (300, 7, 64, 256, 2),
    (257, 16, 192, 256, 5),
    (64, 3, 8, 16, 8),
    (1030, 130, 12, 256, 16),
    (16, 1, 6, 256, 21),
]


def _inputs(n, qn, m, k, dsub, seed=7):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    codebooks = rng.standard_normal((m, k, dsub)).astype(np.float32)
    q = rng.standard_normal((qn, m * dsub)).astype(np.float32)
    return q, codes, codebooks


def _f32_oracle(q, codes, codebooks):
    m = codebooks.shape[0]
    dec = codebooks[np.arange(m)[None, :], codes.astype(np.int64)]
    return q.astype(np.float64) @ dec.reshape(codes.shape[0], -1).T


@pytest.mark.parametrize("n,qn,m,k,dsub", SHAPES)
def test_decode_scan_matches_jax_kernel(n, qn, m, k, dsub):
    q, codes, codebooks = _inputs(n, qn, m, k, dsub)
    got = decode_scan(torch.from_numpy(q), torch.from_numpy(codes),
                      torch.from_numpy(codebooks))
    assert got.shape == (qn, n) and got.dtype == torch.float32
    want = np.asarray(fused_decode_scan(jnp.asarray(q), jnp.asarray(codes),
                                        jnp.asarray(codebooks)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n,qn,m,k,dsub", SHAPES + [(1000, 3, 8, 64, 21),
                                                    (500, 1, 64, 256, 2)])
def test_decode_scan_within_bound_of_f32_oracle(n, qn, m, k, dsub):
    """Every element within 2^-7 * sum_j |q_j||dec_j| of the unrounded
    product: the bound the card holds the kernel to."""
    q, codes, codebooks = _inputs(n, qn, m, k, dsub, seed=n)
    args = (torch.from_numpy(q), torch.from_numpy(codes),
            torch.from_numpy(codebooks))
    err = np.abs(decode_scan(*args).numpy() - _f32_oracle(q, codes,
                                                          codebooks))
    bound = kernel_error_bound(*args).numpy()
    assert (err <= bound).all()
    assert (bound > 0).all()


def test_pad_codes_decode_to_zero():
    """A code >= K reads no codebook entry (the kernel's zero slots)."""
    q, codes, codebooks = _inputs(40, 3, 4, 16, 3)
    codes[::3, 1] = 200
    got = decode_scan_reference(torch.from_numpy(q), torch.from_numpy(codes),
                                torch.from_numpy(codebooks)).numpy()
    dec = codebooks[np.arange(4)[None, :], np.minimum(codes, 15)]
    dec[::3, 1] = 0.0
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    want = bf(q) @ bf(dec.reshape(40, -1)).T
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_plain_version_rows_chunking(monkeypatch):
    from opensearch_jvector_tpu_torch.ops import pq_scan_kernel

    q, codes, codebooks = _inputs(1030, 5, 12, 256, 4)
    args = (torch.from_numpy(q), torch.from_numpy(codes),
            torch.from_numpy(codebooks))
    whole = decode_scan_reference(*args)
    monkeypatch.setattr(pq_scan_kernel, "REF_ROWS", 100)
    torch.testing.assert_close(decode_scan_reference(*args), whole,
                               rtol=0, atol=0)


def test_euclidean_fold_matches_lut_scan():
    """max(q2 + codes_sq - 2*ip, 0) over the plain decode scan reproduces
    the LUT ADC distances (the reader's codes-only fused rung), and the
    JAX fold on the JAX kernel."""
    q, codes, codebooks = _inputs(120, 5, 16, 64, 4, seed=3)
    tq, tc, tcb = (torch.from_numpy(a) for a in (q, codes, codebooks))
    ip = decode_scan(tq, tc, tcb)
    codes_sq = lookup_scan(torch.sum(tcb * tcb, -1)[None], tc)[0]
    scores = _euclidean_fold(torch.sum(tq * tq, -1), codes_sq, ip.clone())
    d2 = 1.0 / scores.numpy() - 1.0
    lut_d2 = np.asarray(jadc.lookup_scan(
        jadc.build_luts(jnp.asarray(q.reshape(5, 16, 4)),
                        jnp.asarray(codebooks), euclidean=True),
        jnp.asarray(codes.astype(np.int32))))
    np.testing.assert_allclose(d2, lut_d2, rtol=5e-2, atol=5e-2)
    jip = np.asarray(fused_decode_scan(jnp.asarray(q), jnp.asarray(codes),
                                       jnp.asarray(codebooks)))
    jsq = (codebooks * codebooks).sum(-1)[np.arange(16)[None, :],
                                          codes.astype(np.int64)].sum(1)
    jd2 = np.maximum((q * q).sum(-1)[:, None] + jsq[None, :] - 2.0 * jip, 0)
    np.testing.assert_allclose(1.0 / (1.0 + jd2), scores.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def host_corpus():
    rng = np.random.default_rng(11)
    a = rng.standard_normal((8, 32)).astype(np.float32) / np.sqrt(8)
    return (rng.standard_normal((3000, 8)).astype(np.float32) @ a
            + 0.05 * rng.standard_normal((3000, 32))).astype(np.float32)


def test_train_pq_host_corpus_samples_before_centering(host_corpus):
    """A host (numpy) corpus above max_train: both packages sample the
    same rows on the host first, so the center is the SAMPLE mean."""
    jq = jpq.train_pq(host_corpus, JSim.EUCLIDEAN, num_subspaces=8,
                      max_train=1000)
    tq = tpq.train_pq(host_corpus, SimilarityFunction.EUCLIDEAN,
                      num_subspaces=8, max_train=1000, device="cpu")
    np.testing.assert_allclose(tq.center.numpy(), np.asarray(jq.center),
                               rtol=1e-5, atol=1e-6)
    assert not np.allclose(tq.center.numpy(), host_corpus.mean(0),
                           rtol=1e-4, atol=1e-4)
    assert tuple(tq.codebooks.shape) == tuple(jq.codebooks.shape)


@pytest.mark.parametrize("simf", list(SimilarityFunction),
                         ids=lambda s: s.name)
def test_streamed_host_encode_identical_under_jax_codebooks(
        simf, host_corpus, monkeypatch):
    jq = jpq.train_pq(host_corpus, JSim(simf.value), num_subspaces=8,
                      max_train=1000)
    want = np.asarray(jpq.encode(jq, jnp.asarray(host_corpus),
                                 JSim(simf.value)))
    monkeypatch.setattr(tpq, "HOST_ENCODE_ROWS", 700)  # ragged chunks
    pq = pq_from_numpy(np.asarray(jq.codebooks), np.asarray(jq.center),
                       device="cpu")
    got = tpq.encode(pq, host_corpus, simf)
    np.testing.assert_array_equal(got.numpy(), want)


def test_chunked_decode_matches_jax(host_corpus, monkeypatch):
    jq = jpq.train_pq(host_corpus, JSim.EUCLIDEAN, num_subspaces=8,
                      max_train=1000)
    codes = np.array(jpq.encode(jq, jnp.asarray(host_corpus),
                                JSim.EUCLIDEAN))
    jv = jpq.PQVectors(pq=jq, codes=jnp.asarray(codes))
    tv = tpq.PQVectors(pq=pq_from_numpy(np.asarray(jq.codebooks),
                                        np.asarray(jq.center), device="cpu"),
                       codes=torch.from_numpy(codes))
    monkeypatch.setattr(tpq, "DECODE_ROWS", 1024)  # 3 chunks, ragged tail
    np.testing.assert_allclose(tv.decode().numpy(), np.asarray(jv.decode()),
                               rtol=1e-6, atol=1e-6)
    got = tv.decode_bf16()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(),
        np.asarray(jv.decode_bf16()).astype(np.float32))
