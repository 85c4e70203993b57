"""Ground truth of the port (`utils/ground_truth.py`) against the JAX
package's: the one-shot scan, the blocked scan (`block=`) and the stream
over lazily made corpus blocks (`ground_truth_topk_stream`) return the
JAX package's `ground_truth_topk` ids exactly on Gaussian data (no ties),
at ragged final blocks and a block of one row, and the stream pulls its
producer one block at a time.
"""

import numpy as np
import pytest
import torch

from opensearch_jvector_tpu.ops.distances import SimilarityFunction as JSim
from opensearch_jvector_tpu.utils import ground_truth as jgt
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
from opensearch_jvector_tpu_torch.utils.ground_truth import (
    ground_truth_topk,
    ground_truth_topk_stream,
)

torch.set_num_threads(2)


def _data(seed, n, q, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((q, d)).astype(np.float32))


@pytest.mark.parametrize("n,block", [(300, 64), (256, 64), (300, 300),
                                     (300, 299)])
def test_stream_matches_oneshot_and_the_reference(n, block):
    v, q = _data(0, n, 9, 24)
    want = jgt.ground_truth_topk(q, v, 10, JSim.EUCLIDEAN)
    simf = SimilarityFunction.EUCLIDEAN
    qt = torch.from_numpy(q)
    got = ground_truth_topk_stream(
        qt, ((s, v[s: s + block]) for s in range(0, n, block)), 10, simf)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ground_truth_topk(qt, torch.from_numpy(v), 10, simf), want)


@pytest.mark.parametrize("simf", list(SimilarityFunction), ids=str)
def test_blocked_oneshot_agree_via_block_param(simf):
    v, q = _data(1, 500, 7, 16)
    want = jgt.ground_truth_topk(q, v, 5, JSim(simf.value))
    qt, vt = torch.from_numpy(q), torch.from_numpy(v)
    np.testing.assert_array_equal(ground_truth_topk(qt, vt, 5, simf), want)
    np.testing.assert_array_equal(
        ground_truth_topk(qt, vt, 5, simf, block=128), want)
    np.testing.assert_array_equal(
        jgt.ground_truth_topk(q, v, 5, JSim(simf.value), block=128), want)


def test_stream_producer_is_lazy():
    """The producer is pulled one block at a time, not drained up front."""
    v, q = _data(2, 200, 4, 16)
    pulled = []

    def produce():
        for s in range(0, 200, 50):
            pulled.append(s)
            yield s, v[s: s + 50]

    got = ground_truth_topk_stream(torch.from_numpy(q), produce(), 8,
                                   SimilarityFunction.EUCLIDEAN)
    assert pulled == [0, 50, 100, 150]
    np.testing.assert_array_equal(
        got, jgt.ground_truth_topk(q, v, 8, JSim.EUCLIDEAN))
