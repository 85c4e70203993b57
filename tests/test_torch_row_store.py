"""The port's host row store (`csrc/vector_store.cpp`) and the on_disk
rerank's reused block buffer.

The native gather is held bit for bit to the numpy memmap path and to the
JAX package's store, over random ids, repeats, `-1` and out-of-range ids,
below and above the 1,024 ids where it starts worker threads; row files
cross between the packages; the on_disk reader answers the same with and
without its per-thread block buffer, from one thread or two.
"""

import os
import threading

import numpy as np
import pytest

from opensearch_jvector_tpu.utils import native_store as jstore
from opensearch_jvector_tpu_torch.api import config as tconfig
from opensearch_jvector_tpu_torch.api.stats import (
    STATS,
    Counter,
    StatsRegistry,
)
from opensearch_jvector_tpu_torch.index import reader as treader
from opensearch_jvector_tpu_torch.index.index import VectorIndex
from opensearch_jvector_tpu_torch.ops import _kernels
from opensearch_jvector_tpu_torch.utils import native_store

N, D = 3000, 40


@pytest.fixture(scope="module")
def rows():
    return np.random.default_rng(0).standard_normal((N, D)).astype(
        np.float32)


@pytest.fixture
def row_file(rows, tmp_path):
    p = tmp_path / "rows.f32"
    native_store.write_row_file(p, rows)
    return p


def _numpy_store(path, monkeypatch):
    """The port's store on its numpy memmap fallback."""
    with monkeypatch.context() as m:
        m.setattr(native_store, "_load_lib", lambda: None)
        store = native_store.PagedVectorStore(path, dim=D)
    assert not store.is_native
    return store


def _ids(n, seed):
    """n ids drawn with repeats, with -1 and ids past the end mixed in."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, n)
    bad = rng.random(n) < 0.05
    ids[bad] = rng.choice([-1, -7, N, N + 5, 1 << 40], int(bad.sum()))
    return ids


def _want(rows, ids):
    ok = (ids >= 0) & (ids < N)
    return np.where(ok[:, None], rows[np.where(ok, ids, 0)], 0.0).astype(
        np.float32)


def test_the_row_store_is_the_ports_own_host_build():
    assert _kernels._source("vector_store") == (
        _kernels.CSRC / "vector_store.cpp")
    assert _kernels._is_host("vector_store")


# 5 and 1,000 ids take one thread, 1,024 and 20,000 the workers
@pytest.mark.parametrize("n", [0, 5, 1000, 1024, 20_000])
def test_gather_is_bit_equal_to_numpy_and_the_jax_store(n, rows, row_file,
                                                        monkeypatch):
    ids = _ids(n, seed=n)
    port = native_store.PagedVectorStore(row_file, dim=D)
    assert port.is_native and port.num_rows == N
    mm = _numpy_store(row_file, monkeypatch)
    jax_store = jstore.PagedVectorStore(row_file, dim=D)
    assert jax_store.is_native
    got = port.gather(ids)
    assert got.shape == (n, D) and got.dtype == np.float32
    want = _want(rows, ids)
    for other in (mm.gather(ids), jax_store.gather(ids), want):
        assert other.tobytes() == got.tobytes()
    for s in (port, mm, jax_store):
        s.close()


@pytest.mark.parametrize("n", [7, 5000])
def test_gather_into_a_callers_buffer(n, rows, row_file, monkeypatch):
    ids = _ids(n, seed=n + 1)
    for store in (native_store.PagedVectorStore(row_file, dim=D),
                  _numpy_store(row_file, monkeypatch)):
        fresh = store.gather(ids)
        buf = np.full(n * D + 13, np.nan, np.float32)  # larger than needed
        got = store.gather(ids, out=buf)
        assert got.shape == (n, D) and np.shares_memory(got, buf)
        assert got.tobytes() == fresh.tobytes() == _want(rows, ids).tobytes()
        assert np.isnan(buf[n * D:]).all()  # nothing past the block
        # a second gather into the same buffer overwrites it whole
        again = store.gather(ids[::-1].copy(), out=buf)
        assert again.tobytes() == _want(rows, ids[::-1]).tobytes()
        store.close()


def test_a_buffer_that_does_not_fit_raises(row_file, monkeypatch):
    ids = np.arange(10)
    for store in (native_store.PagedVectorStore(row_file, dim=D),
                  _numpy_store(row_file, monkeypatch)):
        for bad in (np.empty(10 * D - 1, np.float32),
                    np.empty(10 * D, np.float64),
                    np.empty((10, 2 * D), np.float32)[:, ::2]):
            with pytest.raises(ValueError):
                store.gather(ids, out=bad)
        store.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_row_files_cross_between_the_packages(writer, rows, tmp_path):
    p = tmp_path / "rows.f32"
    (jstore if writer == "jax" else native_store).write_row_file(p, rows)
    ids = _ids(2000, seed=3)
    port = native_store.PagedVectorStore(p, dim=D)
    jax_store = jstore.PagedVectorStore(p, dim=D)
    assert port.num_rows == jax_store.num_rows == N
    assert port.gather(ids).tobytes() == jax_store.gather(ids).tobytes()
    assert native_store.verify_row_file(p)
    port.close()
    jax_store.close()


def _advised():
    return STATS.get(Counter.KNN_QUERY_ROW_STORE_PAGES_ADVISED)


def test_the_gather_counts_the_pages_it_advised(tmp_path):
    """Two rows at either end of a file of 4,096 pages span too many pages
    an id for the mincore check, so each is advised; a cold file (its pages
    dropped from the page cache) has at most every page of a dense gather
    advised (none where the kernel keeps the pages)."""
    big = np.zeros((4096, 1024), np.float32)  # a page a row
    big[:, 0] = np.arange(4096)
    p = tmp_path / "rows.f32"
    native_store.write_row_file(p, big)
    store = native_store.PagedVectorStore(p, dim=1024)
    before = _advised()
    assert store.gather([0, 4095]).tobytes() == big[[0, 4095]].tobytes()
    assert _advised() == before + 2
    store.close()
    fd = os.open(p, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    store = native_store.PagedVectorStore(p, dim=1024)
    before = _advised()
    got = store.gather(np.arange(4096))
    assert got.tobytes() == big.tobytes()
    assert before <= _advised() <= before + 4096
    store.close()


# -- the on_disk reader's block buffer ---------------------------------------

QD, QN = 32, 1200


@pytest.fixture(scope="module")
def on_disk_index(tmp_path_factory):
    rng = np.random.default_rng(1)
    vectors = rng.standard_normal((QN, QD)).astype(np.float32)
    queries = rng.standard_normal((64, QD)).astype(np.float32)
    root = tmp_path_factory.mktemp("on_disk")
    idx = VectorIndex(root, tconfig.DiskAnnConfig(
        dim=QD, m=8, ef_construction=32, num_pq_subspaces=4,
        min_batch_size_for_quantization=128, mode="on_disk",
        index_type="flat"), device="cpu")
    idx.add_batch(np.arange(QN), vectors)
    idx.flush()
    idx.close()
    return root, queries


def _fresh_buffers(monkeypatch):
    monkeypatch.setattr(treader.SegmentReader, "_rerank_buffer",
                        lambda self, size: np.empty(size, np.float32))


# 1, 7 and 64 queries at overquery 5: 50, 350 and 3,200 ids a gather
BATCHES = (1, 7, 64, 7)


def _run(root, queries, stats=None):
    idx = VectorIndex(root, device="cpu", stats=stats or StatsRegistry())
    cfg = tconfig.SearchConfig(k=10)
    out = [idx.search(queries[:q], cfg) for q in BATCHES]
    return idx, out


def _same(a, b):
    assert a.doc_ids.tobytes() == b.doc_ids.tobytes()
    assert a.scores.tobytes() == b.scores.tobytes()


def test_reused_buffer_answers_as_fresh_arrays(on_disk_index, monkeypatch):
    root, queries = on_disk_index
    reg = StatsRegistry()
    idx, got = _run(root, queries, reg)
    reader = idx._reader(idx.segment_names[0])
    assert reader.seg.row_store.is_native
    # 1 -> 7 -> 64 grow the buffer, the last 7 fits in it
    assert reg.get(Counter.KNN_QUERY_RERANK_BUFFER_REUSES) == 1
    assert reader._rerank_blocks.buf.size == 64 * 50 * QD
    assert reg.get(Counter.KNN_QUERY_RERANKED_COUNT) == sum(
        q * 50 for q in BATCHES)
    with monkeypatch.context() as m:
        _fresh_buffers(m)
        want_reg = StatsRegistry()
        _, want = _run(root, queries, want_reg)
        assert want_reg.get(Counter.KNN_QUERY_RERANK_BUFFER_REUSES) == 0
    for a, b in zip(got, want):
        _same(a, b)
    # the results do not alias the buffer: another search leaves them be
    before = got[3].scores.copy()
    idx.search(queries[7:14], tconfig.SearchConfig(k=10))
    assert got[3].scores.tobytes() == before.tobytes()
    assert reg.get(Counter.KNN_QUERY_RERANK_BUFFER_REUSES) == 2
    idx.close()
    assert not hasattr(reader._rerank_blocks, "buf")


def test_two_threads_on_one_reader_answer_as_serial_calls(on_disk_index):
    root, queries = on_disk_index
    idx = VectorIndex(root, device="cpu", stats=StatsRegistry())
    cfg = tconfig.SearchConfig(k=10)
    plans = [[(0, 64), (3, 10), (0, 1), (20, 60)],
             [(1, 8), (0, 64), (5, 6), (30, 64)]]
    serial = [[idx.search(queries[a:b], cfg) for a, b in plan]
              for plan in plans]
    got = [None, None]
    start = threading.Barrier(2)

    def work(t):
        start.wait()
        got[t] = [idx.search(queries[a:b], cfg) for _ in range(3)
                  for a, b in plans[t]]

    threads = [threading.Thread(target=work, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for t in range(2):
        for i, res in enumerate(got[t]):
            _same(res, serial[t][i % len(plans[t])])
    idx.close()
