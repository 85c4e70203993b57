"""The arithmetic of the yardstick: the whole-call window, percentiles over
every call, the device's idle share as a union of intervals, the trace's
attribution of device time and idle gaps, rooflines from shapes, and the
seeded data."""

import numpy as np
import pytest
import torch

from portbench.data import LatentData
from portbench.trace import Trace, gaps, idle_percent, union_seconds
from portbench.window import Window, percentile
from portbench.work import peaks, roofline


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_window_is_whole_calls():
    clock = FakeClock()
    win = Window(10.0, clock)
    win.open()
    n = 0
    while win.more():  # calls of 3 s: the fourth starts at 9 s
        start = clock.t
        clock.t += 3.0
        win.record(start, clock.t)
        n += 1
    assert n == 4
    assert win.window_s == pytest.approx(12.0)  # ends when the last returns
    assert win.latencies() == [3.0] * 4


@pytest.mark.parametrize("q", [0.0, 50.0, 95.0, 99.0, 100.0])
def test_percentile_over_every_call_matches_numpy(q):
    rng = np.random.default_rng(3)
    x = rng.exponential(size=1001).tolist()
    assert percentile(x, q) == pytest.approx(np.percentile(x, q))
    assert percentile([7.0], q) == 7.0


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.8), (9, 12)]
    assert union_seconds(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert union_seconds(iv, 1.5, 5.5) == pytest.approx(1.5 + 0.5)
    assert gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert gaps([], 0, 1) == [(0, 1)]


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic_trace() -> Trace:
    return Trace({"traceEvents": [
        _ev("user_annotation", "ProfilerStep#0", 0, 50),
        _ev("user_annotation", "ProfilerStep#1", 100, 1000),
        _ev("user_annotation", "ProfilerStep#2", 1100, 0),
        _ev("user_annotation", "approximate", 110, 300),
        _ev("user_annotation", "rerank_score", 500, 400),
        _ev("cpu_op", "aten::mm", 120, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 125, 2, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 300, 2, corr=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 950, 2, corr=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 301, 2, tid=2, corr=4),
        _ev("kernel", "beam_search_kernel", 130, 100, tid=7, corr=1),
        _ev("kernel", "gemm", 180, 100, tid=7, corr=2),   # overlaps
        _ev("gpu_memcpy", "Memcpy DtoH", 960, 40, tid=7, corr=3),
        _ev("kernel", "other", 1050, 100, tid=8, corr=4),  # past the end
    ]})


def test_trace_busy_idle_and_ranges():
    t = synthetic_trace()
    assert t.window_s == pytest.approx(1000e-6)  # the longest step
    # union: [130, 280) + [960, 1000) + [1050, 1100) = 150 + 40 + 50
    assert t.busy_s == pytest.approx(240e-6)
    assert idle_percent(t) == pytest.approx(76.0)
    assert idle_percent(None) is None
    assert t.device_time("beam_search") == pytest.approx(100e-6)
    # launched inside `approximate` on its thread: corr 1 and 2, not 4
    assert t.device_time_in_range("approximate") == pytest.approx(200e-6)
    assert t.range_time("rerank_score") == (pytest.approx(400e-6), 1)
    ops = dict(t.top_device_ops())
    assert ops["gemm"] == pytest.approx(100e-6)
    idle = dict(t.idle_gaps())
    # gaps [100,130) approximate, [280,960) mid 620: rerank_score,
    # [1000,1050) mid 1025: no range
    assert idle["approximate"] == pytest.approx(30e-6)
    assert idle["rerank_score"] == pytest.approx(680e-6)
    assert idle["(no host range)"] == pytest.approx(50e-6)


def test_the_benchmark_active_range_is_the_window():
    events = synthetic_trace()
    doc = {"traceEvents": [
        _ev("user_annotation", "ProfilerStep#1", 100, 1000),
        _ev("user_annotation", "portbench.active", 120, 500),
        _ev("kernel", "k", 100, 100, tid=7)]}
    t = Trace(doc)
    assert (t.lo, t.hi) == (120, 620)
    assert t.busy_s == pytest.approx(80e-6)
    assert dict(t.idle_gaps()) == {"(no host range)": pytest.approx(420e-6)}
    assert events.window_s > 0


def test_rooflines_from_shapes():
    nbytes = roofline.beam_search_bytes(visited=1000, expanded=100,
                                        queries=2, dim=128, degree=32,
                                        pool=200)
    assert nbytes == 1000 * 512 + 100 * 128 + 2 * 512 + 2 * 200 * 12
    assert roofline.least_seconds(nbytes) == pytest.approx(
        nbytes / peaks.BYTES_S)
    ops = roofline.scan_ops(500, 500_000, 960)
    assert ops == 2 * 500 * 500_000 * 960
    b = roofline.pq_scan_bytes(500, 500_000, 960, 64)
    assert b == 500_000 * 64 + 256 * 960 * 4 + 500 * 960 * 4
    # a dense 960-d scan is bound by its operations, not its bytes
    assert roofline.least_seconds(b, ops) == pytest.approx(
        ops / peaks.BF16_FLOP_S)


SPEC = {"dim": 24, "latent": 4, "noise": 0.05}


def test_data_is_a_function_of_the_seed():
    a, b = LatentData(SPEC, 2**31 + 5, "cpu"), LatentData(SPEC, 2**31 + 5,
                                                          "cpu")
    np.testing.assert_array_equal(a.rows(1000), b.rows(1000))
    np.testing.assert_array_equal(a.queries(50), b.queries(50))
    c = LatentData(SPEC, 2**31 + 6, "cpu")
    assert not np.array_equal(a.rows(1000), c.rows(1000))
    assert a.rows(10).dtype == np.float32 and a.rows(10).shape == (10, 24)


def test_a_longer_draw_starts_with_the_shorter(monkeypatch):
    import portbench.data as data

    monkeypatch.setattr(data, "ROW_BLOCK", 64)
    d = LatentData(SPEC, 12345, "cpu")
    long = d.rows(300)
    np.testing.assert_array_equal(long[:100], d.rows(100))
    # rows lie near the latent subspace: the noise is what is left
    resid = long - long @ np.linalg.pinv(d.basis.numpy()) @ d.basis.numpy()
    assert resid.std() == pytest.approx(0.05, rel=0.2)
    assert not torch.backends.cuda.matmul.allow_tf32
