#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card.

    python3 chip_smoke.py [--n 1000000] [--queries 10000] [--seed 0]

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: card name, and name + power limit as nvidia-smi reports them;
  2. build: compile the CUDA kernels from the sources in this checkout;
  3. kernels: every kernel of the path against its plain PyTorch version
     at the main path's shape and at a ragged shape, with both times;
  4. main path: VectorIndex(DiskAnnConfig(dim=128)) on "cuda", add_batch +
     flush of the corpus in 4 flushes (4 segments that each take the scan
     tier), batched search at k=10, recall@10 against exact ground truth
     computed on the card, peak device memory, kernel launch counts;
  5. reopen: the index directory reopened from commits.json returns the
     same top-10 ids.
The corpus is the latent-16 "sift-like" generator of bench.py (make_data),
made with numpy from --seed. The last two lines are the kernel JSON record
and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

RECALL_TARGET = 0.95  # BASELINE.json's recall@10 target
# the cell: SIFT1M-wide rows in the default disk_ann config, flushed as 4
# segments of capacity 2^18 (each takes the scan tier, so the kernel),
# searched in 512-query batches at k=10
DIM = 128
FLUSHES = 4
BATCH = 512
K = 10


def log(msg: str) -> None:
    print(msg, flush=True)


def make_data(rng, n: int, q: int, dim: int):
    """Latent-16 corpus + queries (bench.py make_data, 'sift-like')."""
    latent = 16
    a = rng.standard_normal((latent, dim)).astype(np.float32) / np.sqrt(latent)
    vectors = (rng.standard_normal((n, latent)).astype(np.float32) @ a
               + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    queries = (rng.standard_normal((q, latent)).astype(np.float32) @ a
               + 0.05 * rng.standard_normal((q, dim)).astype(np.float32))
    return vectors.astype(np.float32), queries.astype(np.float32)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (after one)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_adc_scan(q, m, k, n, seed, reps, plain_reps):
    """adc_scan kernel vs lookup_scan on the card -> (max_abs_err, ms,
    plain_ms)."""
    from opensearch_jvector_tpu_torch.ops.adc import lookup_scan
    from opensearch_jvector_tpu_torch.ops.adc_kernel import (
        adc_scan,
        kernel_error_bound,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    # squared-distance-like tables (non-negative), byte codes below K
    luts = 2.0 * torch.rand((q, m, k), generator=gen, device="cuda")
    codes = torch.randint(0, k, (n, m), generator=gen, device="cuda",
                          dtype=torch.uint8)
    out = adc_scan(luts, codes)
    ref = lookup_scan(luts, codes)
    torch.cuda.synchronize()
    assert out.shape == (q, n) and out.dtype == torch.float32
    err = (out - ref).abs()
    bound = kernel_error_bound(luts, codes)
    bad = int((err > bound).sum())
    max_err = float(err.max())
    log(f"  adc_scan Q={q} M={m} K={k} N={n}: max_abs_err={max_err:.3e}, "
        f"largest share of the bound 2^-8*sum|lut| "
        f"{float((err / bound).max()):.3f}, out of bound: {bad}")
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"adc_scan disagrees with lookup_scan at "
                             f"Q={q} M={m} K={k} N={n}")
    ms = cuda_ms(lambda: adc_scan(luts, codes), reps)
    plain_ms = cuda_ms(lambda: lookup_scan(luts, codes), plain_reps)
    log(f"  adc_scan {ms:.4f} ms, plain lookup_scan {plain_ms:.4f} ms")
    return max_err, ms, plain_ms


def profile_batch(index, queries, sc) -> None:
    """Where one search batch's time goes: device time by kernel and the
    device's busy share of the batch's wall time (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        index.search(queries, sc)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    # device-only rows (kernels, copies); CPU-side ops and the "query"
    # phase annotation would count their kernels' time twice
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.key != "query"]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile of one {queries.shape[0]}-query batch: wall "
        f"{wall_us / 1000:.3f} ms, device busy {busy / 1000:.3f} ms "
        f"({100 * busy / wall_us:.1f}% of wall)")
    for us, key, count in rows[:8]:
        log(f"    {us / 1000:9.3f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    # ---- 1. device -------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from opensearch_jvector_tpu_torch.api.config import (
        DiskAnnConfig,
        SearchConfig,
    )
    from opensearch_jvector_tpu_torch.api.stats import Counter
    from opensearch_jvector_tpu_torch.index.index import VectorIndex
    from opensearch_jvector_tpu_torch.models.pq import default_num_subspaces
    from opensearch_jvector_tpu_torch.ops import _kernels
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
        recall_at_k,
    )

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1/5] device: {kind} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    lib = _kernels.build("adc_scan")
    log(f"[2/5] build: {lib.name} in {time.monotonic() - t0:.1f} s")
    for line in _kernels.BUILD_LOGS.get("adc_scan", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels vs plain ----------------------------------------------
    log("[3/5] kernels vs plain PyTorch on the card")
    m = default_num_subspaces(DIM)  # the subspaces the flushes train
    max_err, ms, plain_ms = check_adc_scan(
        BATCH, m, 256, 1 << 18, args.seed, reps=20, plain_reps=3)
    check_adc_scan(3, 8, 64, 1000, args.seed + 1, reps=20, plain_reps=20)

    # ---- 4. main path -------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    vectors, queries = make_data(rng, args.n, args.queries, DIM)
    sc = SearchConfig(k=K)
    log(f"[4/5] main path: {args.n} x {DIM} in {FLUSHES} flushes, "
        f"{args.queries} queries in batches of {BATCH}, k={K}")
    torch.cuda.reset_peak_memory_stats()
    adc_scan.launches = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        index = VectorIndex(root, DiskAnnConfig(dim=DIM), device="cuda")
        bounds = np.linspace(0, args.n, FLUSHES + 1).astype(int)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            before = index.stats.snapshot()
            t0 = time.monotonic()
            index.add_batch(np.arange(lo, hi), vectors[lo:hi])
            name = index.flush()
            torch.cuda.synchronize()
            dt = time.monotonic() - t0
            after = index.stats.snapshot()
            pq_ms, build_ms = (after[c.value] - before[c.value] for c in (
                Counter.KNN_QUANTIZATION_TRAINING_TIME,
                Counter.KNN_GRAPH_BUILD_TIME))
            log(f"  flush {name}: {hi - lo} vectors in {dt:.2f} s = "
                f"{(hi - lo) / dt:.0f} vec/s (PQ train+encode {pq_ms} ms, "
                f"graph build {build_ms} ms)")

        def search_all(idx):
            ids, scores = [], []
            for s in range(0, args.queries, BATCH):
                res = idx.search(queries[s: s + BATCH], sc)
                ids.append(res.doc_ids)
                scores.append(res.scores)
            return np.concatenate(ids), np.concatenate(scores)

        index.search(queries[: BATCH], sc)  # warm: segment loads
        torch.cuda.synchronize()
        t0 = time.monotonic()
        ids, scores = search_all(index)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = adc_scan.launches
        peak = torch.cuda.max_memory_allocated()
        assert ids.shape == (args.queries, K)
        assert np.isfinite(scores).all() and (ids >= 0).all()

        gt = ground_truth_topk(
            torch.as_tensor(queries, device="cuda"),
            torch.as_tensor(vectors, device="cuda"),
            K, SimilarityFunction.EUCLIDEAN)
        recall = recall_at_k(ids, gt, K)
        log(f"  search: {1000 * wall / args.queries:.5f} ms/query batched "
            f"({wall:.3f} s for {args.queries})")
        log(f"  recall@{K} = {recall:.4f} (target {RECALL_TARGET})")
        log(f"  peak device memory (max_memory_allocated): {peak} B "
            f"= {peak / 2**30:.2f} GiB")
        log(f"  adc_scan launches on the main path: {launches}")
        profile_batch(index, queries[: BATCH], sc)
        if recall < RECALL_TARGET:
            raise AssertionError(f"recall@{K} {recall} < {RECALL_TARGET}")
        if launches <= 0:
            raise AssertionError("the search path never launched adc_scan")

        # ---- 5. reopen -------------------------------------------------------
        index.close()
        reopened = VectorIndex(root, device="cuda")
        again = reopened.search(queries[: BATCH], sc).doc_ids
        same = bool((again == ids[: BATCH]).all())
        log(f"[5/5] reopen from commits.json: {len(reopened.segment_names)} "
            f"segments, identical top-{K} ids for {BATCH} "
            f"queries: {same}")
        if not same:
            raise AssertionError("reopened index returned other ids")

    print(json.dumps({"kernels": [{
        "name": "adc_scan",
        "route": "cuda",
        "source": "opensearch_jvector_tpu_torch/csrc/adc_scan.cu",
        "replaces": "opensearch_jvector_tpu/ops/pallas/adc_kernel.py:61",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
