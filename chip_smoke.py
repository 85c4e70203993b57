#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py [--n 1000000] [--queries 10000] [--seed 0]

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: card name, and name + power limit as nvidia-smi reports them;
  2. build: compile the CUDA kernels and the host row store from the
     sources in this checkout, all compilers started together, with
     ptxas's registers and spills of every kernel and the count of tensor-core
     (HMMA) instructions in decode_scan_kernel's SASS where cuobjdump is
     found;
  3. kernels: every kernel against its plain PyTorch version at the main
     paths' shapes and at ragged shapes, with the kernel's time, the plain
     version's, one library call computing the same function, and the
     bound the card's peak rates set; adc_scan also in its fused mode (score
     map and validity mask in the epilogue) at the in_memory cell, held to
     the plain version and, exactly, to the raw kernel mapped and masked;
  4. in_memory path: VectorIndex(DiskAnnConfig(dim=128)) on "cuda",
     add_batch + flush of --n rows in 4 flushes (4 segments that each take
     the scan tier), batched search at k=10, recall@10 against exact
     ground truth computed on the card, peak device memory, launches;
  5. reopen: the index directory reopened from commits.json returns the
     same top-10 ids;
  6. on_disk flat, GIST1M-shaped: 1,000,000 x 960 rows, PQ64, one flush
     (rows to the host row file), --queries queries in batches of 512 on
     (a) the decoded-cache rung (default breaker) and (b) the codes-only
     rungs (breaker limit cut so the cache is refused: decode_scan for
     512-query batches, adc_scan for a 128-query batch), each at the
     default overquery factor (recall reported) and at GIST_OVERQUERY
     (recall@10 held to the target on both rungs and on the 128-query
     batch, which must agree with decode_scan's rung on the same queries),
     the routing crossover between the two kernels, and a profile of one
     512-query batch on each rung;
  7. on_disk vamana: 500,000 x 128 rows in flushes of 300,000 (beam tier)
     and 200,000 (scan tier), searched under the default and the tight
     breaker, and reopened;
  8. deletes and merges. 8a (on phase 4's index directory): delete a tenth of the docs and search; add_batch + flush
     a quarter more rows (four fifths new doc ids, one fifth updates of
     live ones), which makes the default merge policy hand the four
     smallest of five segments to the merge pool; search while that merge
     runs; after it exactly 2 segments (the merged one on the beam tier,
     the fresh one on the scan tier); then force_merge to one segment, a
     reopen, and as a yardstick one flush of the same live rows into a
     fresh index. The merged beam-tier segments are searched at the
     default ef_search (reported) and at BEAM_EF (held to the target;
     the batches served during the merge run at BEAM_EF too).
     Every search is held to: no deleted id, every returned score
     the exact score of the doc's newest vector (so no superseded copy),
     recall@10 against exact ground truth over the live rows. 8b (on
     phase 7's index directory): delete a tenth of the docs, search under both
     breakers, force_merge to one on_disk segment whose row file holds the
     used rows, search again under both.
The in_memory corpus is the latent-16 "sift-like" generator of bench.py
(make_data), the GIST-shaped one the latent-32 960-d generator of
bench.py's gist section, both made with numpy from --seed. The last two
lines are the kernel JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

RECALL_TARGET = 0.95  # BASELINE.json's recall@10 target
# phases 4-5: SIFT1M-wide rows in the default disk_ann config, flushed as 4
# segments of capacity 2^18 (each takes the scan tier, so the kernel),
# searched in 512-query batches at k=10
DIM = 128
FLUSHES = 4
BATCH = 512
K = 10
# phase 6: BASELINE config 3 (GIST1M 960-d, PQ64, fp32 rerank), one flat
# on_disk flush of capacity 2^20
GIST_N, GIST_DIM, GIST_LATENT, GIST_M = 1_000_000, 960, 32, 64
# PQ64 over this corpus misses the recall target at the default rerank
# depth (overquery factor 5, r = 50 candidates per query): each rung is
# searched at the default, reported, and at this factor (r = 200), held
# to the target
GIST_OVERQUERY = 20
LUT_BATCH = 128  # below the fused route's 256-query bucket
CROSSOVER_Q = (64, 128, 256, 512)
# phase 7: two flushes of 128-d rows, capacities 2^19 (beam tier) and
# 2^18 (scan tier)
VAMANA_FLUSHES = (300_000, 200_000)
VAMANA_QUERIES = 2048
# phase 8: the shares of the corpus deleted, added and (of the added)
# updating a live doc
DELETE_SHARE, ADD_SHARE, UPDATE_SHARE = 10, 4, 5
# the beam tier over about a million nodes misses the recall target at the
# default ef_search (100): the merged segments are searched at the default,
# reported, and at this ef_search, held to the target; one flush of the
# same live rows into a fresh index is searched the same way beside them
BEAM_EF = 200
ON_DISK_SPANS = ("approximate", "rerank_gather", "rerank_score")
# H100 SXM peaks (NVIDIA data sheet, 700 W): the kernels' bounds
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12  # float32 outside the tensor cores
PEAK_BF16_S = 989e12  # bf16 tensor cores, dense


def log(msg: str) -> None:
    print(msg, flush=True)


def make_data(rng, n: int, q: int, dim: int):
    """Latent-16 corpus + queries (bench.py make_data, 'sift-like'), and
    the latent basis they were drawn over."""
    latent = 16
    a = rng.standard_normal((latent, dim)).astype(np.float32) / np.sqrt(latent)
    vectors = (rng.standard_normal((n, latent)).astype(np.float32) @ a
               + 0.05 * rng.standard_normal((n, dim)).astype(np.float32))
    queries = (rng.standard_normal((q, latent)).astype(np.float32) @ a
               + 0.05 * rng.standard_normal((q, dim)).astype(np.float32))
    return vectors.astype(np.float32), queries.astype(np.float32), a


def more_rows(rng, basis, n: int):
    """`n` more rows of make_data's corpus over the same latent basis."""
    return (rng.standard_normal((n, basis.shape[0])).astype(np.float32)
            @ basis + 0.05 * rng.standard_normal(
                (n, basis.shape[1])).astype(np.float32)).astype(np.float32)


def make_gist(rng, n: int, q: int):
    """Latent-32 960-d corpus + queries (bench.py sec_gist), drawn in
    float32 blocks (a float64 draw of the corpus would be 7.7 GB)."""
    a = rng.standard_normal((GIST_LATENT, GIST_DIM), dtype=np.float32)
    a /= np.sqrt(GIST_LATENT)

    def rows(count):
        out = np.empty((count, GIST_DIM), np.float32)
        for s in range(0, count, 1 << 16):
            b = min(1 << 16, count - s)
            out[s: s + b] = rng.standard_normal((b, GIST_LATENT),
                                                dtype=np.float32) @ a
            out[s: s + b] += 0.05 * rng.standard_normal((b, GIST_DIM),
                                                        dtype=np.float32)
        return out

    return rows(n), rows(q)


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


def bound_of(nbytes: float, ops: float, peak_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_adc_scan(q, m, k, n, seed, reps, plain_reps, library=False,
                   fused=False):
    """adc_scan vs lookup_scan on the card -> record dict. With `fused`,
    also the fused mode (the in_memory path's euclidean map and a validity
    mask in the epilogue): against adc_scan_reference within the raw
    bound, and exactly equal to the raw kernel mapped and masked."""
    from opensearch_jvector_tpu_torch.ops.adc import (
        adc_value_to_score,
        lookup_scan,
    )
    from opensearch_jvector_tpu_torch.ops.adc_kernel import (
        adc_scan,
        adc_scan_reference,
        kernel_error_bound,
    )
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

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
    del ref, err
    nbytes, ops = n * m + q * m * k * 4 + q * n * 4, q * n * m
    if fused:
        simf = SimilarityFunction.EUCLIDEAN
        valid = torch.rand((n,), generator=gen, device="cuda") < 0.95
        got = adc_scan(luts, codes, simf, valid)
        want = adc_value_to_score(out, simf).masked_fill_(~valid[None, :],
                                                          float("-inf"))
        exact = torch.equal(got, want)
        del want
        ref = adc_scan_reference(luts, codes, simf, valid)
        torch.cuda.synchronize()
        # the map is 1-Lipschitz for sums >= 0; masked rows are -inf in both
        err = torch.where(valid[None, :], got - ref, 0.0).abs_()
        fbad = int((err > bound).sum())
        masked_ok = bool(torch.isneginf(got[:, ~valid]).all())
        log(f"  adc_scan fused (euclidean map, {int((~valid).sum())} masked "
            f"rows): max_abs_err={float(err.max()):.3e} against "
            f"adc_scan_reference, out of bound: {fbad}; equal to the raw "
            f"kernel mapped and masked (atol 0): {exact}; masked rows -inf: "
            f"{masked_ok}")
        if fbad or not exact or not masked_ok:
            raise AssertionError(f"adc_scan's fused mode is wrong at Q={q} "
                                 f"M={m} K={k} N={n}")
        del got, ref, err
        fused_ms = cuda_ms(lambda: adc_scan(luts, codes, simf, valid), reps)
        # the fused mode also reads the N validity bytes and maps each of
        # the Q*N sums
        fused_bound_ms, fused_bound_by = bound_of(nbytes + n, ops + q * n,
                                                  PEAK_F32_S)
    del out, bound
    ms = cuda_ms(lambda: adc_scan(luts, codes), reps)
    plain_ms = cuda_ms(lambda: lookup_scan(luts, codes), plain_reps)
    bound_ms, bound_by = bound_of(nbytes, ops, PEAK_F32_S)
    library_ms = None
    if library:
        # one library call for the same function: a summing embedding bag
        # over a [M*K, Q] table; index and table preparation untimed
        idx = (codes.long() + torch.arange(m, device="cuda") * k).contiguous()
        table = luts.permute(1, 2, 0).reshape(m * k, q).contiguous()
        lib_out = torch.nn.functional.embedding_bag(idx, table, mode="sum")
        if not torch.allclose(lib_out.T, lookup_scan(luts, codes),
                              rtol=1e-4, atol=1e-3):
            raise AssertionError("embedding_bag yardstick computes another "
                                 "function")
        del lib_out
        library_ms = cuda_ms(lambda: torch.nn.functional.embedding_bag(
            idx, table, mode="sum"), reps)
    log(f"  adc_scan {ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by})"
        + (f", fused mode {fused_ms:.4f} ms (bound {fused_bound_ms:.4f} ms, "
           f"{fused_bound_by})" if fused else "")
        + f", plain lookup_scan {plain_ms:.4f} ms, library embedding_bag "
        f"{library_ms} ms")
    rec = dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
    if fused:
        rec.update(fused_ms=fused_ms, fused_bound_ms=fused_bound_ms)
    return rec


def check_decode_scan(q, n, m, k, dsub, seed, reps, plain_reps,
                      library=False):
    """decode_scan vs decode_scan_reference on the card -> record dict."""
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import (
        decode_scan,
        decode_scan_reference,
        kernel_error_bound,
    )

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q_c = torch.randn((q, m * dsub), generator=gen, device="cuda")
    codes = torch.randint(0, k, (n, m), generator=gen, device="cuda",
                          dtype=torch.uint8)
    cb = torch.randn((m, k, dsub), generator=gen, device="cuda")
    out = decode_scan(q_c, codes, cb)
    err = (out - decode_scan_reference(q_c, codes, cb)).abs_()
    torch.cuda.synchronize()
    assert out.shape == (q, n) and out.dtype == torch.float32
    finite = bool(torch.isfinite(out).all())
    del out
    bound = kernel_error_bound(q_c, codes, cb)
    bad = int((err > bound).sum())
    max_err = float(err.max())
    share = float((err / bound).max())
    del err, bound
    log(f"  decode_scan Q={q} N={n} M={m} K={k} dsub={dsub}: "
        f"max_abs_err={max_err:.3e}, largest share of the bound "
        f"2^-7*sum|q||dec| {share:.4f}, out of bound: {bad}")
    if bad or not finite:
        raise AssertionError(f"decode_scan disagrees with its plain version "
                             f"at Q={q} N={n} M={m} K={k} dsub={dsub}")
    ms = cuda_ms(lambda: decode_scan(q_c, codes, cb), reps)
    plain_ms = cuda_ms(lambda: decode_scan_reference(q_c, codes, cb),
                       plain_reps)
    d = m * dsub
    bound_ms, bound_by = bound_of(
        n * m + q * d * 4 + m * k * dsub * 4 + q * n * 4, 2.0 * q * n * d,
        PEAK_BF16_S)
    library_ms = None
    if library:
        # the decoded-cache rung's product: one bf16 matmul over a cache
        # decoded beforehand (2*d bytes per row, the memory this kernel
        # exists to avoid); the decode is untimed
        from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import (
            _padded_codebooks,
        )
        dec = _padded_codebooks(cb)[torch.arange(m, device="cuda"),
                                    codes.long()].reshape(n, d).bfloat16()
        qb = q_c.bfloat16()
        library_ms = cuda_ms(lambda: torch.mm(qb, dec.T,
                                              out_dtype=torch.float32), reps)
        del dec
    log(f"  decode_scan {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"bf16 matmul on a decoded cache {library_ms} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by})")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def profile_batch(index, queries, sc, expect: str | None = None) -> None:
    """Where one search batch's time goes: device time by kernel and the
    device's busy share of the batch's wall time (torch.profiler). A
    kernel named `expect` that is missing from the trace is reported."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        index.search(queries, sc)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    # device-only rows (kernels, copies); CPU-side ops and the profiler
    # ranges ("query" and the on_disk stages, which the trace also shows as
    # device annotations) would count their kernels' time twice
    ranges = ("query",) + ON_DISK_SPANS
    rows = [(e.self_device_time_total, e.key, e.count)
            for e in prof.key_averages()
            if e.self_cpu_time_total == 0 and e.key not in ranges]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile of one {queries.shape[0]}-query batch: wall "
        f"{wall_us / 1000:.3f} ms, device busy {busy / 1000:.3f} ms "
        f"({100 * busy / wall_us:.1f}% of wall)")
    for us, key, count in rows[:10]:
        log(f"    {us / 1000:9.3f} ms  x{count:<4d} {key[:90]}")
    if expect and not any(expect in key for _, key, _ in rows):
        log(f"  {expect} is missing from the trace: device busy is "
            f"understated")
    # the on_disk search's stages (profiler ranges in index/reader.py), on
    # the host's clock
    spans = {}
    for e in prof.key_averages():
        if e.key in ON_DISK_SPANS:  # the host range, not its device twin
            spans[e.key] = max(spans.get(e.key, 0), e.cpu_time_total)
    if spans:
        log("  on_disk stages (host clock): " + ", ".join(
            f"{k} {spans[k] / 1000:.3f} ms" for k in ON_DISK_SPANS
            if k in spans))


def search_all(index, queries, sc):
    """Search `queries` in BATCH-query batches -> (ids, scores, seconds)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    ids, scores = [], []
    for s in range(0, queries.shape[0], BATCH):
        res = index.search(queries[s: s + BATCH], sc)
        ids.append(res.doc_ids)
        scores.append(res.scores)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    ids, scores = np.concatenate(ids), np.concatenate(scores)
    assert ids.shape == (queries.shape[0], sc.k)
    assert np.isfinite(scores).all() and (ids >= 0).all()
    return ids, scores, wall


def tight_breaker_limit(settings, breaker) -> float:
    """A circuit-breaker limit (percent of the card) that admits what is
    in use plus 32 MiB: an on_disk segment's 4 B/row codes_sq fits, its
    2*d B/row decoded cache does not (67 MB and more in phases 6-7): an
    operator capping the kNN share of the card."""
    total, in_use = breaker.device_memory(torch.device("cuda"))
    limit = 100.0 * (in_use + (32 << 20)) / total
    settings.put("knn.memory.circuit_breaker.limit", limit)
    return limit


def cuobjdump() -> str | None:
    """The toolkit's cuobjdump, else the one Triton carries, else None."""
    found = shutil.which("cuobjdump")
    if found:
        return found
    places = [Path("/usr/local/cuda/bin/cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec is not None and spec.submodule_search_locations:
        places.append(Path(spec.submodule_search_locations[0]) / "backends"
                      / "nvidia" / "bin" / "cuobjdump")
    return next((str(p) for p in places if p.is_file()), None)


def hmma_count(lib: Path) -> str:
    """How many tensor-core (HMMA) instructions the SASS of
    decode_scan_kernel in `lib` holds, as a line to print; never raises."""
    tool = cuobjdump()
    if tool is None:
        return "cuobjdump not available"
    try:
        proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}"
    if proc.returncode != 0:
        return f"cuobjdump failed (exit {proc.returncode})"
    count, inside = 0, False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            inside = "decode_scan_kernel" in line
        elif inside and "HMMA" in line:
            count += 1
    return f"{count} HMMA instructions in decode_scan_kernel ({tool})"


def kernel_counts(*kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def live_truth(queries, rows, live_ids, k):
    """Exact top-k doc ids over the live rows `rows[live_ids]` (doc id ==
    row), computed on the card."""
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
    )

    gt = ground_truth_topk(torch.as_tensor(queries, device="cuda"),
                           torch.as_tensor(rows[live_ids], device="cuda"), k,
                           SimilarityFunction.EUCLIDEAN)
    return live_ids[gt]


def check_live_answers(what, ids, scores, queries, rows_dev, dead, truth, k):
    """Hold a search's answers to the live doc set -> recall@k: no id of
    `dead`, every score the exact euclidean score of the doc's newest
    vector `rows_dev[doc]` (a superseded copy would score otherwise), and
    recall against `truth` at the target."""
    from opensearch_jvector_tpu_torch.utils.ground_truth import recall_at_k

    if np.isin(ids, dead).any():
        raise AssertionError(f"{what}: a deleted doc id came back")
    q = torch.as_tensor(queries, device="cuda")
    got = torch.as_tensor(scores, device="cuda")
    for s in range(0, ids.shape[0], BATCH):
        rows = rows_dev[torch.as_tensor(ids[s: s + BATCH], device="cuda")]
        d2 = torch.sum((rows - q[s: s + BATCH, None, :]) ** 2, -1)
        if not torch.allclose(got[s: s + BATCH], 1.0 / (1.0 + d2), rtol=1e-3,
                              atol=1e-6):
            raise AssertionError(f"{what}: a returned score is not the "
                                 f"score of the doc's newest vector")
    recall = recall_at_k(ids, truth, k)
    if recall < RECALL_TARGET:
        raise AssertionError(f"{what}: recall@{k} {recall} < {RECALL_TARGET}")
    return recall


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
    from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
    from opensearch_jvector_tpu_torch.api.stats import Counter
    from opensearch_jvector_tpu_torch.index.index import VectorIndex
    from opensearch_jvector_tpu_torch.models.pq import default_num_subspaces
    from opensearch_jvector_tpu_torch.ops import _kernels
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
        recall_at_k,
    )

    # the plain versions' float32 products run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # keep CUPTI set up between the profiles of one run: after a teardown
    # and re-init, a trace can miss the kernels of the ctypes-loaded
    # libraries
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1/8] device: {kind} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    names = ("adc_scan", "decode_scan", "vector_store")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_kernels.build, names)))
    log(f"[2/8] build: {', '.join(p.name for p in libs.values())} in "
        f"{time.monotonic() - t0:.1f} s (compilers started together)")
    for name in names:
        if name not in _kernels.BUILD_LOGS:
            log(f"  {name}: built before this run, no compiler report")
        for line in _kernels.ptxas_summary(_kernels.BUILD_LOGS.get(name, "")):
            log(f"  ptxas {name}: {line}")
    log(f"  sass: {hmma_count(libs['decode_scan'])}")

    # ---- 3. kernels vs plain ----------------------------------------------
    log("[3/8] kernels vs plain PyTorch on the card")
    m = default_num_subspaces(DIM)  # the subspaces the flushes train
    adc_rec = check_adc_scan(BATCH, m, 256, 1 << 18, args.seed, reps=20,
                             plain_reps=3, library=True, fused=True)
    check_adc_scan(3, 8, 64, 1000, args.seed + 1, reps=20, plain_reps=20)
    # the on_disk phases' shapes: the Q=1 codes_sq table over phase 6's
    # 2^20 codes and phase 7's 2^18, and the LUT rung's batch in phase 6
    for i, (q, m_, n) in enumerate([(1, GIST_M, 1 << 20), (1, m, 1 << 18),
                                    (LUT_BATCH, GIST_M, 1 << 20)]):
        check_adc_scan(q, m_, 256, n, args.seed + 10 + i, reps=5,
                       plain_reps=2)
    dsub = GIST_DIM // GIST_M
    dec_rec = check_decode_scan(BATCH, 1 << 20, GIST_M, 256, dsub,
                                args.seed + 2, reps=5, plain_reps=2,
                                library=True)
    for i, shape in enumerate([(3, 1000, 8, 64, 21), (1, 777, GIST_M, 256,
                                                      dsub),
                               (BATCH, 1 << 18, m, 256, DIM // m)]):
        check_decode_scan(*shape, args.seed + 3 + i, reps=5, plain_reps=2)
    torch.cuda.empty_cache()

    # ---- 4. in_memory path ---------------------------------------------------
    rng = np.random.default_rng(args.seed)
    vectors, queries, basis = make_data(rng, args.n, args.queries, DIM)
    sc = SearchConfig(k=K)
    log(f"[4/8] in_memory path: {args.n} x {DIM} in {FLUSHES} flushes, "
        f"{args.queries} queries in batches of {BATCH}, k={K}")
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    # phase 8a comes back to this directory, and removes it
    mem_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    root = mem_dir.name
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

    index.search(queries[: BATCH], sc)  # warm: segment loads
    adc_scan.launches = decode_scan.launches = 0
    ids, scores, wall = search_all(index, queries, sc)
    launches["in_memory"] = kernel_counts(adc_scan, decode_scan)
    peak = torch.cuda.max_memory_allocated()
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
    log(f"  launches on this path: {launches['in_memory']}")
    profile_batch(index, queries[: BATCH], sc, "adc_scan_kernel")
    if recall < RECALL_TARGET:
        raise AssertionError(f"recall@{K} {recall} < {RECALL_TARGET}")
    if launches["in_memory"]["adc_scan"] <= 0:
        raise AssertionError("the search path never launched adc_scan")

    # ---- 5. reopen -------------------------------------------------------
    index.close()
    reopened = VectorIndex(root, device="cuda")
    again = reopened.search(queries[: BATCH], sc).doc_ids
    same = bool((again == ids[: BATCH]).all())
    log(f"[5/8] reopen from commits.json: {len(reopened.segment_names)} "
        f"segments, identical top-{K} ids for {BATCH} "
        f"queries: {same}")
    if not same:
        raise AssertionError("reopened index returned other ids")
    reopened.close()
    del index, reopened
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 6. on_disk flat, GIST1M-shaped --------------------------------------
    crossover = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gist_") as root:
        free = shutil.disk_usage(root).free
        if free < GIST_N * GIST_DIM * 4 + (2 << 30):
            raise RuntimeError(f"{free} B free under {root}: the GIST row "
                               f"file needs {GIST_N * GIST_DIM * 4} B and "
                               f"2 GiB to spare")
        grng = np.random.default_rng(args.seed + 41)
        t0 = time.monotonic()
        gv, gq = make_gist(grng, GIST_N, args.queries)
        log(f"[6/8] on_disk flat GIST1M-shaped: {GIST_N} x {GIST_DIM}, "
            f"PQ{GIST_M}, {args.queries} queries in batches of {BATCH}, "
            f"k={K} (data made in {time.monotonic() - t0:.1f} s)")
        gt = ground_truth_topk(torch.as_tensor(gq, device="cuda"),
                               torch.as_tensor(gv, device="cuda"), K,
                               SimilarityFunction.EUCLIDEAN)
        gc.collect()
        torch.cuda.empty_cache()
        cfg = DiskAnnConfig(dim=GIST_DIM, mode="on_disk", index_type="flat",
                            quantization_type="pq", num_pq_subspaces=GIST_M,
                            similarity=SimilarityFunction.EUCLIDEAN)
        torch.cuda.reset_peak_memory_stats()
        index = VectorIndex(root, cfg, device="cuda")
        before = index.stats.snapshot()
        t0 = time.monotonic()
        index.add_batch(np.arange(GIST_N), gv)
        name = index.flush()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        pq_ms = (index.stats.snapshot()[
            Counter.KNN_QUANTIZATION_TRAINING_TIME.value]
            - before[Counter.KNN_QUANTIZATION_TRAINING_TIME.value])
        log(f"  flush {name}: {GIST_N} vectors in {dt:.2f} s = "
            f"{GIST_N / dt:.0f} vec/s (PQ train+encode {pq_ms} ms; row "
            f"file, CRC and containers {1000 * dt - pq_ms:.0f} ms); peak "
            f"device memory {torch.cuda.max_memory_allocated()} B")
        index.close()
        del gv
        gc.collect()

        deep = SearchConfig(k=K, overquery_factor=GIST_OVERQUERY)
        results = {}
        for rung in ("decoded", "codes_only"):
            index = VectorIndex(root, device="cuda")
            reader = index._reader(name)
            if not reader.seg.row_store.is_native:
                raise AssertionError("the host row store is not native")
            limit = 50.0
            if rung == "codes_only":
                limit = tight_breaker_limit(GLOBAL_SETTINGS, BREAKER)
            torch.cuda.reset_peak_memory_stats()
            adc_scan.launches = decode_scan.launches = 0
            index.search(gq[:BATCH], sc)  # warm: caches, allocator
            ids, _, wall = search_all(index, gq, sc)
            deep_ids, _, deep_wall = search_all(index, gq, deep)
            small_ms = None
            if rung == "codes_only":
                # one batch below the fused route's bucket: the LUT rung
                before_lut = adc_scan.launches
                t0 = time.monotonic()
                small = index.search(gq[:LUT_BATCH], deep)
                small_ms = 1000 * (time.monotonic() - t0) / LUT_BATCH
                lut_launches = adc_scan.launches - before_lut
                assert (small.doc_ids >= 0).all()
                # against the same queries' answers from decode_scan's rung
                lut_recall = recall_at_k(small.doc_ids, gt[:LUT_BATCH], K)
                fused_recall = recall_at_k(deep_ids[:LUT_BATCH],
                                           gt[:LUT_BATCH], K)
            launches[f"gist_{rung}"] = kernel_counts(adc_scan, decode_scan)
            peak = torch.cuda.max_memory_allocated()
            recall_default = recall_at_k(ids, gt, K)
            recall = recall_at_k(deep_ids, gt, K)
            results[rung] = recall
            log(f"  ({'a' if rung == 'decoded' else 'b'}) {rung} rung, "
                f"breaker limit {limit:.4f}%: overquery "
                f"{sc.overquery_factor}: {1000 * wall / len(gq):.5f} "
                f"ms/query batched ({wall:.3f} s), recall@{K} "
                f"{recall_default:.4f}; overquery {GIST_OVERQUERY}: "
                f"{1000 * deep_wall / len(gq):.5f} ms/query batched "
                f"({deep_wall:.3f} s), recall@{K} {recall:.4f}; peak device "
                f"memory {peak} B, decoded cache "
                f"{'built' if reader._pq_decoded is not None else 'refused'}"
                f", launches {launches[f'gist_{rung}']}"
                + (f"; {LUT_BATCH}-query batch {small_ms:.5f} ms/query"
                   if small_ms is not None else ""))
            profile_batch(index, gq[:BATCH], deep,
                          "decode_scan_kernel" if rung == "codes_only"
                          else None)
            if rung == "codes_only":
                lut_gap = abs(lut_recall - fused_recall)
                log(f"  {LUT_BATCH}-query LUT batch: adc_scan launches "
                    f"{lut_launches}, recall@{K} {lut_recall:.4f}; the same "
                    f"queries on the decode_scan rung {fused_recall:.4f}, "
                    f"gap {lut_gap:.4f} (limit 0.005)")
                if lut_launches <= 0:
                    raise AssertionError("the LUT batch never launched "
                                         "adc_scan")
                if lut_recall < RECALL_TARGET or lut_gap > 0.005:
                    raise AssertionError(
                        f"LUT rung recall@{K} {lut_recall} (decode_scan "
                        f"rung {fused_recall}, target {RECALL_TARGET})")
                # routing crossover: both kernels over the segment's codes
                pqv = reader.seg.pqv
                q_all = torch.as_tensor(gq[:max(CROSSOVER_Q)], device="cuda")
                q_c = (q_all - pqv.pq.center).contiguous()
                luts = pqv.build_query_luts(q_all, cfg.similarity)
                for qn in CROSSOVER_Q:
                    qc, lt = q_c[:qn].contiguous(), luts[:qn].contiguous()
                    t_dec = cuda_ms(lambda: decode_scan(
                        qc, pqv.codes, pqv.pq.codebooks), 3)
                    t_adc = cuda_ms(lambda: adc_scan(lt, pqv.codes), 3)
                    crossover[qn] = (t_dec, t_adc)
                    log(f"  crossover Q={qn}: decode_scan {t_dec:.4f} ms, "
                        f"adc_scan {t_adc:.4f} ms over {pqv.codes.shape[0]}"
                        f" codes ({'decode_scan' if t_dec < t_adc else 'adc_scan'}"
                        f" faster)")
                del q_all, q_c, luts
            GLOBAL_SETTINGS.put("knn.memory.circuit_breaker.limit", 50.0)
            index.close()
            del index, reader
            gc.collect()
            torch.cuda.empty_cache()
        gist_launches = launches["gist_codes_only"]
        if gist_launches["decode_scan"] <= 0 or gist_launches["adc_scan"] <= 0:
            raise AssertionError(f"the codes-only rung did not launch both "
                                 f"kernels: {gist_launches}")
        gap = abs(results["decoded"] - results["codes_only"])
        log(f"  recall@{K} at overquery {GIST_OVERQUERY}: decoded "
            f"{results['decoded']:.4f}, codes-only "
            f"{results['codes_only']:.4f}, gap {gap:.4f} (limit 0.005)")
        for rung, rec in results.items():
            if rec < RECALL_TARGET:
                raise AssertionError(f"GIST {rung} recall@{K} {rec} < "
                                     f"{RECALL_TARGET}")
        if gap > 0.005:
            raise AssertionError(f"rungs disagree: recall gap {gap}")
    del gq, gt
    gc.collect()

    # ---- 7. on_disk vamana ----------------------------------------------------
    vrng = np.random.default_rng(args.seed + 7)
    n_v = sum(VAMANA_FLUSHES)
    vv, vq, _ = make_data(vrng, n_v, VAMANA_QUERIES, DIM)
    log(f"[7/8] on_disk vamana: {n_v} x {DIM} in flushes of "
        f"{VAMANA_FLUSHES}, {VAMANA_QUERIES} queries, k={K}")
    gt = ground_truth_topk(torch.as_tensor(vq, device="cuda"),
                           torch.as_tensor(vv, device="cuda"), K,
                           SimilarityFunction.EUCLIDEAN)
    # phase 8b comes back to this directory, and removes it
    vamana_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_vamana_")
    root = vamana_dir.name
    index = VectorIndex(root, DiskAnnConfig(dim=DIM, mode="on_disk"),
                        device="cuda")
    lo = 0
    for count in VAMANA_FLUSHES:
        t0 = time.monotonic()
        index.add_batch(np.arange(lo, lo + count), vv[lo: lo + count])
        name = index.flush()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        cap = index._reader(name).seg.capacity()
        log(f"  flush {name}: {count} vectors in {dt:.2f} s = "
            f"{count / dt:.0f} vec/s, capacity {cap} "
            f"({'beam' if cap > 1 << 18 else 'scan'} tier)")
        lo += count
    index.close()
    first = None
    for rung in ("default", "tight"):
        index = VectorIndex(root, device="cuda")
        for n_ in index.segment_names:
            index._reader(n_)  # load before the breaker tightens
        if rung == "tight":
            tight_breaker_limit(GLOBAL_SETTINGS, BREAKER)
        adc_scan.launches = decode_scan.launches = 0
        before = index.stats.snapshot()
        ids, _, wall = search_all(index, vq, sc)
        after = index.stats.snapshot()
        launches[f"vamana_{rung}"] = kernel_counts(adc_scan, decode_scan)
        expanded = (after[Counter.KNN_QUERY_EXPANDED_NODES.value]
                    - before[Counter.KNN_QUERY_EXPANDED_NODES.value])
        recall = recall_at_k(ids, gt, K)
        # the decoded cache serves the pq_decoded provider (beam tier)
        # and the first scan rung; refused, the beam tier takes the pq
        # provider and the scan tier the codes-only kernels
        cached = [index._reader(n_)._pq_decoded is not None
                  for n_ in index.segment_names]
        log(f"  {rung} breaker: {1000 * wall / len(vq):.5f} ms/query "
            f"batched, recall@{K} {recall:.4f}, beam expansions "
            f"{expanded}, decoded cache built per segment {cached}, "
            f"launches {launches[f'vamana_{rung}']}")
        GLOBAL_SETTINGS.put("knn.memory.circuit_breaker.limit", 50.0)
        if cached != [rung == "default"] * len(cached):
            raise AssertionError(f"{rung} breaker: decoded cache per "
                                 f"segment {cached}")
        if recall < RECALL_TARGET:
            raise AssertionError(f"vamana {rung} recall@{K} {recall} < "
                                 f"{RECALL_TARGET}")
        if expanded <= 0:
            raise AssertionError("the beam tier never ran")
        if rung == "tight" and launches["vamana_tight"]["decode_scan"] <= 0:
            raise AssertionError("the tight scan tier never launched "
                                 "decode_scan")
        if first is None:
            first = ids
        index.close()
    reopened = VectorIndex(root, device="cuda")
    again = search_all(reopened, vq[:BATCH], sc)[0]
    same = bool((again == first[:BATCH]).all())
    log(f"  reopen: identical top-{K} ids for {BATCH} queries: {same}")
    reopened.close()
    if not same:
        raise AssertionError("reopened on_disk index returned other ids")

    # ---- 8a. in_memory deletes and a background merge --------------------
    n = args.n
    n_del, n_add = n // DELETE_SHARE, n // ADD_SHARE
    n_upd = n_add // UPDATE_SHARE
    n_new = n_add - n_upd
    log(f"[8a/8] in_memory deletes and merges on phase 4's index directory: "
        f"delete {n_del}, then add {n_new} new docs and {n_upd} updates")
    # the default merge policy: tiered, at most 4 segments, 4 a merge
    index = VectorIndex(mem_dir.name, device="cuda")
    drng = np.random.default_rng(args.seed + 8)
    doomed = drng.choice(n, n_del, replace=False)
    live = np.ones(n + n_new, bool)
    live[doomed] = False
    live[n:] = False  # not added yet
    t0 = time.monotonic()
    index.delete(doomed)
    log(f"  delete of {n_del} docs: {time.monotonic() - t0:.2f} s, "
        f"has_deletes {index.has_deletes}, doc_count "
        f"{index.doc_count()}")
    if not index.has_deletes or index.doc_count() != n - n_del:
        raise AssertionError("the deletes did not register")
    rows = np.concatenate([vectors, more_rows(drng, basis, n_new)])
    rows_dev = torch.as_tensor(rows, device="cuda")
    truth = live_truth(queries, rows, np.nonzero(live)[0], K)
    index.search(queries[:BATCH], sc)  # warm: the masks follow
    adc_scan.launches = decode_scan.launches = 0
    ids, scores, wall = search_all(index, queries, sc)
    launches["in_memory_deleted"] = kernel_counts(adc_scan, decode_scan)
    recall = check_live_answers("after the deletes", ids, scores, queries,
                                rows_dev, doomed, truth, K)
    log(f"  search with {n_del} tombstones in the fused valid masks: "
        f"{1000 * wall / args.queries:.5f} ms/query batched, recall@{K} "
        f"{recall:.4f} over the live rows, no deleted id, launches "
        f"{launches['in_memory_deleted']}")

    # the fifth flush: new docs and updates of live ones
    upd_ids = drng.choice(np.nonzero(live)[0], n_upd, replace=False)
    upd_rows = more_rows(drng, basis, n_upd)
    rows[upd_ids] = upd_rows
    rows_dev[torch.as_tensor(upd_ids, device="cuda")] = torch.as_tensor(
        upd_rows, device="cuda")
    live[n:] = True
    live_ids = np.nonzero(live)[0]
    truth = live_truth(queries, rows, live_ids, K)
    index.time_merge_stages = True
    before = index.stats.snapshot()
    index.add_batch(np.concatenate([np.arange(n, n + n_new), upd_ids]),
                    np.concatenate([rows[n:], upd_rows]))
    adc_scan.launches = decode_scan.launches = 0
    t0 = time.monotonic()
    name5 = index.flush()
    flush_s = time.monotonic() - t0
    in_flight = index.merge_scheduler.in_flight
    log(f"  flush {name5}: returned after {flush_s:.2f} s with "
        f"{in_flight} merge in flight and "
        f"{len(index.segment_names)} segments")
    if in_flight != 1:
        raise AssertionError("the fifth flush started no background "
                             "merge, or waited for it")
    # at BEAM_EF: a batch that starts after the swap meets the merged
    # segment on the beam tier (the scan tier does not read ef_search)
    deep = SearchConfig(k=K, ef_search=BEAM_EF)
    served, mid_recall, t_mid = 0, [], 0.0
    while served == 0 or index.merge_scheduler.in_flight:
        lo = (served * BATCH) % (args.queries - BATCH + 1)
        t1 = time.monotonic()
        res = index.search(queries[lo: lo + BATCH], deep)
        t_mid += time.monotonic() - t1
        still = index.merge_scheduler.in_flight
        mid_recall.append(check_live_answers(
            "during the merge", res.doc_ids, res.scores,
            queries[lo: lo + BATCH], rows_dev, doomed,
            truth[lo: lo + BATCH], K))
        served += 1
        if not still:
            break
    index.await_merges()
    torch.cuda.synchronize()
    merge_wall = time.monotonic() - t0 - flush_s
    launches["in_memory_during_merge"] = kernel_counts(adc_scan,
                                                       decode_scan)
    after = index.stats.snapshot()
    merge_ms = (after[Counter.KNN_GRAPH_MERGE_TIME.value]
                - before[Counter.KNN_GRAPH_MERGE_TIME.value])
    merged_live = len(live_ids) - n_add
    log(f"  background merge: {merge_wall:.2f} s from the flush's return "
        f"to await_merges, KNN_GRAPH_MERGE_TIME {merge_ms} ms = "
        f"{1000 * merged_live / max(merge_ms, 1):.0f} live rows merged/s "
        f"({merged_live} live rows of 4 segments); {served} batches of "
        f"{BATCH} served meanwhile at {1000 * t_mid / served:.1f} ms a "
        f"batch, recall@{K} {min(mid_recall):.4f}-{max(mid_recall):.4f}, "
        f"launches {launches['in_memory_during_merge']}")
    log(f"  merge stages (host clock after a device sync, searches "
        f"running beside): " + ", ".join(
            f"{k} {v:.2f} s" for k, v in index.last_merge_timings.items()))
    names = index.segment_names
    caps = {n_: index._reader(n_).seg.capacity() for n_ in names}
    used = {n_: index._reader(n_).seg.docmap.num_ordinals for n_ in names}
    log(f"  segments after the merge: {names}, capacities {caps}, used "
        f"ordinals {used}, doc_count {index.doc_count()}")
    merged = "merged_4segs_m1"
    if (sorted(names) != sorted([merged, name5])
            or caps[merged] <= (1 << 18) or caps[name5] > (1 << 18)
            or used[name5] != n_add
            or (n == 1_000_000 and caps[merged] != 1 << 20)):
        raise AssertionError("the merge left another segment set")
    if index.doc_count() != len(live_ids):
        raise AssertionError(f"doc_count {index.doc_count()} != "
                             f"{len(live_ids)} live docs")
    def search_both(what):
        """Search at the default ef_search (reported) and at BEAM_EF
        (held to the live set and the target) -> the latter's ids."""
        ids, _, wall = search_all(index, queries, sc)
        shallow = recall_at_k(ids, truth, K)
        ids, scores, deep_wall = search_all(index, queries, deep)
        recall = check_live_answers(what, ids, scores, queries, rows_dev,
                                    doomed, truth, K)
        log(f"  search {what}: ef_search {sc.resolved_ef()}: "
            f"{1000 * wall / args.queries:.5f} ms/query batched, "
            f"recall@{K} {shallow:.4f}; ef_search {BEAM_EF}: "
            f"{1000 * deep_wall / args.queries:.5f} ms/query batched, "
            f"recall@{K} {recall:.4f}")
        return ids

    index.search(queries[:BATCH], sc)  # warm
    adc_scan.launches = decode_scan.launches = 0
    stats0 = index.stats.snapshot()
    search_both("after the merge (beam tier + scan tier)")
    launches["in_memory_merged"] = kernel_counts(adc_scan, decode_scan)
    expanded = (index.stats.snapshot()[
        Counter.KNN_QUERY_EXPANDED_NODES.value]
        - stats0[Counter.KNN_QUERY_EXPANDED_NODES.value])
    log(f"  beam expansions {expanded}, launches "
        f"{launches['in_memory_merged']}")
    if expanded <= 0 or launches["in_memory_merged"]["adc_scan"] <= 0:
        raise AssertionError("the merged index did not run both tiers")

    t0 = time.monotonic()
    forced = index.force_merge()
    torch.cuda.synchronize()
    force_s = time.monotonic() - t0
    log(f"  force_merge -> {forced} in {force_s:.2f} s, stages: "
        + ", ".join(f"{k} {v:.2f} s"
                    for k, v in index.last_merge_timings.items())
        + f"; capacity {index._reader(forced).seg.capacity()}, "
        f"has_deletes {index.has_deletes}")
    if index.segment_names != [forced] or index.has_deletes:
        raise AssertionError("force_merge left tombstones or segments")
    adc_scan.launches = decode_scan.launches = 0
    ids = search_both("after force_merge (one beam-tier segment)")
    launches["in_memory_force_merged"] = kernel_counts(adc_scan,
                                                       decode_scan)
    index.close()
    again = VectorIndex(mem_dir.name, device="cuda")
    same = bool((again.search(queries[:BATCH], deep).doc_ids
                 == ids[:BATCH]).all())
    log(f"  reopen: {again.segment_names}, identical top-{K} ids for "
        f"{BATCH} queries: {same}")
    again.close()
    if not same or again.doc_count() != len(live_ids):
        raise AssertionError("the reopened merged index differs")
    del again
    gc.collect()
    torch.cuda.empty_cache()
    # yardstick: the same live rows in one flush of a fresh index (one
    # segment of the same capacity, built in one go)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_one_") as one:
        index = VectorIndex(one, DiskAnnConfig(dim=DIM), device="cuda")
        t0 = time.monotonic()
        index.add_batch(live_ids, rows[live_ids])
        index.flush()
        torch.cuda.synchronize()
        log(f"  yardstick, one flush of the {len(live_ids)} live rows: "
            f"{time.monotonic() - t0:.2f} s")
        index.search(queries[:BATCH], sc)  # warm: the segment load
        search_both("the one-flush yardstick")
        index.close()
    del rows, rows_dev, truth
    mem_dir.cleanup()
    del vectors, queries
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8b. on_disk deletes and a merge ----------------------------------
    doomed = np.random.default_rng(args.seed + 9).choice(
        n_v, n_v // DELETE_SHARE, replace=False)
    keep = np.setdiff1d(np.arange(n_v), doomed)
    log(f"[8b/8] on_disk vamana deletes and force_merge: delete "
        f"{doomed.size} of {n_v} docs")
    truth = live_truth(vq, vv, keep, K)
    root = vamana_dir.name
    index = VectorIndex(root, device="cuda")
    index.delete(doomed)
    index.close()

    def both_breakers(tag):
        """Search under the default and the tight breaker -> launches
        of the tight one; no deleted id, recall at the target."""
        for rung in ("default", "tight"):
            idx = VectorIndex(root, device="cuda")
            for n_ in idx.segment_names:
                idx._reader(n_)  # load before the breaker tightens
            if rung == "tight":
                tight_breaker_limit(GLOBAL_SETTINGS, BREAKER)
            adc_scan.launches = decode_scan.launches = 0
            try:
                ids, _, wall = search_all(idx, vq, sc)
            finally:
                GLOBAL_SETTINGS.put("knn.memory.circuit_breaker.limit",
                                    50.0)
            counts = kernel_counts(adc_scan, decode_scan)
            launches[f"vamana_{tag}_{rung}"] = counts
            recall = recall_at_k(ids, truth, K)
            log(f"  {tag}, {rung} breaker: "
                f"{1000 * wall / len(vq):.5f} ms/query batched, "
                f"recall@{K} {recall:.4f} over the live rows, segments "
                f"{idx.segment_names}, launches {counts}")
            idx.close()
            if np.isin(ids, doomed).any():
                raise AssertionError(f"{tag}, {rung}: a deleted doc id "
                                     f"came back")
            if recall < RECALL_TARGET:
                raise AssertionError(f"{tag}, {rung}: recall@{K} "
                                     f"{recall} < {RECALL_TARGET}")
        return counts

    counts = both_breakers("deleted")
    if counts["decode_scan"] <= 0:
        raise AssertionError("the tight scan tier with tombstones never "
                             "launched decode_scan")
    index = VectorIndex(root, device="cuda")
    index.time_merge_stages = True
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    merged = index.force_merge()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    seg = index._reader(merged).seg
    row_bytes = (Path(root) / merged / "rows.f32").stat().st_size
    used = seg.docmap.num_ordinals
    log(f"  force_merge -> {merged} in {dt:.2f} s ("
        + ", ".join(f"{k} {v:.2f} s"
                    for k, v in index.last_merge_timings.items())
        + f"), peak device memory during the merge {peak} B; capacity "
        f"{seg.capacity()}, used ordinals {used}, live "
        f"{seg.live_count()}, rows.f32 {row_bytes} B, doc_count "
        f"{index.doc_count()}")
    if (index.segment_names != [merged] or index.has_deletes
            or seg.row_store is None or row_bytes != used * DIM * 4
            or index.doc_count() != keep.size
            or (n_v == 500_000 and seg.capacity() != 1 << 19)):
        raise AssertionError("the on_disk merge left another segment")
    index.close()
    both_breakers("merged")
    vamana_dir.cleanup()

    total = {k: sum(v[k] for v in launches.values())
             for k in ("adc_scan", "decode_scan")}
    log(f"launches by path: {launches}")
    log(f"routing crossover (decode_scan ms, adc_scan ms): {crossover}")
    print(json.dumps({"kernels": [
        {"name": "adc_scan", "route": "cuda",
         "source": "opensearch_jvector_tpu_torch/csrc/adc_scan.cu",
         "replaces": "opensearch_jvector_tpu/ops/pallas/adc_kernel.py:61",
         "launches": total["adc_scan"], **adc_rec},
        {"name": "decode_scan", "route": "cuda",
         "source": "opensearch_jvector_tpu_torch/csrc/decode_scan.cu",
         "replaces":
             "opensearch_jvector_tpu/ops/pallas/pq_scan_kernel.py:112",
         "launches": total["decode_scan"], **dec_rec},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
