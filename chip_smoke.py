#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py [--n 1000000] [--queries 10000] [--seed 0]
                          [--compare-decode-scan OTHER.cu]

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device: card name, and name + power limit as nvidia-smi reports them;
  2. build: compile the CUDA kernels and the host row store from the
     sources in this checkout, all compilers started together, with
     ptxas's registers and spills of every kernel and the counts of
     tensor-core instructions in decode_scan_kernel's SASS where cuobjdump
     is found: HGMMA (wgmma, which the kernel must hold) and HMMA;
  3. kernels: every kernel against its plain PyTorch version at the main
     paths' shapes (adc_scan also at phase 10's Q=1 and Q=32 over 2^18 x 64
     codes) and at ragged shapes, with the kernel's time, the plain
     version's, one library call computing the same function, and the
     bound the card's peak rates set; adc_scan also in its fused mode (score
     map and validity mask in the epilogue) at the in_memory cell, held to
     the plain version and, exactly, to the raw kernel mapped and masked;
     decode_scan at the GIST cell's Q=512 and at the routing gate's lowest
     batch, Q=256. With --compare-decode-scan, another decode_scan.cu (an
     earlier commit's, say) is built with the same flags, held to the same
     plain version and timed beside this checkout's kernel in turns
     (other, this, this, other) at both shapes;
  4. in_memory path: VectorIndex(DiskAnnConfig(dim=128)) on "cuda",
     add_batch + flush of --n rows in 4 flushes (4 segments that each take
     the scan tier), batched search at k=10, recall@10 against exact
     ground truth computed on the card, peak device memory, launches;
  4-5 write and reopen the index as field "vec" of index "sift" under a
     service root (<root>/sift/vec), which phases 10 and 8a reuse;
  5. reopen: the index directory reopened from commits.json returns the
     same top-10 ids;
 10. serving over REST, right after phase 5 on its directory:
     KnnService(root, device="cuda") with the 2 ms micro-batcher; PUT /sift
     attaches the four segments. Held: _count; --queries queries in 2-D
     batched bodies of 512 equal to phase 4's in-process answers (ids, and
     scores within 1e-6) with recall@10 at the target; a 40-id filter (the
     exact fallback) equal to numpy's exact top-10 among them; a
     100,000-id filter (ANN) returning only filtered docs (recall against
     filtered exact search reported); a min_score radial query equal to
     the exact set; rescore scores exact; a knn_score l2 script equal to
     numpy's top-10 up to ties; ext.mmr returning 10 distinct ids; GET _doc
     of 100 ids and docvalue_fields bit for bit; the stats counters' deltas
     the requests imply; a second index /fresh built over REST (_bulk of
     250,000 docs in bodies of 10,000, _flush to one 2^18 segment, 1,000
     DELETE _doc, search: no deleted id, recall at the target over the
     live docs), then DELETE /fresh; adc_scan launched. Reported: serial
     single-vector latency p50/p99 over 200 requests (and of the same
     queries searched in process, one at a time), QPS of 32 keep-alive
     client threads over 8 s after a 4 s warm pass with the mean
     dispatch_rows and the share of answers equal to the in-process ones,
     REST ingest docs/s (with the service's JSON parse share) and flush
     vec/s, peak device memory (while serving /sift, and over the phase), and a
     torch.profiler trace of one 32-client second (device busy share; host
     ms per request by stage from the service's stage timers). The gRPC
     surface is not driven here: the card's machine has no grpcio;
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
 6b. GIST parity: bench.py's own gist cell (100,000 x 960, cosine, latent
     32, seed 41, PQ64, 512 queries: decoded bf16 scan, top-50, exact
     rerank) on the port, recall@10 reported beside the JAX package's
     0.9822 on the TPU (BENCH_r04.json);
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
  9. the other quantizers, anisotropic PQ and the hierarchy layer, each a
     fresh index over the latent-16 corpus, k=10. 9a, NVQ
     (quantization_type "nvq+pq"): NVQ's fit + encode timed alone on one
     flush's rows, then 1,000,000 rows in flushes of 250,000, 250,000
     (the NVQ decoded-scan tier) and 500,000 (beam tier: auxiliary-PQ
     provider, rerank against NVQ-decoded rows); the bytes each segment
     holds on the card against fp32 rows; recall and ms/query; a delete of
     a twentieth of the docs, a force_merge (NVQ and PQ recomputed from the
     decoded rows), a reopen. 9b, scalar ("1bit", "4bit"): one flush of
     500,000 rows each (beam tier, Hamming provider, fp32 rerank), recall
     and ms/query at overquery 5, 10 and 20; held to exact fp32 scores,
     a rerank that ran and recall that rises with overquery (one bit a
     dimension is reported, not held to the target). 9c, anisotropic PQ +
     hierarchy over unit-norm rows, inner product: flushes of 250,000
     (scan tier: adc_scan over anisotropic codes) and 500,000 (beam tier
     after the upper layer's descent). Beam-tier recall is held at the
     default ef_search where that reaches the target, else at BEAM_EF,
     and both are reported. Profiles of one 512-query batch on 9a's beam
     segment and on 9b's 4-bit index.
 11. sharded search (after 8b), parallel/: ShardedVectorIndex(<service
     root>/shardy/vec, DiskAnnConfig(dim=128), n_shards=4, device="cuda")
     over phase 4's rows (doc id mod 4: four shards of one 2^18 segment
     each, flushed side by side). (a) the host fan-out (each shard's own
     search on the search pool, adc_scan) over --queries queries; (b)
     attach_mesh(make_mesh(["cuda:0"] * 4)): the mesh path, at the default
     ef_search (reported) and BEAM_EF (held to the target), exactly one
     restack per shard registry and no reject; (c) churn: a flush of
     50,000 rows (a fifth of them updates of live docs) into every shard
     but the last, then 10,000 deletes: G = 2, a partial restack per shard
     registry, answers held as 8a holds them (no deleted id, the newest
     vector's exact score, recall over the live rows); (d) over REST:
     KnnService(root, device="cuda", mesh=...), PUT /shardy with
     number_of_shards 4 attaches the directory: _count, 2-D bodies of 512
     equal to (c)'s in-process answers, a knn_score l2 script equal to
     numpy's exact top-10 up to ties, the stats deltas; (e) phase 7's
     500,000 rows as 4 on_disk shards: the approx-only mesh path and its
     paged rerank, exact fp32 scores, recall at the target; (f)
     dryrun(make_mesh(["cuda:0"] * 4)). Reported: ms/query of each path,
     restack seconds, peak device memory;
 12. the quantized build: DiskAnnConfig(dim=128, mode="on_disk", m=32,
     num_pq_subspaces=64), build_batch_size 8192 (bench.py's graph tier),
     2,200,000 rows (capacity 2^22) flushed through flush(device_rows=...)
     from rows already on the card. Held: the graph built from the bf16
     decoded rows, the entry a live, used ordinal; then a 200,000-row flush
     (a 2^18 scan-tier segment) and 2,048 queries under the default and the
     tight breaker (the 2^22 segment on the beam tier; decode_scan on the
     scan segment under the tight one), recall held at the default
     ef_search where it reaches the target, else at BEAM_EF; a reopen gives
     the same top-10. Reported: vec/s by stage, peak device memory against
     the decoded bf16 + adjacency + codes the segment holds.
 13. the graph build profile (last): GraphIndexBuilder(dim=128,
     max_degree=32, beam_width=100), DiskAnnConfig(dim=128)'s build, over
     phase 4's first 250,000 rows on the card, once as it runs and once
     with models/builder.py's BUILD_PROFILE on; then add_nodes of the next
     50,000 rows into the profiled graph with the profile on (a merge's
     delta inserts). Printed for each: the wall, rounds, nodes inserted,
     seconds and share of the wall by phase, the phases' sum against the
     wall, and the unprofiled wall beside the profiled one. Held:
     nodes_inserted equals the rows given, rounds the ramp's count, the
     phases' sum 0.85-1.0 of the profiled wall, recall@10 of the profiled
     250,000-row graph (beam search, exact provider, ef_search 100, 2,048
     of phase 4's queries) within 0.01 of the unprofiled one's, and the
     300,000-node graph at the recall target; ground truth from
     ground_truth_topk_stream over 2^16-row host blocks.
The in_memory corpus is the latent-16 "sift-like" generator of bench.py
(make_data), the GIST-shaped one the latent-32 960-d generator of
bench.py's gist section, both made with numpy from --seed. The last two
lines are the kernel JSON record and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import gc
import http.client
import importlib.util
import json
import os
import re
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
# phase 6b: bench.py's gist cell (sec_gist at its default N and Q) and the
# recall the JAX package read there on the TPU (BENCH_r04.json)
GIST_PARITY_N, GIST_PARITY_Q, GIST_PARITY_REF = 100_000, 512, 0.9822
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
# phase 9a: NVQ flushes of capacities 2^18, 2^18 (decoded-scan tier) and
# 2^19 (beam tier); a twentieth of the docs deleted before the merge
NVQ_FLUSHES = (250_000, 250_000, 500_000)
NVQ_DELETE_SHARE = 20
# phase 9b: one 2^19 flush per scalar mode, searched at these overquery
# factors
SCALAR_N = 500_000
SCALAR_MODES = ("1bit", "4bit")
SCALAR_OVERQUERY = (5, 10, 20)
# phase 9c: capacities 2^18 (scan tier) and 2^19 (beam tier). On this
# corpus (intrinsic dimension about 14) a score threshold of 0.2 resolves to
# eta = 1, which is plain PQ; 0.4 gives eta about 2.5
ANISO_FLUSHES = (250_000, 500_000)
ANISO_THRESHOLD = 0.4
# phase 11: phase 4's corpus in 4 shards of one 2^18 segment each (4 shards
# on one card, as one OpenSearch node holds several); the churn adds
# CHURN rows (a fifth of them updates) to all shards but the last, then
# deletes CHURN_DELETES docs
SHARDS = 4
CHURN, CHURN_DELETES = 50_000, 10_000
# phase 12: bench.py's graph tier (m=32, PQ64, build_batch_size 8192 at
# >= 2^22), cut from its 4,194,304 rows to 2,200,000: the capacity (and so
# every device array of the segment) is the same 2^22, the build about half;
# then a 2^18 scan-tier flush, where the tight breaker launches decode_scan
QB_N, QB_SCAN_N, QB_BATCH = 2_200_000, 200_000, 8192
# phase 13: DiskAnnConfig(dim=128)'s graph build over phase 4's first
# PROF_N rows, then a delta insert of PROF_ADD more; recall on PROF_Q
# queries against ground truth streamed in PROF_BLOCK-row blocks
PROF_N, PROF_ADD, PROF_Q, PROF_BLOCK = 250_000, 50_000, 2048, 1 << 16
PROF_DEGREE, PROF_BEAM = 32, 100
# phase 4's flush rate before this phase existed (PERF.md §5)
EARLIER_FLUSH_VEC_S = 25_000
ON_DISK_SPANS = ("approximate", "rerank_gather", "rerank_score")
# H100 SXM peaks (NVIDIA data sheet, 700 W): the kernels' bounds
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12  # float32 outside the tensor cores
PEAK_BF16_S = 989e12  # bf16 tensor cores, dense
# shared memory: 32 banks, one 4-byte access each a clock, per SM
SMEM_LOOKUPS_PER_CLOCK = 32


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


def lookup_bound_ms(lookups: float) -> float:
    """The least time `lookups` shared-memory lookups take on this card:
    SMs x 32 lookups a clock (one a bank, no conflicts) at the SM's
    maximum clock as nvidia-smi reports it."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return lookups / (sms * SMEM_LOOKUPS_PER_CLOCK * mhz * 1e6) * 1e3


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
    log(f"  adc_scan {ms:.4f} ms (bound {bound_ms:.4f} ms, {bound_by}; "
        f"shared-memory lookup bound {lookup_bound_ms(ops):.4f} ms for its "
        f"Q*N*M = {ops} table lookups)"
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


def compare_decode_scan(src: Path, shapes, seed: int) -> None:
    """Build another decode_scan.cu (`src`) with this checkout's flags into
    a temporary directory, hold it to the plain version, and time it beside
    this checkout's kernel in turns (other, this, this, other) at each
    (Q, N, M, K, dsub) shape."""
    import ctypes

    from opensearch_jvector_tpu_torch.ops import _kernels
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import (
        decode_scan,
        decode_scan_reference,
        kernel_error_bound,
    )

    this = _kernels.load("decode_scan")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_other_") as tmp:
        path = Path(tmp) / "libdecode_scan_other.so"
        proc = subprocess.run(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", str(path),
             str(src)], capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        for line in _kernels.ptxas_summary(proc.stdout + proc.stderr):
            log(f"  ptxas other {src.name}: {line}")
        libs = {"other": ctypes.CDLL(str(path)), "this": this}
        try:
            for i, (q, n, m, k, dsub) in enumerate(shapes):
                gen = torch.Generator(device="cuda").manual_seed(seed + i)
                q_c = torch.randn((q, m * dsub), generator=gen, device="cuda")
                codes = torch.randint(0, k, (n, m), generator=gen,
                                      device="cuda", dtype=torch.uint8)
                cb = torch.randn((m, k, dsub), generator=gen, device="cuda")
                ref = decode_scan_reference(q_c, codes, cb)
                bound = kernel_error_bound(q_c, codes, cb)
                times = {"other": [], "this": []}
                for who in ("other", "this", "this", "other"):
                    _kernels._LIBS["decode_scan"] = libs[who]
                    err = decode_scan(q_c, codes, cb).sub_(ref).abs_()
                    bad = int((err > bound).sum())
                    del err
                    if bad:
                        raise AssertionError(
                            f"decode_scan ({who}) disagrees with its plain "
                            f"version at Q={q} N={n}: {bad} out of bound")
                    times[who].append(cuda_ms(
                        lambda: decode_scan(q_c, codes, cb), 5))
                log(f"  decode_scan Q={q} N={n} M={m} dsub={dsub}: other "
                    f"({src.name}) {times['other']} ms, this checkout "
                    f"{times['this']} ms (in turns: other, this, this, "
                    f"other)")
                del ref, bound
        finally:
            _kernels._LIBS["decode_scan"] = this


def profile_batch(index, queries, sc, expect: str | None = None) -> None:
    """Where one search batch's time goes: device time by kernel and the
    device's busy share of the batch's wall time (torch.profiler). The
    same batch runs once untraced first, as the schedule's warm-up step:
    a trace that starts cold can miss the first kernels launched after it
    starts (the on_disk scan's prep and decode_scan kernels come first in
    a batch). A trace can still drop a batch's device records (seen once:
    none kept of a 622 ms batch), so a trace with no device row, or
    without the kernel named `expect`, is taken again, at most 3 times;
    each retake and a kernel still missing are reported, with the
    launches the batch made and every device row the trace kept."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan

    # device-only rows (kernels, copies); CPU-side ops and the profiler
    # ranges ("query" and the on_disk stages, which the trace also shows as
    # device annotations) would count their kernels' time twice
    ranges = ("query",) + ON_DISK_SPANS
    for attempt in range(1, 4):
        traced = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: traced.append(
                         p.key_averages())) as prof:
            index.search(queries, sc)
            torch.cuda.synchronize()
            prof.step()
            before = kernel_counts(adc_scan, decode_scan)
            t0 = time.monotonic()
            index.search(queries, sc)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
            prof.step()
        made = {k: v - before[k]
                for k, v in kernel_counts(adc_scan, decode_scan).items()}
        averages = traced[0]
        rows = [(e.self_device_time_total, e.key, e.count)
                for e in averages
                if e.self_cpu_time_total == 0 and e.key not in ranges
                and not e.key.startswith("ProfilerStep")]
        rows = sorted((r for r in rows if r[0] > 0), reverse=True)
        if rows and (expect is None
                     or any(expect in key for _, key, _ in rows)):
            break
        log(f"  trace {attempt} of 3 kept {len(rows)} device rows"
            + (f" and no {expect}" if expect else "") + f"; the batch's "
            f"launches {made}")
    busy = sum(r[0] for r in rows)
    log(f"  profile of one {queries.shape[0]}-query batch: wall "
        f"{wall_us / 1000:.3f} ms, device busy {busy / 1000:.3f} ms "
        f"({100 * busy / wall_us:.1f}% of wall)")
    for us, key, count in rows[:10]:
        log(f"    {us / 1000:9.3f} ms  x{count:<4d} {key[:90]}")
    if expect and not any(expect in key for _, key, _ in rows):
        log(f"  {expect} is missing from the trace: device busy is "
            f"understated; the batch's launches {made}; device rows "
            + "; ".join(f"{key[:60]} x{count}" for _, key, count in rows))
    # the on_disk search's stages (profiler ranges in index/reader.py), on
    # the host's clock
    spans = {}
    for e in averages:
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


def mma_counts(lib: Path) -> tuple[str, int | None]:
    """How many tensor-core instructions the SASS of decode_scan_kernel in
    `lib` holds, HGMMA (wgmma) and HMMA (mma.sync), as a line to print and
    the HGMMA count (None when cuobjdump is missing or fails); never
    raises."""
    tool = cuobjdump()
    if tool is None:
        return "cuobjdump not available", None
    try:
        proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, timeout=120, check=False)
    except (OSError, subprocess.SubprocessError) as e:
        return f"cuobjdump failed: {e}", None
    if proc.returncode != 0:
        return f"cuobjdump failed (exit {proc.returncode})", None
    counts, inside = {"HGMMA": 0, "HMMA": 0}, False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            inside = "decode_scan_kernel" in line
        elif inside:
            for op in counts:
                if re.search(rf"\b{op}\.", line):
                    counts[op] += 1
    return (f"{counts['HGMMA']} HGMMA and {counts['HMMA']} HMMA "
            f"instructions in decode_scan_kernel ({tool})", counts["HGMMA"])


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


def check_exact_scores(what, ids, scores, queries, rows_dev) -> None:
    """Every returned score is the exact euclidean score of its doc's
    vector `rows_dev[doc]` (rtol 1e-3, atol 1e-6)."""
    q = torch.as_tensor(queries, device="cuda")
    got = torch.as_tensor(scores, device="cuda")
    for s in range(0, ids.shape[0], BATCH):
        rows = rows_dev[torch.as_tensor(ids[s: s + BATCH], device="cuda")]
        d2 = torch.sum((rows - q[s: s + BATCH, None, :]) ** 2, -1)
        if not torch.allclose(got[s: s + BATCH], 1.0 / (1.0 + d2), rtol=1e-3,
                              atol=1e-6):
            raise AssertionError(f"{what}: a returned score is not the "
                                 f"score of the doc's newest vector")


def check_live_answers(what, ids, scores, queries, rows_dev, dead, truth, k):
    """Hold a search's answers to the live doc set -> recall@k: no id of
    `dead`, every score the exact euclidean score of the doc's newest
    vector `rows_dev[doc]` (a superseded copy would score otherwise), and
    recall against `truth` at the target."""
    from opensearch_jvector_tpu_torch.utils.ground_truth import recall_at_k

    if np.isin(ids, dead).any():
        raise AssertionError(f"{what}: a deleted doc id came back")
    check_exact_scores(what, ids, scores, queries, rows_dev)
    recall = recall_at_k(ids, truth, k)
    if recall < RECALL_TARGET:
        raise AssertionError(f"{what}: recall@{k} {recall} < {RECALL_TARGET}")
    return recall


def flush_rows(index, rows, lo: int, count: int):
    """add_batch + flush of rows[lo: lo + count] (doc id == row) ->
    (segment name, seconds, quantizer ms, graph build ms)."""
    from opensearch_jvector_tpu_torch.api.stats import Counter

    keys = (Counter.KNN_QUANTIZATION_TRAINING_TIME.value,
            Counter.KNN_GRAPH_BUILD_TIME.value)
    before = index.stats.snapshot()
    t0 = time.monotonic()
    index.add_batch(np.arange(lo, lo + count), rows[lo: lo + count])
    name = index.flush()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    after = index.stats.snapshot()
    return (name, dt) + tuple(after[k] - before[k] for k in keys)


def counter_deltas(index, fn, *counters):
    """Run fn() -> (its result, the deltas of `counters` over the call)."""
    before = index.stats.snapshot()
    out = fn()
    after = index.stats.snapshot()
    return out, [after[c.value] - before[c.value] for c in counters]


def search_held(what, index, queries, truth, sc, deep, dead=None):
    """Search at the default ef_search and at BEAM_EF, report both, and
    hold the default where it reaches the target, else BEAM_EF -> (ids,
    scores, SearchConfig) of the held one."""
    from opensearch_jvector_tpu_torch.utils.ground_truth import recall_at_k

    runs = {}
    for cfg in (sc, deep):
        ids, scores, wall = search_all(index, queries, cfg)
        if dead is not None and np.isin(ids, dead).any():
            raise AssertionError(f"{what}: a deleted doc id came back")
        runs[cfg.resolved_ef()] = (recall_at_k(ids, truth, K), wall, ids,
                                   scores, cfg)
    log(f"  search {what}: " + "; ".join(
        f"ef_search {ef}: {1000 * run[1] / len(queries):.5f} ms/query "
        f"batched, recall@{K} {run[0]:.4f}" for ef, run in runs.items()))
    held = next((r for r in runs.values() if r[0] >= RECALL_TARGET), None)
    if held is None:
        raise AssertionError(f"{what}: recall@{K} below {RECALL_TARGET} at "
                             f"ef_search {list(runs)}")
    return held[2:]


def phase_9a(seed: int, n_queries: int, launches: dict) -> None:
    """NVQ (nvq+pq), in_memory: see the module docstring."""
    from opensearch_jvector_tpu_torch.api.config import (
        DiskAnnConfig,
        SearchConfig,
    )
    from opensearch_jvector_tpu_torch.index.index import VectorIndex
    from opensearch_jvector_tpu_torch.models import nvq as nvq_mod
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
    )

    n = sum(NVQ_FLUSHES)
    rng = np.random.default_rng(seed + 90)
    vectors, queries, _ = make_data(rng, n, n_queries, DIM)
    cfg = DiskAnnConfig(dim=DIM, quantization_type="nvq+pq")
    sc, deep = SearchConfig(k=K), SearchConfig(k=K, ef_search=BEAM_EF)
    log(f"[9a/13] NVQ (nvq+pq, {cfg.nvq_num_subvectors} subvectors): {n} x "
        f"{DIM} in flushes of {NVQ_FLUSHES}, {n_queries} queries, k={K}")
    # NVQ alone on one flush's rows
    block = torch.as_tensor(vectors[: NVQ_FLUSHES[0]], device="cuda")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    nvq = nvq_mod.train_nvq(block, cfg.nvq_num_subvectors)
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    t0 = time.monotonic()
    mse = float(nvq_mod.reconstruction_mse(nvq, block))
    decode_s = time.monotonic() - t0
    log(f"  NVQ fit + encode of {block.shape[0]} rows alone: {fit_s:.3f} s "
        f"(35 grid points); decode + error {decode_s:.3f} s; "
        f"reconstruction MSE {mse:.3e} against a row variance of "
        f"{float(block.var()):.3e}")
    if not np.isfinite(mse) or mse > 1e-3 * float(block.var()):
        raise AssertionError(f"NVQ reconstruction MSE {mse}")
    del block, nvq
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nvq_") as root:
        index = VectorIndex(root, cfg, device="cuda")
        lo, held_total = 0, 0
        for count in NVQ_FLUSHES:
            name, dt, quant_ms, graph_ms = flush_rows(index, vectors, lo,
                                                      count)
            lo += count
            seg = index._reader(name).seg
            if (seg.vectors is not None or seg.nvq is None
                    or (Path(root) / name / "rows.f32").exists()):
                raise AssertionError("an NVQ segment kept fp32 rows")
            parts = {"nvq bytes": seg.nvq.bytes_, "nvq params":
                     seg.nvq.params, "pq codes": seg.pqv.codes}
            held = sum(t.numel() * t.element_size() for t in parts.values())
            held_total += held
            cap = seg.capacity()
            log(f"  flush {name}: {count} vectors in {dt:.2f} s = "
                f"{count / dt:.0f} vec/s (PQ + NVQ train+encode {quant_ms} "
                f"ms, graph build {graph_ms} ms), capacity {cap} "
                f"({'beam' if cap > 1 << 18 else 'NVQ decoded-scan'} tier); "
                f"on the card: " + ", ".join(
                    f"{k} {t.numel() * t.element_size()} B"
                    for k, t in parts.items())
                + f" = {held} B against {cap * DIM * 4} B of fp32 rows")
        log(f"  {n} rows hold {held_total} B of codes and parameters on the "
            f"card against {n * DIM * 4} B as fp32; peak device memory of "
            f"the three flushes {torch.cuda.max_memory_allocated()} B")
        gt = ground_truth_topk(torch.as_tensor(queries, device="cuda"),
                               torch.as_tensor(vectors, device="cuda"), K,
                               SimilarityFunction.EUCLIDEAN)
        torch.cuda.reset_peak_memory_stats()
        index.search(queries[:BATCH], sc)  # warm: the decoded caches
        adc_scan.launches = decode_scan.launches = 0
        search_held("3 NVQ segments (2 scanned, 1 beam)", index, queries, gt,
                    sc, deep)
        launches["nvq"] = kernel_counts(adc_scan, decode_scan)
        log(f"  peak device memory while searching (the two scan segments' "
            f"bf16 decoded caches included): "
            f"{torch.cuda.max_memory_allocated()} B")
        beam = index._reader(name)
        res = beam.search(queries[:BATCH], sc)
        log(f"  the beam segment alone, one {BATCH}-query batch: expanded "
            f"{res.expanded}, reranked {res.reranked} (NVQ decode_rows)")
        if res.expanded <= 0 or res.reranked <= 0:
            raise AssertionError("the NVQ beam segment did not expand and "
                                 "rerank")
        profile_batch(beam, queries[:BATCH], sc)

        doomed = rng.choice(n, n // NVQ_DELETE_SHARE, replace=False)
        keep = np.setdiff1d(np.arange(n), doomed)
        truth = live_truth(queries, vectors, keep, K)
        index.delete(doomed)
        index.time_merge_stages = True
        t0 = time.monotonic()
        merged = index.force_merge()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        seg = index._reader(merged).seg
        log(f"  delete of {doomed.size} docs, force_merge -> {merged} in "
            f"{dt:.2f} s (" + ", ".join(
                f"{k} {v:.2f} s" for k, v in index.last_merge_timings.items())
            + f"): capacity {seg.capacity()}, used ordinals "
            f"{seg.docmap.num_ordinals}, NVQ and PQ recomputed from the "
            f"decoded rows")
        if (index.segment_names != [merged] or index.has_deletes
                or seg.nvq is None or seg.vectors is not None
                or seg.docmap.num_ordinals != keep.size):
            raise AssertionError("the NVQ merge left another segment")
        ids, _, held = search_held("after the merge (one beam segment)",
                                   index, queries, truth, sc, deep, doomed)
        index.close()
        again = VectorIndex(root, device="cuda")
        same = bool((again.search(queries[:BATCH], held).doc_ids
                     == ids[:BATCH]).all())
        log(f"  reopen: {again.segment_names}, identical top-{K} ids for "
            f"{BATCH} queries: {same}")
        again.close()
        if not same:
            raise AssertionError("the reopened NVQ index differs")
    del vectors, queries, gt, truth
    gc.collect()
    torch.cuda.empty_cache()


def phase_9b(seed: int, launches: dict) -> None:
    """Scalar 1-bit and 4-bit, in_memory: see the module docstring."""
    from opensearch_jvector_tpu_torch.api.config import (
        DiskAnnConfig,
        SearchConfig,
    )
    from opensearch_jvector_tpu_torch.api.stats import Counter
    from opensearch_jvector_tpu_torch.index.index import VectorIndex
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
        recall_at_k,
    )

    rng = np.random.default_rng(seed + 91)
    vectors, queries, _ = make_data(rng, SCALAR_N, VAMANA_QUERIES, DIM)
    rows_dev = torch.as_tensor(vectors, device="cuda")
    gt = ground_truth_topk(torch.as_tensor(queries, device="cuda"), rows_dev,
                           K, SimilarityFunction.EUCLIDEAN)
    log(f"[9b/13] scalar quantization {SCALAR_MODES}: {SCALAR_N} x {DIM} in "
        f"one flush each, {VAMANA_QUERIES} queries, k={K}, overquery "
        f"{SCALAR_OVERQUERY}")
    adc_scan.launches = decode_scan.launches = 0
    for quant in SCALAR_MODES:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_sq_") as root:
            index = VectorIndex(root, DiskAnnConfig(
                dim=DIM, quantization_type=quant), device="cuda")
            name, dt, quant_ms, graph_ms = flush_rows(index, vectors, 0,
                                                      SCALAR_N)
            seg = index._reader(name).seg
            log(f"  {quant} flush {name}: {SCALAR_N} vectors in {dt:.2f} s "
                f"= {SCALAR_N / dt:.0f} vec/s (threshold training + encode "
                f"{quant_ms} ms, graph build {graph_ms} ms), "
                f"{seg.scalar_codes.shape[1]} code bytes a row, capacity "
                f"{seg.capacity()} (beam tier)")
            ladder = []
            for over in SCALAR_OVERQUERY:
                cfg = SearchConfig(k=K, overquery_factor=over)
                index.search(queries[:BATCH], cfg)  # warm
                (ids, scores, wall), (reranked, expanded) = counter_deltas(
                    index, lambda: search_all(index, queries, cfg),
                    Counter.KNN_QUERY_RERANKED_COUNT,
                    Counter.KNN_QUERY_EXPANDED_NODES)
                check_exact_scores(f"{quant} overquery {over}", ids, scores,
                                   queries, rows_dev)
                ladder.append(recall_at_k(ids, gt, K))
                log(f"  {quant} overquery {over}: "
                    f"{1000 * wall / len(queries):.5f} ms/query batched, "
                    f"recall@{K} {ladder[-1]:.4f}, expanded {expanded}, "
                    f"reranked {reranked}, every score the doc's exact fp32 "
                    f"score")
                if reranked <= 0 or expanded <= 0:
                    raise AssertionError(f"{quant}: the Hamming beam search "
                                         f"or its rerank did not run")
            reached = [o for o, r in zip(SCALAR_OVERQUERY, ladder)
                       if r >= RECALL_TARGET]
            log(f"  {quant}: smallest overquery of {SCALAR_OVERQUERY} that "
                f"reaches recall@{K} {RECALL_TARGET}: "
                f"{reached[0] if reached else 'none'}")
            if ladder != sorted(ladder) or (ladder[-1] <= ladder[0]
                                            and ladder[0] < 0.999):
                raise AssertionError(f"{quant}: recall does not rise with "
                                     f"overquery: {ladder}")
            if quant == "4bit":
                profile_batch(index, queries[:BATCH], SearchConfig(k=K))
            index.close()
            del index, seg
            gc.collect()
            torch.cuda.empty_cache()
    launches["scalar"] = kernel_counts(adc_scan, decode_scan)
    if any(launches["scalar"].values()):
        raise AssertionError("a scalar search launched a PQ kernel")


def phase_9c(seed: int, launches: dict, plain_pq_ms: int) -> None:
    """Anisotropic PQ + hierarchy, inner product: see the module
    docstring. `plain_pq_ms` is phase 4's plain PQ train+encode time for a
    flush of the same size."""
    from opensearch_jvector_tpu_torch.api.config import (
        DiskAnnConfig,
        SearchConfig,
    )
    from opensearch_jvector_tpu_torch.api.stats import Counter
    from opensearch_jvector_tpu_torch.index.index import VectorIndex
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
    )

    n = sum(ANISO_FLUSHES)
    rng = np.random.default_rng(seed + 92)
    vectors, queries, _ = make_data(rng, n, VAMANA_QUERIES, DIM)
    # unit-norm rows, as embedding corpora served by inner product are
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    dot = SimilarityFunction.DOT_PRODUCT
    cfg = DiskAnnConfig(dim=DIM, similarity=dot, hierarchy_enabled=True,
                        pq_anisotropic_threshold=ANISO_THRESHOLD)
    sc, deep = SearchConfig(k=K), SearchConfig(k=K, ef_search=BEAM_EF)
    log(f"[9c/13] anisotropic PQ (threshold {ANISO_THRESHOLD}) + hierarchy, "
        f"inner product over unit-norm rows: {n} x {DIM} in flushes of "
        f"{ANISO_FLUSHES}, {VAMANA_QUERIES} queries, k={K}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_aniso_") as root:
        index = VectorIndex(root, cfg, device="cuda")
        lo = 0
        for count in ANISO_FLUSHES:
            name, dt, quant_ms, graph_ms = flush_rows(index, vectors, lo,
                                                      count)
            lo += count
            seg = index._reader(name).seg
            eta = seg.pqv.pq.aniso_eta
            members = int((seg.graph.upper_adjacency >= 0).any(1).sum())
            log(f"  flush {name}: {count} vectors in {dt:.2f} s = "
                f"{count / dt:.0f} vec/s; resolved eta {eta}, anisotropic "
                f"PQ train+encode {quant_ms} ms"
                + (f" (phase 4's plain PQ on a flush of this size: "
                   f"{plain_pq_ms} ms)" if count == ANISO_FLUSHES[0] else "")
                + f", graph build {graph_ms} ms; capacity {seg.capacity()}, "
                f"upper layer {members} members of width "
                f"{seg.graph.upper_adjacency.shape[1]} (4*sqrt(n) = "
                f"{int(4 * np.sqrt(count))})")
            if eta is None or eta <= 1.0:
                raise AssertionError(f"the codebooks are not anisotropic: "
                                     f"eta {eta}")
            if abs(members - int(4 * np.sqrt(count))) > 1:
                raise AssertionError(f"upper layer of {members} members")
        gt = ground_truth_topk(torch.as_tensor(queries, device="cuda"),
                               torch.as_tensor(vectors, device="cuda"), K,
                               dot)
        index.search(queries[:BATCH], sc)  # warm
        adc_scan.launches = decode_scan.launches = 0
        search_held("1 scan segment + 1 beam segment with the upper layer",
                    index, queries, gt, sc, deep)
        launches["aniso_hierarchy"] = kernel_counts(adc_scan, decode_scan)
        _, (expanded, base) = counter_deltas(
            index, lambda: search_all(index, queries, sc),
            Counter.KNN_QUERY_EXPANDED_NODES,
            Counter.KNN_QUERY_EXPANDED_BASE_LAYER_NODES)
        log(f"  expansions a query on the beam segment at ef_search "
            f"{sc.resolved_ef()}: upper layer "
            f"{(expanded - base) / len(queries):.2f}, base layer "
            f"{base / len(queries):.2f}; launches "
            f"{launches['aniso_hierarchy']}")
        if not expanded > base > 0:
            raise AssertionError("the upper layer was not descended")
        if launches["aniso_hierarchy"]["adc_scan"] <= 0:
            raise AssertionError("the anisotropic scan segment never "
                                 "launched adc_scan")
        index.close()
    del vectors, queries, gt
    gc.collect()
    torch.cuda.empty_cache()


class Rest:
    """One keep-alive HTTP/1.1 connection to the service; a status other
    than `expect` raises."""

    def __init__(self, port: int):
        self.conn = http.client.HTTPConnection("127.0.0.1", port,
                                               timeout=600)

    def __call__(self, method: str, path: str, body=None, expect=200,
                 raw: bytes | None = None):
        if raw is None and body is not None:
            raw = json.dumps(body).encode()
        self.conn.request(method, path, raw,
                          {"Content-Type": "application/json"})
        r = self.conn.getresponse()
        data = json.loads(r.read())
        if r.status != expect:
            raise AssertionError(f"{method} {path}: HTTP {r.status} "
                                 f"{str(data)[:300]}")
        return data

    def close(self) -> None:
        self.conn.close()


def hit_arrays(hits: list) -> tuple[np.ndarray, np.ndarray]:
    """A response's hits -> (ids, float32 scores)."""
    return (np.array([h["_id"] for h in hits], np.int64),
            np.array([h["_score"] for h in hits], np.float32))


def rest_clients(port: int, bodies: list[bytes], n_cli: int,
                 seconds: float) -> dict:
    """`n_cli` keep-alive clients (threads of this process, as bench.py's
    REST section runs them) sending single-vector knn bodies round-robin
    for `seconds` -> {"served", "wall", "answers": [(body index, ids,
    dispatch_rows)], "reconnects"}. A non-200 answer raises."""
    import threading

    stop = time.monotonic() + seconds
    answers = [[] for _ in range(n_cli)]
    reconnects = [0] * n_cli
    errors = []

    def client(ti):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        i = ti
        while time.monotonic() < stop and not errors:
            try:
                conn.request("POST", "/sift/_search", bodies[i % len(bodies)],
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                data = json.loads(r.read())
            except (ConnectionError, OSError, http.client.HTTPException):
                # a socket torn down under load: reconnect, as a load
                # generator does (the attempt counts nothing)
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
                reconnects[ti] += 1
                continue
            if r.status != 200:
                errors.append(f"HTTP {r.status} {str(data)[:300]}")
                break
            answers[ti].append((i % len(bodies),
                                [h["_id"] for h in data["hits"]["hits"]],
                                data["profile"]["dispatch_rows"]))
            i += n_cli
        conn.close()

    threads = [threading.Thread(target=client, args=(t,))
               for t in range(n_cli)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise AssertionError(f"a concurrent search failed: {errors[0]}")
    flat = [a for per in answers for a in per]
    return {"served": len(flat), "wall": wall, "answers": flat,
            "reconnects": sum(reconnects)}


def phase_10(root: str, vectors, queries, mem_ids, mem_scores, truth, basis,
             seed: int, smi: str, launches: dict) -> None:
    """Serving over REST on phase 4's index directory: see the module
    docstring."""
    from torch.profiler import ProfilerActivity, profile

    from opensearch_jvector_tpu_torch.api.config import SearchConfig
    from opensearch_jvector_tpu_torch.api.stats import STATS, Counter
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.service.http import STAGES, KnnService
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
        recall_at_k,
    )

    n, nq = vectors.shape[0], queries.shape[0]
    n_seg = FLUSHES
    log(f"[10/13] serving over REST: KnnService(device=\"cuda\") attaches "
        f"phase 4's {n} x {DIM} index as /sift ({n_seg} segments); {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    adc_scan.launches = decode_scan.launches = 0
    t_phase = time.monotonic()
    svc = KnnService(root, device="cuda", batch_window_ms=2.0)
    svc.start()
    rest = Rest(svc.port)
    mgr = svc.manager
    mapping = {"properties": {"vec": {"type": "knn_vector",
                                      "dimension": DIM}}}
    try:
        t0 = time.monotonic()
        rest("PUT", "/sift", {"mappings": mapping})
        count = rest("GET", "/sift/_count")["count"]
        knn = {"vec": {"vector": queries[0].tolist(), "k": K}}
        rest("POST", "/sift/_search", {"query": {"knn": knn}})  # loads
        log(f"  PUT /sift + first search (segment loads): "
            f"{time.monotonic() - t0:.2f} s; _count {count}")
        if count != n:
            raise AssertionError(f"_count {count} != {n}")
        keys = (Counter.KNN_QUERY_COUNT, Counter.KNN_QUERY_WITH_FILTER_COUNT,
                Counter.SCRIPT_QUERY_REQUESTS)
        stats0 = STATS.snapshot()
        expect = dict.fromkeys(keys, 0)

        # batched bodies: the in-process answers of phase 4, batch by batch
        ids, scores = [], []
        t0 = time.monotonic()
        for s in range(0, nq, BATCH):
            out = rest("POST", "/sift/_search", {"size": K, "query": {"knn": {
                "vec": {"vector": queries[s: s + BATCH].tolist(), "k": K}}}})
            for r in out["responses"]:
                i_, s_ = hit_arrays(r["hits"]["hits"])
                ids.append(i_)
                scores.append(s_)
        wall = time.monotonic() - t0
        ids, scores = np.stack(ids), np.stack(scores)
        expect[Counter.KNN_QUERY_COUNT] += nq * n_seg
        same_ids = bool((ids == mem_ids).all())
        score_gap = float(np.abs(scores - mem_scores).max())
        recall = recall_at_k(ids, truth, K)
        log(f"  batched bodies of {BATCH}: {nq} queries in {wall:.2f} s = "
            f"{1000 * wall / nq:.4f} ms/query over REST; ids equal to "
            f"phase 4's in-process search: {same_ids}, largest score gap "
            f"{score_gap:.3e} (limit 1e-6), recall@{K} {recall:.4f}")
        if not same_ids or score_gap > 1e-6 or recall < RECALL_TARGET:
            raise AssertionError("batched REST answers differ from the "
                                 "in-process search")

        frng = np.random.default_rng(seed + 100)
        q = queries[1]
        # restrictive filter: 40 ids (<= k * overquery = 50): exact fallback
        flt = np.sort(frng.choice(n, 40, replace=False))
        out = rest("POST", "/sift/_search", {"query": {"knn": {"vec": {
            "vector": q.tolist(), "k": K, "filter": flt.tolist()}}}})
        got, got_s = hit_arrays(out["hits"]["hits"])
        d2 = ((vectors[flt].astype(np.float64) - q) ** 2).sum(-1)
        order = np.argsort(d2, kind="stable")[:K]
        want = flt[order]
        ok = (np.array_equal(got, want)
              and np.allclose(got_s, 1.0 / (1.0 + d2[order]), rtol=1e-5))
        log(f"  restrictive filter (40 ids, exact fallback): ids equal to "
            f"numpy's exact top-{K}: {ok}")
        if not ok:
            raise AssertionError(f"exact fallback: {got} != {want}")

        # broad filter: 100,000 ids (a tenth of a smaller --n), the ANN
        # path with the accept mask
        n_broad = min(100_000, n // 10)
        flt = np.sort(frng.choice(n, n_broad, replace=False))
        qb = queries[:32]
        out = rest("POST", "/sift/_search", {"size": K, "query": {"knn": {
            "vec": {"vector": qb.tolist(), "k": K,
                    "filter": flt.tolist()}}}})
        got = np.stack([hit_arrays(r["hits"]["hits"])[0]
                        for r in out["responses"]])
        expect[Counter.KNN_QUERY_COUNT] += 32 * n_seg
        expect[Counter.KNN_QUERY_WITH_FILTER_COUNT] += 32 * n_seg
        gt_f = flt[ground_truth_topk(
            torch.as_tensor(qb, device="cuda"),
            torch.as_tensor(vectors[flt], device="cuda"), K,
            SimilarityFunction.EUCLIDEAN)]
        inside = bool(np.isin(got, flt).all())
        log(f"  broad filter ({n_broad} ids, ANN): every hit in the filter: "
            f"{inside}, recall@{K} against filtered exact search "
            f"{recall_at_k(got, gt_f, K):.4f} over 32 queries")
        if not inside or got.shape != (32, K):
            raise AssertionError("broad filter returned a doc outside it")

        # radial: a floor between the 500th and 501st exact scores (float64
        # on the host); docs within 1e-6 of the floor may fall either way
        d2 = ((vectors.astype(np.float64) - q) ** 2).sum(-1)
        exact = 1.0 / (1.0 + d2)
        top = np.sort(exact)[::-1][:501]
        floor = float((top[499] + top[500]) / 2.0)
        out = rest("POST", "/sift/_search", {"size": 10_000, "query": {
            "knn": {"vec": {"vector": q.tolist(), "min_score": floor}}}})
        got, got_s = hit_arrays(out["hits"]["hits"])
        hit = np.zeros(n, bool)
        hit[got] = True
        must = exact >= floor + 1e-6
        may = exact >= floor - 1e-6
        ok = (bool((got_s >= floor).all()) and bool(hit[must].all())
              and not bool((hit & ~may).any()))
        log(f"  radial min_score {floor:.6f}: {got.size} hits, all at or "
            f"above the floor; the exact set holds {int(must.sum())} docs "
            f"(+{int((may & ~must).sum())} within 1e-6 of the floor), hit "
            f"set equal to it: {ok}")
        if not ok:
            raise AssertionError("radial search missed the exact set")

        # rescore: the candidates' exact fp32 scores
        out = rest("POST", "/sift/_search", {"size": K, "query": {"knn": {
            "vec": {"vector": qb.tolist(), "k": K,
                    "rescore": {"oversample_factor": 2.0}}}}})
        got = [hit_arrays(r["hits"]["hits"]) for r in out["responses"]]
        expect[Counter.KNN_QUERY_COUNT] += 32 * n_seg
        check_exact_scores("rescore", np.stack([g[0] for g in got]),
                           np.stack([g[1] for g in got]), qb,
                           torch.as_tensor(vectors, device="cuda"))
        log("  rescore (oversample 2.0): every score the doc's exact fp32 "
            "score")

        # knn_score script over every row
        out = rest("POST", "/sift/_search", {"size": K, "query": {
            "script_score": {"script": {
                "source": "knn_score", "lang": "knn", "params": {
                    "field": "vec", "space_type": "l2",
                    "query_value": q.tolist()}}}}})
        expect[Counter.SCRIPT_QUERY_REQUESTS] += 1
        got, got_s = hit_arrays(out["hits"]["hits"])
        want = np.argsort(d2, kind="stable")[:K]
        tied = np.isclose(1.0 / (1.0 + d2[got]),
                          1.0 / (1.0 + d2[want]), rtol=1e-6)
        ok = bool((got == want).all() or tied.all())
        log(f"  knn_score l2 script over {n} rows: ids equal to numpy's "
            f"exact top-{K} up to ties: {ok}")
        if not ok:
            raise AssertionError(f"script_score: {got} != {want}")

        # MMR
        out = rest("POST", "/sift/_search", {"size": K, "query": {"knn": {
            "vec": {"vector": q.tolist(), "k": K}}},
            "ext": {"mmr": {"diversity": 0.5}}})
        expect[Counter.KNN_QUERY_COUNT] += n_seg
        got = hit_arrays(out["hits"]["hits"])[0]
        log(f"  ext.mmr diversity 0.5: {len(set(got.tolist()))} distinct "
            f"ids of {K}")
        if len(set(got.tolist())) != K:
            raise AssertionError(f"MMR returned {got}")

        # derived source: GET _doc and docvalue_fields, bit for bit
        sample = frng.choice(n, 100, replace=False)
        exact_docs = all(
            np.array_equal(np.asarray(rest(
                "GET", f"/sift/_doc/{d}")["_source"]["vec"], np.float32),
                vectors[d]) for d in sample)
        out = rest("POST", "/sift/_search", {"size": K,
                                             "docvalue_fields": ["vec"],
                                             "query": {"knn": knn}})
        expect[Counter.KNN_QUERY_COUNT] += n_seg
        exact_dv = all(np.array_equal(
            np.asarray(h["fields"]["vec"][0], np.float32), vectors[h["_id"]])
            for h in out["hits"]["hits"])
        log(f"  derived source: GET _doc of 100 ids bit for bit: "
            f"{exact_docs}; docvalue_fields bit for bit: {exact_dv}")
        if not (exact_docs and exact_dv):
            raise AssertionError("a read-back vector differs")

        after = STATS.snapshot()
        deltas = {c: after[c.value] - stats0[c.value] for c in keys}
        log(f"  stats deltas {[(c.value, deltas[c]) for c in keys]}, "
            f"expected {[expect[c] for c in keys]}")
        if deltas != expect:
            raise AssertionError("the stats counters moved otherwise")

        # serial single-vector latency (the micro-batcher's 2 ms window is
        # part of every answer)
        lat = []
        for i in range(200):
            body = {"query": {"knn": {"vec": {"vector": queries[i].tolist(),
                                              "k": K}}}}
            t0 = time.perf_counter()
            rest("POST", "/sift/_search", body)
            lat.append(1000 * (time.perf_counter() - t0))
        p50, p99 = np.percentile(lat, [50, 99])
        # the same 200 queries in process, one at a time: the service's
        # share of the latency is the difference
        idx, sc = mgr.get("sift")["vec"], SearchConfig(k=K)
        lat_in = []
        for i in range(200):
            t0 = time.perf_counter()
            idx.search(queries[i: i + 1], sc)
            lat_in.append(1000 * (time.perf_counter() - t0))
        i50, i99 = np.percentile(lat_in, [50, 99])
        log(f"  serial single-vector latency over 200 requests: p50 "
            f"{p50:.3f} ms, p99 {p99:.3f} ms; in process "
            f"(VectorIndex.search of one query, 4 segments): p50 "
            f"{i50:.3f} ms, p99 {i99:.3f} ms ({smi})")

        # 32 concurrent keep-alive clients, micro-batched
        pool = min(nq, 2048)
        bodies = [json.dumps({"query": {"knn": {"vec": {
            "vector": queries[i].tolist(), "k": K}}}}).encode()
            for i in range(pool)]
        rest_clients(svc.port, bodies, 32, 4.0)  # warm pass
        run = rest_clients(svc.port, bodies, 32, 8.0)
        qps = run["served"] / run["wall"]
        rows = np.array([a[2] for a in run["answers"]])
        same = np.mean([a[1] == mem_ids[a[0]].tolist()
                        for a in run["answers"]])
        log(f"  32 clients, MicroBatcher 2 ms: {run['served']} answers in "
            f"{run['wall']:.2f} s = {qps:.1f} QPS, mean dispatch_rows "
            f"{rows.mean():.2f} (max {rows.max()}), answers whose ids equal "
            f"phase 4's in-process answer {same:.4f}, reconnects "
            f"{run['reconnects']} ({smi})")

        # one profiled second of the same load
        stage0 = dict(mgr.stage_seconds)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prun = rest_clients(svc.port, bodies, 32, 1.0)
            torch.cuda.synchronize()
        ranges = ("query",) + ON_DISK_SPANS
        dev = [(e.self_device_time_total, e.key, e.count)
               for e in prof.key_averages()
               if e.self_cpu_time_total == 0 and e.key not in ranges
               and e.self_device_time_total > 0]
        busy_us = sum(r[0] for r in dev)
        served = max(prun["served"], 1)
        stage_ms = {k: 1000 * (mgr.stage_seconds[k] - stage0[k]) / served
                    for k in STAGES}
        log(f"  profile of a 32-client second: {prun['served']} answers in "
            f"{prun['wall']:.2f} s, device busy {busy_us / 1000:.2f} ms = "
            f"{100 * busy_us / (1e6 * prun['wall']):.1f}% of wall; host ms "
            f"per request by stage (thread time, summed over the request's "
            f"threads): " + ", ".join(f"{k} {v:.3f}"
                                      for k, v in stage_ms.items()))
        for us, key, cnt in sorted(dev, reverse=True)[:6]:
            log(f"    {us / 1000:9.3f} ms  x{cnt:<5d} {key[:90]}")

        serving_peak = torch.cuda.max_memory_allocated()
        # a second index, built over REST
        n_f, body_docs, n_del = 250_000, 10_000, 1_000
        fresh = more_rows(np.random.default_rng(seed + 101), basis, n_f)
        rest("PUT", "/fresh", {"mappings": mapping})
        parse0 = mgr.stage_seconds["json_parse"]
        t0 = time.monotonic()
        for s in range(0, n_f, body_docs):
            docs = [{"_id": i, "vec": fresh[i].tolist()}
                    for i in range(s, s + body_docs)]
            rest("POST", "/fresh/_bulk", {"docs": docs})
        bulk_s = time.monotonic() - t0
        bulk_parse_s = mgr.stage_seconds["json_parse"] - parse0
        t0 = time.monotonic()
        seg = rest("POST", "/fresh/_flush")["segment"]
        flush_s = time.monotonic() - t0
        cap = mgr.get("fresh")["vec"]._reader(seg).seg.capacity()
        doomed = np.sort(np.random.default_rng(seed + 102).choice(
            n_f, n_del, replace=False))
        t0 = time.monotonic()
        for d in doomed:
            rest("DELETE", f"/fresh/_doc/{d}")
        del_s = time.monotonic() - t0
        count = rest("GET", "/fresh/_count")["count"]
        out = rest("POST", "/fresh/_search", {"size": K, "query": {"knn": {
            "vec": {"vector": queries[:BATCH].tolist(), "k": K}}}})
        got = np.stack([hit_arrays(r["hits"]["hits"])[0]
                        for r in out["responses"]])
        live = np.setdiff1d(np.arange(n_f), doomed)
        f_truth = live_truth(queries[:BATCH], fresh, live, K)
        f_recall = recall_at_k(got, f_truth, K)
        no_dead = not np.isin(got, doomed).any()
        log(f"  /fresh over REST: _bulk of {n_f} docs in bodies of "
            f"{body_docs}: {bulk_s:.2f} s = {n_f / bulk_s:.0f} docs/s "
            f"(the service's JSON parse {bulk_parse_s:.2f} s of it); "
            f"_flush {flush_s:.2f} s = {n_f / flush_s:.0f} vec/s (segment "
            f"{seg}, capacity {cap}); {n_del} DELETE _doc in {del_s:.2f} s; "
            f"_count {count}; {BATCH} queries: no deleted id {no_dead}, "
            f"recall@{K} {f_recall:.4f} over the live docs ({smi})")
        rest("DELETE", "/fresh")
        if (cap != 1 << 18 or count != n_f - n_del or not no_dead
                or f_recall < RECALL_TARGET):
            raise AssertionError("the index built over REST is wrong")
    finally:
        rest.close()
        svc.stop()
        mgr.close()
    launches["serving"] = kernel_counts(adc_scan, decode_scan)
    peak = torch.cuda.max_memory_allocated()
    log(f"  phase 10: {time.monotonic() - t_phase:.1f} s, peak device "
        f"memory {peak} B = {peak / 2**30:.2f} GiB over the phase "
        f"(/fresh's flush included), {serving_peak} B while serving /sift; "
        f"launches {launches['serving']}")
    if launches["serving"]["adc_scan"] <= 0:
        raise AssertionError("serving never launched adc_scan")
    gc.collect()
    torch.cuda.empty_cache()


def phase_6b(n_queries: int) -> float:
    """bench.py's gist cell (sec_gist) on the port: see the module
    docstring -> recall@K."""
    from opensearch_jvector_tpu_torch.index.reader import _decoded_scan_scores
    from opensearch_jvector_tpu_torch.models import pq as pq_mod
    from opensearch_jvector_tpu_torch.ops.distances import (
        SimilarityFunction,
        batched_candidate_scores,
    )
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
        recall_at_k,
    )

    gn, gdim, glat = GIST_PARITY_N, GIST_DIM, GIST_LATENT
    # bench.py's draws, in its order and dtypes
    grng = np.random.default_rng(41)
    ga = grng.standard_normal((glat, gdim)).astype(np.float32)
    ga /= np.sqrt(glat)
    gv = (grng.standard_normal((gn, glat)).astype(np.float32) @ ga
          + 0.05 * grng.standard_normal((gn, gdim)).astype(np.float32))
    gq = (grng.standard_normal((n_queries, glat)).astype(np.float32) @ ga
          + 0.05 * grng.standard_normal((n_queries, gdim)).astype(np.float32))
    cos = SimilarityFunction.COSINE
    vd, qd = torch.as_tensor(gv, device="cuda"), torch.as_tensor(
        gq, device="cuda")
    del gv
    torch.cuda.synchronize()
    t0 = time.monotonic()
    pq = pq_mod.train_pq(vd, cos, num_subspaces=GIST_M)
    pqv = pq_mod.PQVectors(pq=pq, codes=pq_mod.encode(pq, vd, cos))
    dec = pqv.decode_bf16()
    sq = torch.linalg.vecdot(dec.float(), dec.float())
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    scan = _decoded_scan_scores(qd, dec, sq, cos)
    _, top_i = torch.topk(scan, K * 5, dim=1)
    exact = batched_candidate_scores(qd, vd[top_i], cos)
    _, idx = torch.topk(exact, K, dim=1)
    ids = torch.gather(top_i, 1, idx).cpu().numpy()
    truth = ground_truth_topk(qd, vd, K, cos)
    recall = recall_at_k(ids, truth, K)
    gap = recall - GIST_PARITY_REF
    log(f"[6b/13] GIST parity: bench.py's gist cell ({gn} x {gdim}, cosine, "
        f"latent {glat}, seed 41, PQ{GIST_M}, {n_queries} queries: decoded "
        f"bf16 scan, top-{K * 5}, exact rerank) on the port: PQ train + "
        f"encode + decode {build_s:.1f} s, recall@{K} {recall:.4f}; "
        f"BENCH_r04's gist960_recall_at_k {GIST_PARITY_REF}, gap "
        f"{gap:+.4f} (a gap beyond 0.01 is a port fault)")
    del vd, qd, dec, sq, scan, exact, pqv
    gc.collect()
    torch.cuda.empty_cache()
    return recall


def _stat_deltas(before: dict, after: dict, *names) -> list:
    return [after[k] - before[k] for k in names]


def phase_11(vectors, queries, basis, vv, vq, seed: int, smi: str,
             launches: dict) -> None:
    """Sharded search: see the module docstring."""
    from opensearch_jvector_tpu_torch.api.config import (
        DiskAnnConfig,
        SearchConfig,
    )
    from opensearch_jvector_tpu_torch.api.stats import Counter
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.parallel.distributed import (
        ShardedVectorIndex,
    )
    from opensearch_jvector_tpu_torch.parallel.dryrun import dryrun
    from opensearch_jvector_tpu_torch.parallel.sharded import make_mesh
    from opensearch_jvector_tpu_torch.service.http import KnnService
    from opensearch_jvector_tpu_torch.utils.ground_truth import recall_at_k

    n, nq, s_n = vectors.shape[0], queries.shape[0], SHARDS
    rejects = [c.value for c in Counter if c.name.startswith("KNN_MESH_REJECT")]
    restack = (Counter.KNN_MESH_RESTACK_COUNT.value,
               Counter.KNN_MESH_RESTACK_PARTIAL_COUNT.value,
               Counter.KNN_MESH_RESTACK_TIME.value)
    log(f"[11/13] sharded: phase 4's {n} x {DIM} rows in {s_n} shards (doc id "
        f"mod {s_n}), {nq} queries in batches of {BATCH}, k={K}; {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.monotonic()
    svc_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_shardy_")
    root = os.path.join(svc_dir.name, "shardy", "vec")
    sc, deep = SearchConfig(k=K), SearchConfig(k=K, ef_search=BEAM_EF)
    idx = ShardedVectorIndex(root, DiskAnnConfig(dim=DIM), n_shards=s_n,
                             device="cuda")
    t0 = time.monotonic()
    idx.add_batch(np.arange(n), vectors)
    idx.flush()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    caps = [idx.shards[s]._reader(nm).seg.capacity()
            for s in range(s_n) for nm in idx.shards[s].segment_names]
    log(f"  add_batch + flush (the shards side by side on the search pool): "
        f"{dt:.2f} s = {n / dt:.0f} vec/s; segment capacities {caps}")
    if len(caps) != s_n or (n == 1_000_000 and set(caps) != {1 << 18}):
        raise AssertionError("the shards hold another segment set")
    truth = live_truth(queries, vectors, np.arange(n), K)

    # (a) the host fan-out: each shard's own search on the search pool
    idx.search(queries[:BATCH], sc)  # warm: segment loads
    adc_scan.launches = decode_scan.launches = 0
    ids, _, wall = search_all(idx, queries, sc)
    launches["sharded_host"] = kernel_counts(adc_scan, decode_scan)
    recall = recall_at_k(ids, truth, K)
    log(f"  (a) host fan-out: {1000 * wall / nq:.5f} ms/query batched, "
        f"recall@{K} {recall:.4f}, launches {launches['sharded_host']}")
    if recall < RECALL_TARGET or launches["sharded_host"]["adc_scan"] <= 0:
        raise AssertionError("host fan-out: recall or adc_scan missing")

    # (b) the mesh path: four shards on one card
    mesh = make_mesh(["cuda:0"] * s_n)
    idx.attach_mesh(mesh)
    s0 = idx.stats()
    idx.search(queries[:BATCH], deep)  # warm: the restack
    adc_scan.launches = decode_scan.launches = 0
    ids_d, _, wall_d = search_all(idx, queries, sc)
    ids, _, wall = search_all(idx, queries, deep)
    launches["sharded_mesh"] = kernel_counts(adc_scan, decode_scan)
    s1 = idx.stats()
    n_restack, _, restack_ms = _stat_deltas(s0, s1, *restack)
    n_reject = sum(_stat_deltas(s0, s1, *rejects))
    rec_d, recall = recall_at_k(ids_d, truth, K), recall_at_k(ids, truth, K)
    log(f"  (b) mesh {[str(d) for d in mesh]}: ef_search "
        f"{sc.resolved_ef()}: {1000 * wall_d / nq:.5f} ms/query batched, "
        f"recall@{K} {rec_d:.4f}; ef_search {BEAM_EF} (held): "
        f"{1000 * wall / nq:.5f} ms/query batched, recall@{K} {recall:.4f}; "
        f"restacks {n_restack} (one per shard registry), restack "
        f"{restack_ms / s_n / 1000:.3f} s, rejects {n_reject}, launches "
        f"{launches['sharded_mesh']}")
    if n_restack != s_n or n_reject or idx._mesh_state is None:
        raise AssertionError("the mesh path was not the one that served")
    if recall < RECALL_TARGET:
        raise AssertionError(f"mesh recall@{K} {recall} < {RECALL_TARGET}")

    # (c) churn that skips the last shard (so three shards restack), then
    # deletes
    crng = np.random.default_rng(seed + 11)
    n_upd = CHURN // UPDATE_SHARE
    n_new = CHURN - n_upd
    j = np.arange(n_new)
    new_ids = n + s_n * (j // (s_n - 1)) + j % (s_n - 1)
    upd_ids = crng.choice(np.nonzero(np.arange(n) % s_n != s_n - 1)[0],
                          n_upd, replace=False)
    rows = np.zeros((int(new_ids.max()) + 1, DIM), np.float32)
    rows[:n] = vectors
    rows[new_ids] = more_rows(crng, basis, n_new)
    rows[upd_ids] = more_rows(crng, basis, n_upd)
    live = np.zeros(rows.shape[0], bool)
    live[:n] = live[new_ids] = True
    t0 = time.monotonic()
    idx.add_batch(np.concatenate([new_ids, upd_ids]),
                  np.concatenate([rows[new_ids], rows[upd_ids]]))
    idx.flush()
    flush_s = time.monotonic() - t0
    doomed = crng.choice(np.nonzero(live)[0], CHURN_DELETES, replace=False)
    idx.delete(doomed)
    live[doomed] = False
    rows_dev = torch.as_tensor(rows, device="cuda")
    truth = live_truth(queries, rows, np.nonzero(live)[0], K)
    s0 = idx.stats()
    adc_scan.launches = decode_scan.launches = 0
    mem_ids, mem_scores, wall = search_all(idx, queries, deep)
    launches["sharded_churn"] = kernel_counts(adc_scan, decode_scan)
    s1 = idx.stats()
    n_restack, n_partial, restack_ms = _stat_deltas(s0, s1, *restack)
    recall = check_live_answers("mesh after the churn", mem_ids, mem_scores,
                                queries, rows_dev, doomed, truth, K)
    g = idx._mesh_state.n_segments
    log(f"  (c) churn: flush of {n_new} new docs + {n_upd} updates (shard "
        f"{s_n - 1} gets none) {flush_s:.2f} s, {CHURN_DELETES} deletes; G "
        f"{g}; restacks {n_restack}, partial {n_partial}, restack "
        f"{restack_ms / s_n / 1000:.3f} s; ef_search {BEAM_EF}: "
        f"{1000 * wall / nq:.5f} ms/query batched, recall@{K} {recall:.4f} "
        f"over the live rows, no deleted id, every score the newest "
        f"vector's; launches {launches['sharded_churn']}")
    if g != 2 or n_partial != s_n or n_restack != s_n:
        raise AssertionError("the churn did not restack three shards alone")
    idx.close()
    del idx

    # (d) over REST: the service attaches the directory with the mesh
    svc = KnnService(svc_dir.name, device="cuda", mesh=mesh)
    svc.start()
    rest = Rest(svc.port)
    try:
        put = rest("PUT", "/shardy", {
            "settings": {"index": {"number_of_shards": s_n}},
            "mappings": {"properties": {"vec": {"type": "knn_vector",
                                                "dimension": DIM}}}})
        count = rest("GET", "/shardy/_count")["count"]
        stats0 = rest("GET", "/_plugins/_knn/stats")["nodes"]["local"]
        adc_scan.launches = decode_scan.launches = 0
        ids, scores = [], []
        t0 = time.monotonic()
        for s in range(0, nq, BATCH):
            body = {"size": K, "query": {"knn": {"vec": {
                "vector": queries[s: s + BATCH].tolist(), "k": K,
                "method_parameters": {"ef_search": BEAM_EF}}}}}
            for r in rest("POST", "/shardy/_search", body)["responses"]:
                i_, s_ = hit_arrays(r["hits"]["hits"])
                ids.append(i_)
                scores.append(s_)
        wall = time.monotonic() - t0
        ids, scores = np.stack(ids), np.stack(scores)
        same = bool((ids == mem_ids).all())
        gap = float(np.abs(scores - mem_scores).max())
        q = queries[1]
        out = rest("POST", "/shardy/_search", {"size": K, "query": {
            "script_score": {"script": {
                "source": "knn_score", "lang": "knn", "params": {
                    "field": "vec", "space_type": "l2",
                    "query_value": q.tolist()}}}}})
        got, _ = hit_arrays(out["hits"]["hits"])
        live_ids = np.nonzero(live)[0]
        d2 = ((rows[live_ids].astype(np.float64) - q) ** 2).sum(-1)
        want = live_ids[np.argsort(d2, kind="stable")[:K]]
        d2_of = dict(zip(live_ids.tolist(), d2.tolist()))
        tied = np.isclose([d2_of.get(int(d), np.inf) for d in got],
                          [d2_of[int(d)] for d in want], rtol=1e-6)
        script_ok = bool((got == want).all() or tied.all())
        launches["sharded_rest"] = kernel_counts(adc_scan, decode_scan)
        stats1 = rest("GET", "/_plugins/_knn/stats")["nodes"]["local"]
        deltas = [stats1[c] - stats0[c] for c in (
            "knn_query_count", "script_query_requests",
            "knn_mesh_restack_count")]
        expect = [nq * s_n, 1, s_n]
        log(f"  (d) REST: PUT /shardy attached {put['shards']} shards, "
            f"_count {count}; batched bodies of {BATCH} at ef_search "
            f"{BEAM_EF}: {1000 * wall / nq:.4f} ms/query, ids equal to (c)'s "
            f"in-process answers: {same}, largest score gap {gap:.3e}; "
            f"knn_score l2 script equal to numpy's exact top-{K} up to ties: "
            f"{script_ok}; stats deltas (query count, script requests, "
            f"restacks) {deltas}, expected {expect}; launches "
            f"{launches['sharded_rest']}")
        if (count != int(live.sum()) or not same or gap > 1e-6
                or not script_ok or deltas != expect):
            raise AssertionError("the sharded REST index answered otherwise")
    finally:
        rest.close()
        svc.stop()
        svc.manager.close()
    del rows_dev
    svc_dir.cleanup()
    serving_peak = torch.cuda.max_memory_allocated()

    # (e) on_disk shards: approx-only on the mesh, paged rerank
    n_v = vv.shape[0]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shardy_disk_") as d:
        didx = ShardedVectorIndex(d, DiskAnnConfig(dim=DIM, mode="on_disk"),
                                  n_shards=s_n, device="cuda", mesh=mesh)
        t0 = time.monotonic()
        didx.add_batch(np.arange(n_v), vv)
        didx.flush()
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        vtruth = live_truth(vq, vv, np.arange(n_v), K)
        didx.search(vq[:BATCH], sc)  # warm: loads, restack
        adc_scan.launches = decode_scan.launches = 0
        s0 = didx.stats()
        t0 = time.monotonic()
        ids, scores, held = search_held("on_disk shards on the mesh", didx,
                                        vq, vtruth, sc, deep)
        wall = time.monotonic() - t0
        launches["sharded_on_disk"] = kernel_counts(adc_scan, decode_scan)
        s1 = didx.stats()
        check_exact_scores("on_disk mesh", ids, scores, vq,
                           torch.as_tensor(vv, device="cuda"))
        recall = recall_at_k(ids, vtruth, K)
        approx = didx._mesh_state is not None and didx._mesh_state.approx_only
        reranked = s1["knn_query_reranked_count"] - s0["knn_query_reranked_count"]
        log(f"  (e) on_disk: {n_v} x {DIM} in {s_n} shards, flush {dt:.2f} s "
            f"= {n_v / dt:.0f} vec/s; approx-only mesh path {approx}, paged "
            f"rerank of {reranked} rows over both passes ({wall:.2f} s); held "
            f"at ef_search {held.resolved_ef()}: recall@{K} {recall:.4f}, "
            f"every score the exact fp32 one, rejects "
            f"{sum(_stat_deltas(s0, s1, *rejects))}")
        didx.close()
        if not approx or recall < RECALL_TARGET or reranked <= 0:
            raise AssertionError("the on_disk mesh path failed")

    # (f) the dry run over the same mesh
    t0 = time.monotonic()
    dryrun(mesh)
    log(f"  (f) dryrun(make_mesh(['cuda:0'] * {s_n})): ok in "
        f"{time.monotonic() - t0:.2f} s")
    log(f"  phase 11: {time.monotonic() - t_phase:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated()} B (through (d): "
        f"{serving_peak} B)")


def phase_12(seed: int, smi: str, launches: dict) -> None:
    """The quantized build at capacity 2^22: see the module docstring."""
    from opensearch_jvector_tpu_torch.api.config import (
        DiskAnnConfig,
        SearchConfig,
    )
    from opensearch_jvector_tpu_torch.api.settings import GLOBAL_SETTINGS
    from opensearch_jvector_tpu_torch.api.stats import Counter
    from opensearch_jvector_tpu_torch.index.index import VectorIndex
    from opensearch_jvector_tpu_torch.index.scheduler import (
        ForceMergesOnlyMergePolicy,
    )
    from opensearch_jvector_tpu_torch.models import builder as builder_mod
    from opensearch_jvector_tpu_torch.ops.adc_kernel import adc_scan
    from opensearch_jvector_tpu_torch.ops.pq_scan_kernel import decode_scan
    from opensearch_jvector_tpu_torch.utils.circuit_breaker import BREAKER
    from opensearch_jvector_tpu_torch.utils.ground_truth import recall_at_k

    n, n_scan, nq = QB_N, QB_SCAN_N, VAMANA_QUERIES
    cfg = DiskAnnConfig(dim=DIM, mode="on_disk", m=32, num_pq_subspaces=64)
    rng = np.random.default_rng(seed + 12)
    t0 = time.monotonic()
    rows, queries, _ = make_data(rng, n + n_scan, nq, DIM)
    log(f"[12/13] quantized build: {n} x {DIM} rows (capacity 2^22) in one "
        f"on_disk flush from rows on the card (flush(device_rows=...)), "
        f"m={cfg.m}, PQ{cfg.num_pq_subspaces}, build_batch_size "
        f"{QB_BATCH}; then {n_scan} rows (scan tier); {nq} queries, k={K} "
        f"(data made in {time.monotonic() - t0:.1f} s); {smi}")
    gc.collect()
    torch.cuda.empty_cache()
    dir_ = tempfile.TemporaryDirectory(prefix="chip_smoke_qbuild_")
    idx = VectorIndex(dir_.name, cfg, device="cuda",
                      merge_policy=ForceMergesOnlyMergePolicy())
    idx.writer.build_batch_size = QB_BATCH
    rows_dev = torch.as_tensor(rows[:n], device="cuda")
    sources, calls = [], []
    real_build = builder_mod.GraphIndexBuilder.build

    def spy_build(self, vectors, *a, **kw):
        sources.append(vectors.dtype)
        return real_build(self, vectors, *a, **kw)

    def provider(lo, hi):
        calls.append((lo, hi))
        return rows_dev[lo:hi]

    builder_mod.GraphIndexBuilder.build = spy_build
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = idx.stats.snapshot()
        t0 = time.monotonic()
        idx.add_batch(np.arange(n), rows[:n])
        name = idx.flush(device_rows=provider)
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
    finally:
        builder_mod.GraphIndexBuilder.build = real_build
    peak = torch.cuda.max_memory_allocated() - base
    after = idx.stats.snapshot()
    pq_ms, build_ms = _stat_deltas(
        before, after, Counter.KNN_QUANTIZATION_TRAINING_TIME.value,
        Counter.KNN_GRAPH_BUILD_TIME.value)
    seg = idx._reader(name).seg
    cap, entry = seg.capacity(), seg.graph.entry
    entry_ok = entry < n and bool(seg.graph.live[entry])
    resident = (cap * DIM * 2 + cap * int(cfg.m * cfg.neighbor_overflow) * 4
                + cap * cfg.num_pq_subspaces)
    log(f"  flush {name}: {dt:.2f} s = {n / dt:.0f} vec/s (PQ train + encode "
        f"from {len(calls)} provider blocks {pq_ms} ms = "
        f"{1000 * n / max(pq_ms, 1):.0f} vec/s; graph build from the bf16 "
        f"decoded rows {build_ms} ms = {1000 * n / max(build_ms, 1):.0f} "
        f"vec/s; row file, CRC and containers {1000 * dt - pq_ms - build_ms:.0f}"
        f" ms); build source {sources}; capacity {cap}; entry {entry} (live, "
        f"used: {entry_ok}); peak device memory over the rows on the card "
        f"{peak} B against decoded bf16 + adjacency + codes at the capacity "
        f"{resident} B; {smi}")
    if (sources != [torch.bfloat16] or not entry_ok
            or cap < idx.writer.quantized_build_min_capacity):
        raise AssertionError("the flush did not take the quantized build")
    del rows_dev, seg
    name2, dt2, _, _ = flush_rows(idx, rows, n, n_scan)
    log(f"  flush {name2}: {n_scan} rows in {dt2:.2f} s (scan tier)")
    idx.close()
    del idx
    gc.collect()
    torch.cuda.empty_cache()
    truth = live_truth(queries, rows, np.arange(n + n_scan), K)
    deep = SearchConfig(k=K, ef_search=BEAM_EF)
    first = None
    for rung in ("default", "tight"):
        ridx = VectorIndex(dir_.name, device="cuda")
        for n_ in ridx.segment_names:
            ridx._reader(n_)  # load before the breaker tightens
        if rung == "tight":
            tight_breaker_limit(GLOBAL_SETTINGS, BREAKER)
        adc_scan.launches = decode_scan.launches = 0
        try:
            ids, _, held = search_held(f"the 2^22 segment + the scan segment, "
                                       f"{rung} breaker", ridx, queries, truth,
                                       SearchConfig(k=K), deep)
        finally:
            GLOBAL_SETTINGS.put("knn.memory.circuit_breaker.limit", 50.0)
        launches[f"quantized_build_{rung}"] = kernel_counts(adc_scan,
                                                            decode_scan)
        cached = [ridx._reader(n_)._pq_decoded is not None
                  for n_ in ridx.segment_names]
        log(f"  {rung} breaker: decoded cache per segment {cached}, launches "
            f"{launches[f'quantized_build_{rung}']}")
        if cached != [rung == "default"] * len(cached):
            raise AssertionError(f"{rung} breaker: decoded cache {cached}")
        if rung == "tight" and launches["quantized_build_tight"][
                "decode_scan"] <= 0:
            raise AssertionError("the tight scan tier never launched "
                                 "decode_scan")
        first = (ids, held) if first is None else first
        ridx.close()
    again = VectorIndex(dir_.name, device="cuda")
    same = bool((search_all(again, queries[:BATCH], first[1])[0]
                 == first[0][:BATCH]).all())
    again.close()
    log(f"  reopen: identical top-{K} ids for {BATCH} queries: {same}")
    if not same:
        raise AssertionError("the reopened quantized-build index differs")
    dir_.cleanup()
    del rows
    gc.collect()
    torch.cuda.empty_cache()


def ramp_rounds(n: int, batch: int, max_degree: int) -> int:
    """Insert rounds of a build of n rows: after a bootstrap block of
    min(n, max(max_degree + 1, min(1024, batch))) rows, each round as wide
    as the graph so far (at least 64, at most batch)."""
    pos = min(n, max(max_degree + 1, min(1024, batch)))
    rounds = 0
    while pos < n:
        pos += min(batch, max(pos, 64))
        rounds += 1
    return rounds


def phase_13(rows: np.ndarray, queries: np.ndarray, basis, seed: int,
             smi: str) -> None:
    """The graph build profile: see the module docstring."""
    from opensearch_jvector_tpu_torch.models import builder as builder_mod
    from opensearch_jvector_tpu_torch.models import searcher as searcher_mod
    from opensearch_jvector_tpu_torch.models.graph import bucket_capacity
    from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction
    from opensearch_jvector_tpu_torch.utils.ground_truth import (
        ground_truth_topk,
        ground_truth_topk_stream,
        recall_at_k,
    )

    t_phase = time.monotonic()
    n, n_all = PROF_N, PROF_N + PROF_ADD
    if rows.shape[0] < n_all:  # a run with --n below n_all
        rows = np.concatenate([rows, more_rows(
            np.random.default_rng(seed + 13), basis, n_all - rows.shape[0])])
    simf = SimilarityFunction.EUCLIDEAN
    log(f"[13/13] graph build profile: GraphIndexBuilder(dim={DIM}, "
        f"max_degree={PROF_DEGREE}, beam_width={PROF_BEAM}) over {n} of "
        f"phase 4's rows on the card, unprofiled and profiled, then "
        f"add_nodes of {PROF_ADD} more, profiled; recall@{K} on "
        f"{queries.shape[0]} queries at ef_search 100; {smi}")
    x = torch.as_tensor(rows, device="cuda")
    q = torch.as_tensor(queries, device="cuda")
    t0 = time.monotonic()

    def blocks(m):
        for lo in range(0, m, PROF_BLOCK):
            yield lo, rows[lo: min(lo + PROF_BLOCK, m)]

    truth = {m: ground_truth_topk_stream(q, blocks(m), K, simf)
             for m in (n, n_all)}
    agree = recall_at_k(ground_truth_topk(q, x[:n], K, simf), truth[n], K)
    log(f"  ground truth streamed in {PROF_BLOCK}-row blocks over {n} and "
        f"{n_all} rows: {time.monotonic() - t0:.2f} s; agreement with "
        f"ground_truth_topk over the {n} rows on the card {agree:.6f}")
    if agree < 0.999:
        raise AssertionError(f"the streamed ground truth disagrees: {agree}")
    params = searcher_mod.SearchParams(k=K, ef_search=100)

    def recall(graph):
        res = searcher_mod.search(graph.adjacency, graph.live, graph.entry,
                                  q, params, simf, vectors=x)
        return recall_at_k(res.ids.cpu().numpy(), truth[graph.size()], K)

    def report(what, b, wall, given, want_rounds):
        c = b.counters
        total = sum(c.phase_s.values())
        log(f"  {what}: wall {wall:.3f} s = {given / wall:.0f} vec/s, "
            f"rounds {c.rounds} (ramp {want_rounds}), nodes_inserted "
            f"{c.nodes_inserted}")
        if c.phase_s:
            log("    " + "; ".join(
                f"{k} {v:.3f} s ({100 * v / wall:.1f} %)"
                for k, v in sorted(c.phase_s.items(), key=lambda kv: -kv[1])))
            log(f"    sum of phases {total:.3f} s = {total / wall:.3f} of "
                f"the wall")
        if c.nodes_inserted != given or c.rounds != want_rounds:
            raise AssertionError(f"{what}: counters {c} against {given} "
                                 f"rows and {want_rounds} rounds")
        if c.phase_s and not 0.85 <= total / wall <= 1.0:
            raise AssertionError(f"{what}: phases sum to {total / wall:.3f} "
                                 f"of the wall")

    cap = bucket_capacity(n_all)
    graphs, walls = {}, {}
    try:
        for profile in (False, True):
            builder_mod.BUILD_PROFILE = profile
            b = builder_mod.GraphIndexBuilder(
                dim=DIM, max_degree=PROF_DEGREE, beam_width=PROF_BEAM)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            graphs[profile] = b.build(x[:n], simf, capacity=cap)
            torch.cuda.synchronize()
            walls[profile] = time.monotonic() - t0
            report(f"build of {n} rows, profile {'on' if profile else 'off'}",
                   b, walls[profile], n,
                   ramp_rounds(n, b.batch_size, PROF_DEGREE))
        b = builder_mod.GraphIndexBuilder(
            dim=DIM, max_degree=PROF_DEGREE, beam_width=PROF_BEAM)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        merged = b.add_nodes(graphs[True], x, np.arange(n, n_all), simf)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        report(f"add_nodes of {PROF_ADD} rows, profile on", b, wall,
               PROF_ADD, -(-PROF_ADD // b.batch_size))
    finally:
        builder_mod.BUILD_PROFILE = False
    log(f"  the profile's cost: unprofiled wall {walls[False]:.3f} s, "
        f"profiled {walls[True]:.3f} s "
        f"({walls[True] / walls[False]:.3f}x); identical adjacency "
        f"{bool(torch.equal(graphs[False].adjacency, graphs[True].adjacency))}")
    r_off, r_on, r_all = (recall(g) for g in (graphs[False], graphs[True],
                                              merged))
    log(f"  recall@{K} at ef_search 100: {n} rows unprofiled {r_off:.4f}, "
        f"profiled {r_on:.4f}; {n_all} nodes after add_nodes {r_all:.4f}")
    if abs(r_on - r_off) > 0.01:
        raise AssertionError(f"the profiled build's recall {r_on} is not "
                             f"within 0.01 of {r_off}")
    if r_all < RECALL_TARGET:
        raise AssertionError(f"recall@{K} after add_nodes {r_all} < "
                             f"{RECALL_TARGET}")
    del x, graphs, merged
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 13: {time.monotonic() - t_phase:.1f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--compare-decode-scan", type=Path, default=None,
                    metavar="OTHER.cu",
                    help="time another decode_scan.cu beside this one")
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
    log(f"[1/13] device: {kind} (torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)

    # ---- 2. build ----------------------------------------------------------
    t0 = time.monotonic()
    names = ("adc_scan", "decode_scan", "vector_store")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(_kernels.build, names)))
    log(f"[2/13] build: {', '.join(p.name for p in libs.values())} in "
        f"{time.monotonic() - t0:.1f} s (compilers started together)")
    for name in names:
        if name not in _kernels.BUILD_LOGS:
            log(f"  {name}: built before this run, no compiler report")
        for line in _kernels.ptxas_summary(_kernels.BUILD_LOGS.get(name, "")):
            log(f"  ptxas {name}: {line}")
    line, hgmma = mma_counts(libs["decode_scan"])
    log(f"  sass: {line}")
    if hgmma == 0:
        raise AssertionError("decode_scan_kernel's SASS holds no HGMMA: its "
                             "products do not run on wgmma")

    # ---- 3. kernels vs plain ----------------------------------------------
    log("[3/13] kernels vs plain PyTorch on the card")
    m = default_num_subspaces(DIM)  # the subspaces the flushes train
    adc_rec = check_adc_scan(BATCH, m, 256, 1 << 18, args.seed, reps=20,
                             plain_reps=3, library=True, fused=True)
    check_adc_scan(3, 8, 64, 1000, args.seed + 1, reps=20, plain_reps=20)
    # the on_disk phases' shapes: the Q=1 codes_sq table over phase 6's
    # 2^20 codes and phase 7's 2^18 (also a serial request of phase 10),
    # the LUT rung's batch in phase 6, and a coalesced dispatch of phase 10
    serving_recs = {}
    for i, (q, m_, n) in enumerate([(1, GIST_M, 1 << 20), (1, m, 1 << 18),
                                    (LUT_BATCH, GIST_M, 1 << 20),
                                    (32, m, 1 << 18)]):
        rec = check_adc_scan(q, m_, 256, n, args.seed + 10 + i, reps=5,
                             plain_reps=2)
        if (m_, n) == (m, 1 << 18):
            serving_recs[q] = rec
    log("  adc_scan at the serving shapes over 2^18 x "
        f"{m} codes: " + "; ".join(
            f"Q={q}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms)" for q, r in serving_recs.items()))
    dsub = GIST_DIM // GIST_M
    dec_rec = check_decode_scan(BATCH, 1 << 20, GIST_M, 256, dsub,
                                args.seed + 2, reps=5, plain_reps=2,
                                library=True)
    # the routing gate's lowest batch (FUSED_DECODE_MIN_QUERIES)
    gate_rec = check_decode_scan(256, 1 << 20, GIST_M, 256, dsub,
                                 args.seed + 7, reps=5, plain_reps=2,
                                 library=True)
    log(f"  decode_scan at the GIST cell: Q={BATCH} {dec_rec['ms']:.4f} ms "
        f"(bound {dec_rec['bound_ms']:.4f}, library "
        f"{dec_rec['library_ms']:.4f}), Q=256 {gate_rec['ms']:.4f} ms "
        f"(bound {gate_rec['bound_ms']:.4f}, library "
        f"{gate_rec['library_ms']:.4f})")
    for i, shape in enumerate([(3, 1000, 8, 64, 21), (1, 777, GIST_M, 256,
                                                      dsub),
                               (BATCH, 1 << 18, m, 256, DIM // m)]):
        check_decode_scan(*shape, args.seed + 3 + i, reps=5, plain_reps=2)
    if args.compare_decode_scan is not None:
        compare_decode_scan(args.compare_decode_scan,
                            [(BATCH, 1 << 20, GIST_M, 256, dsub),
                             (256, 1 << 20, GIST_M, 256, dsub)],
                            args.seed + 8)
    torch.cuda.empty_cache()

    # ---- 4. in_memory path ---------------------------------------------------
    rng = np.random.default_rng(args.seed)
    vectors, queries, basis = make_data(rng, args.n, args.queries, DIM)
    sc = SearchConfig(k=K)
    log(f"[4/13] in_memory path: {args.n} x {DIM} in {FLUSHES} flushes, "
        f"{args.queries} queries in batches of {BATCH}, k={K}")
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    # phases 10 and 8a come back to this directory (the service's root,
    # with the index as field "vec" of /sift), and 8a removes it
    mem_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    sift_dir = os.path.join(mem_dir.name, "sift", "vec")
    root = sift_dir
    index = VectorIndex(root, DiskAnnConfig(dim=DIM), device="cuda")
    bounds = np.linspace(0, args.n, FLUSHES + 1).astype(int)
    plain_pq_ms = None
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
            f"graph build {build_ms} ms; PERF.md records ~"
            f"{EARLIER_FLUSH_VEC_S} vec/s)")
        plain_pq_ms = pq_ms if plain_pq_ms is None else plain_pq_ms

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
    mem_ids, mem_scores, mem_gt = ids, scores, gt

    # ---- 5. reopen -------------------------------------------------------
    index.close()
    reopened = VectorIndex(root, device="cuda")
    again = reopened.search(queries[: BATCH], sc).doc_ids
    same = bool((again == ids[: BATCH]).all())
    log(f"[5/13] reopen from commits.json: {len(reopened.segment_names)} "
        f"segments, identical top-{K} ids for {BATCH} "
        f"queries: {same}")
    if not same:
        raise AssertionError("reopened index returned other ids")
    reopened.close()
    del index, reopened
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 10. serving over REST on phase 4's directory --------------------
    phase_10(mem_dir.name, vectors, queries, mem_ids, mem_scores, mem_gt,
             basis, args.seed, smi, launches)
    del mem_ids, mem_scores, mem_gt

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
        log(f"[6/13] on_disk flat GIST1M-shaped: {GIST_N} x {GIST_DIM}, "
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
    phase_6b(GIST_PARITY_Q)

    # ---- 7. on_disk vamana ----------------------------------------------------
    vrng = np.random.default_rng(args.seed + 7)
    n_v = sum(VAMANA_FLUSHES)
    vv, vq, _ = make_data(vrng, n_v, VAMANA_QUERIES, DIM)
    log(f"[7/13] on_disk vamana: {n_v} x {DIM} in flushes of "
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
    log(f"[8a/13] in_memory deletes and merges on phase 4's index directory: "
        f"delete {n_del}, then add {n_new} new docs and {n_upd} updates")
    # the default merge policy: tiered, at most 4 segments, 4 a merge
    index = VectorIndex(sift_dir, device="cuda")
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
    again = VectorIndex(sift_dir, device="cuda")
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
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 8b. on_disk deletes and a merge ----------------------------------
    doomed = np.random.default_rng(args.seed + 9).choice(
        n_v, n_v // DELETE_SHARE, replace=False)
    keep = np.setdiff1d(np.arange(n_v), doomed)
    log(f"[8b/13] on_disk vamana deletes and force_merge: delete "
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
    del truth

    # ---- 11. sharded search on phase 4's and phase 7's corpora -----------
    phase_11(vectors, queries, basis, vv, vq, args.seed, smi, launches)
    # phase 13 builds over phase 4's first rows and queries, after the
    # corpus has gone
    prof_rows = np.array(vectors[:PROF_N + PROF_ADD])
    prof_queries = np.array(queries[:PROF_Q])
    del vectors, queries, vv, vq
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 12. the quantized build at capacity 2^22 ---------------------------
    phase_12(args.seed, smi, launches)

    # ---- 9. the other quantizers, anisotropic PQ, the hierarchy layer ----
    phase_9a(args.seed, args.queries, launches)
    phase_9b(args.seed, launches)
    phase_9c(args.seed, launches, plain_pq_ms)

    # ---- 13. the graph build profile ---------------------------------------
    phase_13(prof_rows, prof_queries, basis, args.seed, smi)
    del prof_rows, prof_queries

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
