"""Batched alpha-robust prune: the wrapper of the CUDA kernel
`csrc/robust_prune.cu`.

Port of `opensearch_jvector_tpu/models/builder.py:robust_prune_batch`, a
`lax.fori_loop` that XLA compiles into one device program.
`robust_prune(rows, cand_ids, cand_scores, alpha, m_out, simf, point_ids)`
selects, for each row b of the batch, up to `m_out` of its candidates
`cand_ids[b]` (-1 pad; the candidates' vectors are `rows[cand_ids]`, their
similarity to the point `cand_scores[b]`) by the DiskANN rule: take the
closest unpruned candidate c*, prune every c with alpha * d(c*, c) < d(p, c)
(strict, so duplicate vectors stay selectable), repeat. Only the first
occurrence of an id counts, the point itself never, and argmin ties go to
the lowest column. Returns [B, m_out] int64 (-1 pad):

  * on CUDA tensors it launches the hand-written kernel on the current
    stream: one block a row b reads its candidates' rows by id from `rows`
    (float32, or bf16 upcast in the kernel), so neither the [B, C, d]
    gather nor the [B, C, C] distance tensor reaches device memory. A
    block keeps c*'s row and 13 bytes a candidate in shared memory
    (`prune_smem_bytes`); past a block's 227 KB the same kernel keeps them
    in a workspace in device memory, so every candidate width runs. It
    raises on any input the kernel does not take;
  * on CPU tensors it gathers the rows and runs the plain version,
    `robust_prune_reference`. That is the only case the plain version
    serves.

Tolerance against the plain version: d(p, c) comes from `cand_scores` by
the same float32 operations on both sides, so it is bit-equal; d(c*, c)
is summed in another float32 order. `dcc_error_bound` bounds that
difference from |c*| and |c|: 2^-21 * (sqrt(d) + 4) of (|c*| + |c|)^2 for
the two summations of d terms and the roundings (the kernel sums d / 8
terms a lane, then a tree of 8 lanes; PyTorch sums in blocks), carried
through `pairwise_scores` and `_score_to_dist`. Selections may differ
only through comparisons alpha * d(c*, c) < d(p, c) of the plain version
that lie within alpha times that bound of equality:
`selection_margins` measures, for another implementation's selections,
the comparisons they need taken the other way and how far each lies from
equality, against its bound.

`robust_prune.launches` counts kernel launches (one a call, or one per
WORKSPACE_BYTES of state for widths past a block's shared memory) and
nothing else, so a run can show that its build went through it;
`robust_prune.bf16_launches` counts those over bf16 rows.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from opensearch_jvector_tpu_torch.ops import _kernels
from opensearch_jvector_tpu_torch.ops.distances import (
    SimilarityFunction,
    pairwise_scores,
)

SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to
WORKSPACE_BYTES = 1 << 30  # the most device memory a launch's workspace takes


def _score_to_dist(scores: torch.Tensor,
                   simf: SimilarityFunction) -> torch.Tensor:
    """Map similarity scores to a pruning distance (lower = closer)."""
    if simf is SimilarityFunction.EUCLIDEAN:
        # score = 1/(1+d2)  ->  d2 = 1/score - 1; sqrt for a true metric
        return torch.sqrt(torch.clamp(
            1.0 / torch.clamp(scores, min=1e-30) - 1.0, min=0.0))
    return 1.0 - scores


def dcc_error_bound(cand_vecs: torch.Tensor, d_cc: torch.Tensor,
                    simf: SimilarityFunction) -> torch.Tensor:
    """[B, C, C] bound on |kernel d(c_i, c_j) - plain d(c_i, c_j)| for the
    plain distances `d_cc` of float32 `cand_vecs` [B, C, d]."""
    d = cand_vecs.shape[-1]
    n = torch.linalg.vector_norm(cand_vecs, dim=-1)
    g = 2.0**-21 * (d**0.5 + 4.0)  # both sums of d terms, the roundings
    if simf is SimilarityFunction.EUCLIDEAN:
        x = d_cc * d_cc
        e = g * (n[:, :, None] + n[:, None, :]) ** 2 + 2.0**-21 * (1.0 + x)
        return (e / (d_cc + torch.sqrt(torch.clamp(x - e, min=0.0)) + 1e-30)
                + 2.0**-23 * d_cc)
    if simf is SimilarityFunction.DOT_PRODUCT:
        return g * n[:, :, None] * n[:, None, :] / 2.0 + 2.0**-22
    return torch.full_like(d_cc, g / 2.0 + 2.0**-22)


def robust_prune_reference(
    point_vecs: torch.Tensor,  # [B, d] the nodes being pruned for
    cand_ids: torch.Tensor,  # [B, C] candidate ids (-1 pad)
    cand_vecs: torch.Tensor,  # [B, C, d]
    cand_scores: torch.Tensor,  # [B, C] similarity to point (-inf pad)
    alpha: float,
    m_out: int,
    simf: SimilarityFunction,
    point_ids: torch.Tensor | None = None,  # [B] to mask self-candidates
) -> torch.Tensor:
    """Vectorized alpha-robust-prune -> selected ids [B, m_out] (-1 pad).

    DiskANN rule: repeatedly take the closest unpruned candidate c*, then
    prune every c with alpha * d(c*, c) < d(p, c). The inequality is
    strict so that duplicate vectors (distance 0) stay selectable.
    """
    b, c = cand_ids.shape
    dev = cand_ids.device
    d_p = _score_to_dist(cand_scores.float(), simf)  # [B, C]
    cand_vecs = cand_vecs.float()
    d_cc = _score_to_dist(pairwise_scores(cand_vecs, cand_vecs, simf),
                          simf)  # [B, C, C]
    alive = _first_alive(cand_ids, point_ids)

    rows = torch.arange(b, device=dev)
    selected = torch.full((b, m_out), -1, dtype=torch.long, device=dev)
    inf = float("inf")
    for t in range(m_out):
        dp = torch.where(alive, d_p, inf)
        i = torch.argmin(dp, dim=1)
        ok = dp[rows, i] < inf
        selected[:, t] = torch.where(ok, cand_ids[rows, i].long(), -1)
        pruned = alpha * d_cc[rows, i] < d_p
        alive = alive & ~pruned & ok[:, None]
        alive[rows, i] = False
    return selected


def _first_alive(cand_ids: torch.Tensor,
                 point_ids: torch.Tensor | None) -> torch.Tensor:
    """[B, C] the candidates a prune starts from: the first occurrence of
    each id, never -1, never the point itself."""
    c = cand_ids.shape[1]
    eq = (cand_ids[:, :, None] == cand_ids[:, None, :]) & (
        cand_ids[:, :, None] >= 0)
    lower = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                  device=cand_ids.device), -1)
    alive = (cand_ids >= 0) & ~torch.any(eq & lower, dim=2)
    if point_ids is not None:
        alive &= cand_ids != point_ids[:, None]
    return alive


def selection_margins(rows: torch.Tensor, cand_ids: torch.Tensor,
                      cand_scores: torch.Tensor, alpha: float,
                      simf: SimilarityFunction,
                      point_ids: torch.Tensor | None,
                      selected: torch.Tensor, block: int = 2048):
    """How far `selected` [B, m_out] (another implementation's output of
    the prune, -1 pad) lies from a run of the rule on the plain version's
    distances. Returns float64 margin [B], share [B] and int64 pairs [B]:

      * margin: the largest |alpha * d(c*, c) - d(p, c)| over the pruning
        comparisons that `selected` needs taken the other way from the
        plain version (a selected c kept alive by an earlier c* that
        prunes it; an unselected c, which would have been picked before a
        later selection, left alive by every earlier c*). 0 where
        `selected` is a run of the plain comparisons; inf where no
        comparison can give it (out of order, an id that is not a first
        live candidate, a repeat);
      * share: the largest such gap over its bound, alpha times
        `dcc_error_bound` plus a rounding of the product; at most 1 means
        every differing decision lies within float32 error of equality;
      * pairs: the distances d(c*, c) to live candidates that the run of
        `selected` computes under the plain comparisons (the work of a
        kernel that computes only those).

    The plain distances are computed as `robust_prune_reference` computes
    them, from `rows[cand_ids]`, a block of rows of the batch at a time."""
    c = max(cand_ids.shape[1], 1)
    block = max(1, min(block, (1 << 26) // (c * c)))
    out = [_margins_block(rows, cand_ids[s: s + block],
                          cand_scores[s: s + block], alpha, simf,
                          None if point_ids is None
                          else point_ids[s: s + block],
                          selected[s: s + block])
           for s in range(0, cand_ids.shape[0], block)]
    return tuple(torch.cat(x) for x in zip(*out))


def _margins_block(rows, cand_ids, cand_scores, alpha, simf, point_ids,
                   selected):
    b, c = cand_ids.shape
    m = selected.shape[1]
    dev = cand_ids.device
    inf = float("inf")
    cand_vecs = rows[cand_ids.clamp(min=0)].float()
    d_p = _score_to_dist(cand_scores.float(), simf)
    d_cc = _score_to_dist(pairwise_scores(cand_vecs, cand_vecs, simf), simf)
    tol = alpha * dcc_error_bound(cand_vecs, d_cc, simf) + 2.0**-22 * (
        alpha * d_cc)
    alive0 = _first_alive(cand_ids, point_ids)
    sel = selected.long()
    has = sel >= 0
    k = has.sum(1)
    match = (cand_ids.long()[:, None, :] == sel[:, :, None]) & alive0[:, None]
    col = match.int().argmax(2)  # the selection's column [B, m]
    cols = torch.arange(c, device=dev)
    steps = torch.arange(m, device=dev)
    before = steps[None, :] < k[:, None]  # the run's steps [B, m]
    bad = ((has & ~match.any(2)) | (has != before)).any(1)
    bad |= ((col[:, :, None] == col[:, None, :]) & before[:, :, None]
            & before[:, None, :] & ~torch.eye(m, dtype=torch.bool,
                                              device=dev)).any((1, 2))

    # rows of the distances, bounds and d(p, .) at the selections
    def at(x):  # [B, C, C] -> [B, m, C]
        return torch.gather(x, 1, col[:, :, None].expand(b, m, c))

    lhs, tl = alpha * at(d_cc), at(tol)  # [B, s, C]
    dp_sel = torch.gather(d_p, 1, col)  # [B, m]
    # (d(p, .), column) order: c goes before the selection at step t
    first = ((d_p[:, None, :] < dp_sel[:, :, None])
             | ((d_p[:, None, :] == dp_sel[:, :, None])
                & (cols[None, None, :] < col[:, :, None])))  # [B, t, C]
    pos = torch.full((b, c + 1), m, device=dev)  # the step c is selected at
    pos.scatter_reduce_(1, torch.where(before, col, c),
                        torch.where(before, steps[None, :], m), "amin")
    pos = pos[:, :c]
    is_sel = pos < m
    # 1. no selection goes before an earlier one in the order ([s, t]: the
    # selection at t before the one at s), and each was kept alive by
    # every earlier c*
    first_sel = torch.gather(first, 2, col[:, None, :].expand(b, m, m))
    out_of_order = (first_sel & before[:, :, None]
                    & before[:, None, :]
                    & (steps[:, None] < steps[None, :])).any((1, 2))
    bad |= out_of_order
    lhs_sel = torch.gather(lhs, 2, col[:, None, :].expand(b, m, m))  # [s, t]
    tl_sel = torch.gather(tl, 2, col[:, None, :].expand(b, m, m))
    need1 = (before[:, :, None] & before[:, None, :]
             & (steps[:, None] < steps[None, :]))  # s < t
    gap1 = torch.where(need1, torch.clamp(dp_sel[:, None, :] - lhs_sel,
                                          min=0.0), 0.0)
    share1 = torch.where(need1, gap1 / tl_sel, 0.0)
    # 2. an unselected live c: pruned by some c* before the step that
    # would have picked it (every step, where the run ends short of m)
    t_pick = torch.where(first & before[:, :, None], steps[None, :, None],
                         m).amin(1)  # [B, C]
    t_need = torch.where(t_pick == m, k[:, None], t_pick)
    constrained = alive0 & ~is_sel & ((t_pick < m) | (k < m)[:, None])
    may = steps[None, :, None] < t_need[:, None, :]  # [B, s, C]
    gap_s = torch.where(may & before[:, :, None],
                        torch.clamp(lhs - d_p[:, None, :], min=0.0), inf)
    share_s = torch.where(may & before[:, :, None], gap_s / tl, inf)
    gap2 = torch.where(constrained, gap_s.amin(1), 0.0)
    share2 = torch.where(constrained, share_s.amin(1), 0.0)
    margin = torch.maximum(gap1.amax((1, 2)), gap2.amax(1)).double()
    share = torch.maximum(share1.amax((1, 2)), share2.amax(1)).double()
    margin[bad] = inf
    share[bad] = inf
    # the distances the run computes: at step t, to each live candidate
    # not yet pruned by the plain comparisons and not selected by then
    pruned_at = torch.where((lhs < d_p[:, None, :]) & before[:, :, None],
                            steps[None, :, None], m).amin(1)  # [B, C]
    live_at = (alive0[:, None, :] & (pos[:, None, :] > steps[None, :, None])
               & (pruned_at[:, None, :] >= steps[None, :, None]))
    pairs = (live_at & before[:, :, None]).sum((1, 2))
    return margin, share, pairs


def _align16(x: int) -> int:
    return (x + 15) & ~15


def prune_smem_bytes(c: int, d: int) -> int:
    """One block's state (`prune_smem_bytes` in the source): c*'s row (d
    floats), a candidate column each of id, d(p, c) and norm term (4 bytes)
    and live flag (1 byte), and the reduction scratch."""
    return _align16(4 * d) + 3 * _align16(4 * c) + _align16(c) + _align16(
        8 * 8 + 16)


def _bind() -> ctypes.CDLL:
    """Build (once) and load the kernel, declaring its C signature."""
    lib = _kernels.load("robust_prune")
    fn = lib.robust_prune_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        lib.prune_smem_bytes_c.argtypes = [ctypes.c_int] * 2
        lib.prune_smem_bytes_c.restype = ctypes.c_longlong
    return lib


_SIMF_CODE = {SimilarityFunction.EUCLIDEAN: 0,
              SimilarityFunction.DOT_PRODUCT: 1,
              SimilarityFunction.COSINE: 2}


def robust_prune(rows: torch.Tensor, cand_ids: torch.Tensor,
                 cand_scores: torch.Tensor, alpha: float, m_out: int,
                 simf: SimilarityFunction,
                 point_ids: torch.Tensor | None = None) -> torch.Tensor:
    """Alpha-robust prune of every row's candidates, their vectors read as
    `rows[cand_ids]` -> selected ids [B, m_out] int64 (-1 pad)."""
    if cand_ids.device.type == "cpu":
        cand_vecs = rows[cand_ids.clamp(min=0)].float()
        return robust_prune_reference(None, cand_ids, cand_vecs,
                                      cand_scores, alpha, m_out, simf,
                                      point_ids=point_ids)
    dev = cand_ids.device
    tensors = [rows, cand_ids, cand_scores] + (
        [] if point_ids is None else [point_ids])
    if not cand_ids.is_cuda or {t.device for t in tensors} != {dev}:
        raise ValueError(
            f"robust_prune: inputs on {[str(t.device) for t in tensors]}; "
            "all must be on one CUDA device (or all on the CPU)")
    if rows.dtype not in (torch.float32, torch.bfloat16) or rows.dim() != 2:
        raise ValueError(f"robust_prune: rows must be [N, d] float32 or "
                         f"bfloat16, got {tuple(rows.shape)} {rows.dtype}")
    if cand_ids.dim() != 2 or cand_scores.shape != cand_ids.shape:
        raise ValueError(f"robust_prune: cand_ids {tuple(cand_ids.shape)} and "
                         f"cand_scores {tuple(cand_scores.shape)} must be "
                         "[B, C] alike")
    b, c = cand_ids.shape
    n, d = rows.shape
    if not (0 <= m_out and 1 <= d and c < 2**28 and n < 2**31
            and b < 2**31):
        raise ValueError(f"robust_prune: shape B={b} C={c} N={n} d={d} "
                         f"m_out={m_out} out of range")
    if point_ids is not None and point_ids.shape != (b,):
        raise ValueError(f"robust_prune: point_ids {tuple(point_ids.shape)} "
                         f"for {b} rows")
    if not rows.is_contiguous():
        raise ValueError("robust_prune: rows must be contiguous")
    ids = cand_ids.to(torch.long).contiguous()
    scores = cand_scores.to(torch.float32).contiguous()
    pids = (None if point_ids is None
            else point_ids.to(torch.long).contiguous())
    out = torch.empty((b, m_out), dtype=torch.long, device=dev)
    if b == 0 or m_out == 0:
        return out
    if c == 0:
        return out.fill_(-1)
    vec = int(rows.data_ptr() % 16 == 0 and (d * rows.element_size()) % 16
              == 0)
    need = prune_smem_bytes(c, d)
    # past a block's shared memory, the state goes to a workspace in device
    # memory, in launches of at most WORKSPACE_BYTES of it
    step = b if need <= SMEM_LIMIT else max(1, WORKSPACE_BYTES // need)
    ws = (None if need <= SMEM_LIMIT else
          torch.empty(min(step, b) * need, dtype=torch.uint8, device=dev))
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = rows.dtype == torch.bfloat16
    for lo in range(0, b, step):
        hi = min(lo + step, b)
        with torch.cuda.device(dev):
            err = lib.robust_prune_launch(
                rows.data_ptr(), int(bf16), d, vec, ids[lo].data_ptr(),
                scores[lo].data_ptr(),
                None if pids is None else pids[lo:].data_ptr(), hi - lo, c,
                float(alpha), m_out, _SIMF_CODE[simf],
                None if ws is None else ws.data_ptr(), out[lo].data_ptr(),
                stream)
        if err != 0:
            raise RuntimeError(f"robust_prune: kernel launch failed, "
                               f"cudaError {err}")
        with _COUNT_LOCK:  # merges prune from the merge pool's thread
            robust_prune.launches += 1
            robust_prune.bf16_launches += bf16
    return out


robust_prune.launches = 0  # every launch
robust_prune.bf16_launches = 0  # those over bf16 rows (the quantized build)
_COUNT_LOCK = threading.Lock()
