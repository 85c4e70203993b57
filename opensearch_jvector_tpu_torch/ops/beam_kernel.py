"""The batched beam walk: the wrapper of the CUDA kernel `csrc/beam_search.cu`.

Port of the `jax.lax.while_loop` of `opensearch_jvector_tpu/models/
searcher.py:beam_search`, which XLA compiles into one device program.
`beam_search(adjacency, entry, provider, q, L, E, max_iters)` walks the
graph for a batch of queries and returns the final candidate pool (ids
[Q, L] int64 with -1 pad, scores [Q, L] float32 with -inf pad, sorted by
score) and the counters visited [Q] and expanded [Q] int32; the
accept/live mask and the top-R stay with the caller
(`models.searcher.beam_search`):

  * on CUDA tensors it launches the hand-written kernel on the current
    stream: one block a query runs every step of the walk in shared
    memory (pool, visited ring, new neighbours, a hash set for the
    deduplication) and scores rows straight from device memory, so the
    loop needs no host round trip. Past a block's 227 KB of shared memory
    (`beam_smem_bytes`: a pool of thousands, a wide adjacency) the same
    kernel keeps each query's state in a workspace in device memory, so
    every shape runs; it raises on any input the kernel does not take;
  * on CPU tensors it runs the plain version, `beam_search_reference`
    (the walk as a loop of tensor operations). That is the only case the
    plain version serves.

The provider is a row provider of `models.searcher` (`ExactProvider`,
`PQDecodedProvider`): `provider.rows` [N, d] float32 or bfloat16,
`provider.simf`, and `provider.prepared()` -> (queries [Q, d] float32 as
the scoring formula uses them, squared norms [Q]); or its codes provider
(`CodesProvider`, the `pq` provider): `provider.codes` [N, M] uint8 and
`provider.codebooks` [M, K, dsub] float32 in place of the rows, `simf`
EUCLIDEAN or DOT_PRODUCT. The kernel follows the plain formula chain term
by term (norms plus dot, the clamp, then 1/(1+d2); bf16 rows round the
candidate's squared norm, and for cosine its inverse norm, to bf16 as
`PQDecodedProvider` does). Over codes it takes the dot from the query's
ADC table (`codes_table_scores` is that scoring in plain PyTorch) and, for
euclidean, the squared norm from the centroids' squared norms, which the
wrapper computes once a launch.

Tolerance against the plain version: the kernel sums each dot and norm in
another float32 order. `kernel_error_bound` gives, per candidate, a bound
on |kernel score - plain score| from |q| * |c| (2^-21 * sqrt(d) of it for
the two summations of d terms, a few ulp of the dot each, carried through
the formula), plus one bf16 spacing where a bf16-rounded norm sits so
close to a rounding midpoint that the other summation order may round it
the other way. Decisions of
the walk may differ only where the plain version's own scores lie within
those bounds of a tie at a boundary (the top-E pick, the top-L merge):
`beam_search_reference(..., tie_bound=...)`, given a per-candidate bound
such as `kernel_error_bound`'s, reports those queries. Over codes the
kernel sums d products in other float32 orders than the plain decode (a
table entry sums dsub of them, a score M table entries in the order of
the subspaces); `codes_error_bound` bounds that from the worst case of
each summation, (d + dsub + M) units of 2^-24 of the sum of the products'
magnitudes, carried through the formula.

`beam_search.launches` counts kernel launches (one a call, or one per
WORKSPACE_BYTES of state for shapes past a block's shared memory) and
nothing else, so a run can show that its build and search paths went
through it; `beam_search.bf16_launches` counts those over bf16 rows,
`beam_search.codes_launches` those over PQ codes.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from opensearch_jvector_tpu_torch.ops import _kernels
from opensearch_jvector_tpu_torch.ops.distances import SimilarityFunction

NEG_INF = float("-inf")
SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt in to
WORKSPACE_BYTES = 1 << 30  # the most device memory a launch's workspace takes


def _new_neighbors(nb: torch.Tensor, pool: torch.Tensor,
                   visited: torch.Tensor) -> torch.Tensor:
    """[Q, C] mask: nb >= 0, not in pool [Q, L], not in visited [Q, V],
    and the first occurrence of its id within nb.

    Sorts (id, column) keys per row with pool and visited columns first:
    an nb entry survives iff it leads its id's run."""
    x = torch.cat([pool, visited, nb], dim=1)
    w = x.shape[1]
    col = torch.arange(w, device=x.device)
    key = torch.where(x >= 0, x * w + col, -1)
    sk, order = torch.sort(key, dim=1)
    sid = torch.where(sk >= 0, sk // w, -1)
    lead = torch.ones_like(sid, dtype=torch.bool)
    lead[:, 1:] = sid[:, 1:] != sid[:, :-1]
    lead_x = torch.empty_like(lead).scatter_(1, order, lead)
    return lead_x[:, w - nb.shape[1]:] & (nb >= 0)


def _first_topk(x: torch.Tensor, k: int):
    """Top-k along dim 1 where, among equal scores, the lower column wins
    (a stable descending sort): the reference's `lax.top_k` order, which
    `torch.topk` does not promise."""
    s, i = torch.sort(x, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


def _align16(x: int) -> int:
    return (x + 15) & ~15


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p <<= 1
    return p


def beam_smem_bytes(L: int, E: int, M: int, max_iters: int,
                    d: int = 960) -> int:
    """Dynamic shared memory of one block of the kernel (`beam_layout` in
    the source, region by region): the scoring state of d floats (the
    query; over codes its ADC table, d = M x K of the PQ), the pool (L
    scores, ids and expanded flags), the visited ring (max_iters * E ids),
    the picks, the E * M new neighbours and their hash slots, the
    survivors' ids and sort keys (a power of two >= E * M), a scan
    scratch, and a region shared by the hash set (a power of two >= 1.25 x
    (L + ring + E * M) slots of key and column) and the merge's output
    pool."""
    em, v = E * M, max_iters * E
    p = _pow2_at_least(em)
    want = (5 * (L + v + em) + 3) // 4
    h = 64
    while h < want:
        h <<= 1
    sizes = [4 * d, 4 * L, 4 * L, L, 4 * v, 4 * E, 4 * em, 4 * em, 4 * p,
             8 * p, 4 * 64]
    total = sum(_align16(s) for s in sizes)
    merge = _align16(4 * L) * 2 + _align16(L)
    return total + _align16(max(8 * h, merge))


def beam_plan(L: int, E: int, M: int, max_iters: int,
              d: int) -> tuple[int, int]:
    """(shared memory a block, workspace bytes a query) of the kernel at
    this shape (`d` as `beam_smem_bytes` reads it: the dimension, or over
    codes the PQ's M x K): the state in shared memory where it fits a
    block, else in a workspace in device memory. Raises ValueError naming
    the shape where the kernel's 32-bit indexing of that state would
    overflow."""
    if E * M >= 2**28 or L + max_iters * E + E * M >= 2**28 or d >= 2**28:
        raise ValueError(
            f"beam_search: L={L}, E={E}, M={M}, max_iters={max_iters}, "
            f"d={d} is past the kernel's 32-bit indexing")
    need = beam_smem_bytes(L, E, M, max_iters, d)
    return (need, 0) if need <= SMEM_LIMIT else (0, need)


def beam_search_reference(adjacency: torch.Tensor, entry, score, q: int,
                          L: int, E: int, max_iters: int,
                          first_among_ties: bool = False, tie_bound=None,
                          on_steps=None):
    """Plain version of the walk: a loop of batched tensor operations, one
    step an iteration, `score(ids [Q, C]) -> [Q, C]` scoring candidates.

    Returns (pool ids [Q, L] int64, pool scores [Q, L], visited [Q],
    expanded [Q]). With `tie_bound(ids) -> [Q, C]` (a per-candidate bound
    on another implementation's score error) it also returns near [Q]
    bool, the queries where a boundary of the walk (the top-E pick or the
    top-L merge) holds two candidates whose scores lie within their bounds
    of each other, and the pool's bounds [Q, L]. `on_steps(n)` is called
    once with the steps the walk ran (each starts after a host wait on
    `active`)."""
    dev = adjacency.device
    m = adjacency.shape[1]
    rows = torch.arange(q, device=dev)
    topk = _first_topk if first_among_ties else (
        lambda x, k: torch.topk(x, k, dim=1))

    cand_ids = torch.full((q, L), -1, dtype=torch.long, device=dev)
    cand_ids[:, 0] = entry
    cand_scores = torch.full((q, L), NEG_INF, device=dev)
    cand_scores[:, 0] = score(cand_ids[:, :1])[:, 0]
    cand_expanded = torch.zeros((q, L), dtype=torch.bool, device=dev)
    visited_buf = torch.full((q, max_iters * E), -1, dtype=torch.long,
                             device=dev)
    visited_n = torch.ones((q,), dtype=torch.int32, device=dev)
    expanded_n = torch.zeros((q,), dtype=torch.int32, device=dev)
    active = torch.ones((q,), dtype=torch.bool, device=dev)
    if tie_bound is not None:
        near = torch.zeros((q,), dtype=torch.bool, device=dev)
        cand_bound = torch.zeros((q, L), device=dev)
        cand_bound[:, 0] = tie_bound(cand_ids[:, :1])[:, 0]

    it = 0
    while it < max_iters and bool(active.any()):
        # ---- pick top-E unexpanded candidates per query ----------------
        pickable = ~cand_expanded & (cand_ids >= 0)
        pick_scores = torch.where(pickable, cand_scores, NEG_INF)
        top_s, slots = topk(pick_scores, E)
        picked_ids = torch.gather(cand_ids, 1, slots)
        q_active = active & (top_s[:, 0] > NEG_INF)
        picked_valid = (top_s > NEG_INF) & q_active[:, None]
        if tie_bound is not None:
            near |= q_active & _boundary_tie(pick_scores, cand_bound, E)
        cand_expanded[rows[:, None], slots] |= picked_valid
        visited_buf[:, it * E:(it + 1) * E] = torch.where(
            picked_valid, picked_ids, -1)
        expanded_n += picked_valid.sum(1, dtype=torch.int32)

        # ---- gather + dedup neighbors ----------------------------------
        nb = adjacency[picked_ids.clamp(min=0)].long()  # [Q, E, M]
        nb = torch.where(picked_valid[:, :, None], nb, -1).reshape(q, E * m)
        nb_valid = _new_neighbors(nb, cand_ids, visited_buf)
        nb = torch.where(nb_valid, nb, -1)

        # ---- score new candidates, merge into the pool (top-L) ---------
        nb_scores = torch.where(nb_valid, score(nb), NEG_INF)
        visited_n += nb_valid.sum(1, dtype=torch.int32)
        all_scores = torch.cat([cand_scores, nb_scores], 1)
        cand_scores, idx = topk(all_scores, L)
        cand_ids = torch.gather(torch.cat([cand_ids, nb], 1), 1, idx)
        cand_expanded = torch.gather(
            torch.cat([cand_expanded, torch.zeros_like(nb_valid)], 1), 1, idx)
        if tie_bound is not None:
            all_bound = torch.cat([cand_bound, tie_bound(nb)], 1)
            near |= q_active & _boundary_tie(all_scores, all_bound, L)
            cand_bound = torch.gather(all_bound, 1, idx)
        active = q_active
        it += 1
    if on_steps is not None:
        on_steps(it)
    if tie_bound is not None:
        return (cand_ids, cand_scores, visited_n, expanded_n, near,
                cand_bound)
    return cand_ids, cand_scores, visited_n, expanded_n


def _boundary_tie(scores: torch.Tensor, bound: torch.Tensor,
                  k: int) -> torch.Tensor:
    """[Q] bool: some finite score among the top k and some finite score
    below them lie within their bounds of each other (another score order
    could swap them across the boundary)."""
    s, i = torch.sort(scores, dim=1, descending=True)
    b = torch.gather(bound, 1, i)
    finite = s > NEG_INF
    inf = float("inf")
    top = torch.where(finite[:, :k], s[:, :k] - b[:, :k], inf).amin(1)
    if s.shape[1] <= k:
        return torch.zeros_like(top, dtype=torch.bool)
    rest = torch.where(finite[:, k:], s[:, k:] + b[:, k:], NEG_INF).amax(1)
    return top <= rest


def _bf16_flip(x: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """Where a positive float32 `x` lies within `tol` of a midpoint between
    two bf16 values, the spacing between them (a sum taken in another
    order may round to the other one); 0 elsewhere."""
    r = x.to(torch.bfloat16).contiguous()
    bits = r.view(torch.int16)
    up = (bits + 1).view(torch.bfloat16).float()
    dn = (bits - 1).view(torch.bfloat16).float()
    rf = r.float()
    dist = torch.minimum((x - (rf + up) / 2).abs(), (x - (rf + dn) / 2).abs())
    flip = torch.maximum(up - rf, rf - dn)
    return torch.where((dist <= tol) & (x > 0), flip, 0.0)


def _sum_error(d: int) -> float:
    """Relative bound (to |a| |b|) on the difference of two float32 dots of
    d terms summed in different orders: each side sums in chains of about
    sqrt(d) terms (the kernel: d / 32 a lane, then a 32-lane tree; PyTorch:
    blocked vector sums), a few ulp each, so 2^-21 * sqrt(d) covers both
    with a margin of 4."""
    return 2.0**-21 * d**0.5


def kernel_error_bound(provider, ids: torch.Tensor) -> torch.Tensor:
    """[Q, C] bound on |kernel score - plain score| for candidates `ids`
    [Q, C] of `provider` (see the module docstring)."""
    q, q2 = provider.prepared()
    c = provider.rows[ids.clamp(min=0)].float()
    d = c.shape[-1]
    c2 = torch.sum(c * c, -1)  # as the plain version sums it
    cn = c2.sqrt()
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    s = provider(ids)
    g = _sum_error(d)
    simf = provider.simf
    if simf is SimilarityFunction.EUCLIDEAN:
        e_c2 = g * c2
        if provider.rounded:
            e_c2 = e_c2 + _bf16_flip(c2, g * c2)
        e_d2 = (e_c2 + 2.0 * g * qn * cn
                + 2.0**-21 * (q2[:, None] + c2 + 2.0 * qn * cn))
        den = torch.clamp(1.0 - e_d2 * s, min=0.5)
        return e_d2 * s * s / den + 2.0**-22 * s
    scale = torch.ones_like(c2)
    e_rel = torch.zeros_like(c2)
    if simf is SimilarityFunction.COSINE:
        c2r = c2.to(provider.rows.dtype).float() if provider.rounded else c2
        scale = torch.rsqrt(c2r + 1e-30)
        e_rel = e_rel + g / 2 + 2.0**-21  # the inverse norm's own error
        if provider.rounded:
            e_rel = (e_rel + _bf16_flip(c2, g * c2) / (2.0 * c2r + 1e-30)
                     + _bf16_flip(scale, 2.0**-21 * scale) / scale)
            scale = scale.to(provider.rows.dtype).float()
    mag = qn * cn * scale  # >= |dot| of the scored pair
    e_dot = g * mag + (e_rel + 2.0**-22) * mag
    return e_dot / 2.0 + 2.0**-22 * s.abs() + 2.0**-24


def codes_table_scores(provider, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel's scoring over codes: [Q, C] scores of
    candidates `ids` [Q, C] of the codes `provider` from each query's ADC
    table (T[m][k] = sum_j q[m dsub + j] cb[m][k][j]), its entries summed
    in the order of the subspaces, as a thread of the kernel sums them;
    for euclidean the centroids' squared norms likewise; then the plain
    chain."""
    q, q2 = provider.prepared()
    cb = provider.codebooks
    m, _, dsub = cb.shape
    table = torch.einsum("qmj,mkj->qmk", q.reshape(-1, m, dsub), cb)
    codes = provider.codes[ids.clamp(min=0)].long().transpose(1, 2)  # [Q,M,C]
    dot = _sum_in_order(torch.gather(table, 2, codes))
    if provider.simf is SimilarityFunction.EUCLIDEAN:
        sub = torch.arange(m, device=codes.device)[:, None]
        c2 = _sum_in_order(torch.sum(cb * cb, -1)[sub, codes])
        return 1.0 / (1.0 + torch.clamp(q2[:, None] + c2 - 2.0 * dot,
                                        min=0.0))
    return (1.0 + dot) / 2.0


def _sum_in_order(x: torch.Tensor) -> torch.Tensor:
    """x [Q, M, C] summed over M one term after another -> [Q, C]."""
    total = x[:, 0]
    for i in range(1, x.shape[1]):
        total = total + x[:, i]
    return total


def codes_error_bound(provider, ids: torch.Tensor) -> torch.Tensor:
    """[Q, C] bound on |kernel score - plain score| for candidates `ids`
    [Q, C] of the codes `provider` (see the module docstring): each side's
    dot (and euclidean squared norm) is within (d + dsub + M) units of
    2^-24 of the sum of its products' magnitudes (recursive summation in
    any order), carried through the formula as `kernel_error_bound`
    carries its dot."""
    q, q2 = provider.prepared()
    m, _, dsub = provider.codebooks.shape
    dec = provider.decoded(ids)
    mag = torch.sum((q[:, None, :] * dec).abs(), -1)  # >= |dot|
    g = (m * dsub + dsub + m + 4) * 2.0**-24
    s = provider(ids)
    if provider.simf is SimilarityFunction.EUCLIDEAN:
        c2 = torch.sum(dec * dec, -1)
        e_d2 = g * (c2 + 2.0 * mag) + 2.0**-21 * (q2[:, None] + c2
                                                   + 2.0 * mag)
        den = torch.clamp(1.0 - e_d2 * s, min=0.5)
        return e_d2 * s * s / den + 2.0**-22 * s
    return g * mag / 2.0 + 2.0**-22 * s.abs() + 2.0**-24


def _bind() -> ctypes.CDLL:
    """Build (once) and load the kernel, declaring its C signature."""
    lib = _kernels.load("beam_search")
    fn = lib.beam_search_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        lib.beam_smem_bytes_c.argtypes = [ctypes.c_int] * 5
        lib.beam_smem_bytes_c.restype = ctypes.c_longlong
        codes = lib.beam_search_codes_launch
        codes.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                          + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                          + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
                          + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 6)
        codes.restype = ctypes.c_int
    return lib


_SIMF_CODE = {SimilarityFunction.EUCLIDEAN: 0,
              SimilarityFunction.DOT_PRODUCT: 1,
              SimilarityFunction.COSINE: 2}


def beam_search(adjacency: torch.Tensor, entry, provider, q: int, L: int,
                E: int, max_iters: int, on_steps=None, on_launches=None):
    """The walk for `q` queries from `entry` (an int, or [Q] ids) over
    `adjacency` [N, M] int32, scored by the row or codes `provider` ->
    (pool ids [Q, L] int64, pool scores [Q, L], visited [Q], expanded
    [Q]). On the CPU the plain walk reports its steps to `on_steps`; on a
    card the kernel reports its launches to `on_launches`."""
    codes = getattr(provider, "codebooks", None) is not None
    data = provider.codes if codes else provider.rows
    what = "codes" if codes else "rows"
    if adjacency.device.type == "cpu":
        if data.device.type != "cpu":
            raise ValueError(f"beam_search: adjacency on the CPU, {what} on "
                             f"{data.device}")
        return beam_search_reference(adjacency, entry, provider, q, L, E,
                                     max_iters, on_steps=on_steps)
    dev = adjacency.device
    queries, q2 = provider.prepared()
    devices = {data.device, queries.device}
    if codes:
        devices.add(provider.codebooks.device)
    if not adjacency.is_cuda or devices != {dev}:
        raise ValueError(
            f"beam_search: adjacency on {adjacency.device}, {what} on "
            f"{data.device}, queries on {queries.device}: all must be on one "
            "CUDA device (or all on the CPU)")
    if adjacency.dtype != torch.int32 or adjacency.dim() != 2:
        raise ValueError(f"beam_search: adjacency must be [N, M] int32, got "
                         f"{tuple(adjacency.shape)} {adjacency.dtype}")
    if codes:
        cb = provider.codebooks
        if (data.dtype != torch.uint8 or data.dim() != 2
                or cb.dtype != torch.float32 or cb.dim() != 3
                or cb.shape[0] != data.shape[1] or not cb.is_contiguous()):
            raise ValueError(
                f"beam_search: codes must be [N, M] uint8 and codebooks "
                f"[M, K, dsub] float32 (contiguous), got "
                f"{tuple(data.shape)} {data.dtype}, {tuple(cb.shape)} "
                f"{cb.dtype}")
        msub, ksub, dsub = cb.shape
        n, d, state = data.shape[0], msub * dsub, msub * ksub
    else:
        if data.dtype not in (torch.float32, torch.bfloat16) or (
                data.dim() != 2):
            raise ValueError(f"beam_search: rows must be [N, d] float32 or "
                             f"bfloat16, got {tuple(data.shape)} "
                             f"{data.dtype}")
        n, d = data.shape
        state = d
    m = adjacency.shape[1]
    if (queries.shape != (q, d) or queries.dtype != torch.float32
            or q2.shape != (q,) or q2.dtype != torch.float32):
        raise ValueError(f"beam_search: prepared queries {tuple(queries.shape)}"
                         f" {queries.dtype} and norms {tuple(q2.shape)} "
                         f"{q2.dtype} for {q} queries of {d} dimensions")
    if not (1 <= L and 1 <= E and max_iters >= 0 and d >= 1 and m >= 1 and max(n, adjacency.shape[0]) < 2**31
            and q < 2**31):
        raise ValueError(f"beam_search: shape Q={q} L={L} E={E} M={m} "
                         f"max_iters={max_iters} N={n} d={d} out of range")
    _, ws_query = beam_plan(L, E, m, max_iters, state)
    if not (data.is_contiguous() and adjacency.is_contiguous()):
        raise ValueError(f"beam_search: {what} and adjacency must be "
                         "contiguous")
    if isinstance(entry, torch.Tensor) and entry.dim() == 1:
        entries = entry.to(device=dev, dtype=torch.long).contiguous()
        if entries.shape != (q,):
            raise ValueError(f"beam_search: {entries.shape[0]} entries for "
                             f"{q} queries")
    else:
        entries = torch.full((q,), int(entry), dtype=torch.long, device=dev)
    queries = queries.contiguous()
    q2 = q2.contiguous()
    out_ids = torch.empty((q, L), dtype=torch.long, device=dev)
    out_scores = torch.empty((q, L), dtype=torch.float32, device=dev)
    visited = torch.empty((q,), dtype=torch.int32, device=dev)
    expanded = torch.empty((q,), dtype=torch.int32, device=dev)
    if q == 0:
        return out_ids, out_scores, visited, expanded
    width = data.shape[1] * data.element_size()
    vec = int(data.data_ptr() % 16 == 0 and width % 16 == 0)
    cnorm = None
    if codes and provider.simf is SimilarityFunction.EUCLIDEAN:
        cnorm = torch.sum(cb * cb, -1).contiguous()  # [M, K], one a launch
    # past a block's shared memory, each query's state goes to a workspace
    # in device memory, in launches of at most WORKSPACE_BYTES of it
    step = q if not ws_query else max(1, WORKSPACE_BYTES // ws_query)
    ws = (torch.empty(min(step, q) * ws_query, dtype=torch.uint8, device=dev)
          if ws_query else None)
    lib = _bind()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bf16 = data.dtype == torch.bfloat16
    ws_ptr = None if ws is None else ws.data_ptr()
    launched = 0
    for lo in range(0, q, step):
        hi = min(lo + step, q)
        outs = (out_ids[lo].data_ptr(), out_scores[lo].data_ptr(),
                visited[lo:].data_ptr(), expanded[lo:].data_ptr(), stream)
        with torch.cuda.device(dev):
            if codes:
                err = lib.beam_search_codes_launch(
                    adjacency.data_ptr(), m, data.data_ptr(), msub, ksub,
                    cb.data_ptr(), None if cnorm is None else cnorm.data_ptr(),
                    d, vec, queries[lo].data_ptr(), q2[lo:].data_ptr(),
                    entries[lo:].data_ptr(), hi - lo, L, E, max_iters,
                    _SIMF_CODE[provider.simf], ws_ptr, *outs)
            else:
                err = lib.beam_search_launch(
                    adjacency.data_ptr(), m, data.data_ptr(), int(bf16), d,
                    vec, queries[lo].data_ptr(), q2[lo:].data_ptr(),
                    entries[lo:].data_ptr(), hi - lo, L, E, max_iters,
                    _SIMF_CODE[provider.simf], ws_ptr, *outs)
        if err != 0:
            raise RuntimeError(f"beam_search: kernel launch failed, "
                               f"cudaError {err}")
        launched += 1
        with _COUNT_LOCK:  # searches and merges launch from several threads
            beam_search.launches += 1
            beam_search.bf16_launches += bf16
            beam_search.codes_launches += codes
    if on_launches is not None:
        on_launches(launched)
    return out_ids, out_scores, visited, expanded


beam_search.launches = 0  # every launch
beam_search.bf16_launches = 0  # those over bf16 rows (the decoded cache)
beam_search.codes_launches = 0  # those over PQ codes (the `pq` provider)
_COUNT_LOCK = threading.Lock()
