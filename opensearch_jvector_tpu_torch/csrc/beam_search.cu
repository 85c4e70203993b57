// The batched best-first beam walk in one launch, for Hopper (sm_90a).
//
// Replaces the compiled `jax.lax.while_loop` of
// opensearch_jvector_tpu/models/searcher.py:beam_search (the graph build's
// insert rounds, delta inserts and refinement, the hierarchy descent, the
// in_memory and on_disk beam tiers, `sharded_search`). The port's plain
// version (ops/beam_kernel.py:beam_search_reference) runs the same walk as
// ~15 launches a step and one host wait a step; here a block walks one
// query through every step in shared memory and never returns to the host.
//
// What bounds it on an H100: the gathers of candidate rows, which are
// scattered in device memory (one 512-byte fp32 row, or a 256-byte bf16
// row, per scored candidate at d = 128; each row is read once a query). A
// warp scores one candidate with 16-byte loads across the row, lanes on
// neighbouring addresses, so each row costs the fewest transactions; eight
// warps a block keep eight rows in flight, and many blocks an SM (a small
// pool needs ~13 KB of shared memory) hide the latency. The control work
// of a step (pick, dedup, sort, merge) runs from shared memory.
//
// Scoring is a policy of the kernel (`Score<T, SIMF>`), picked at compile
// time by the type of what the walk scores; the control steps are shared.
// Rows (T = float or bf16): the above. PQ codes (T = uint8_t, the `pq`
// provider over an NVQ segment's auxiliary codes): a candidate is M code
// bytes (48 at PQ48), ~10x fewer bytes than an fp32 row, but each code
// names a codebook row; reading those through L1 a candidate took 2.7-4.4x
// the time of a table at PQ48 (PERF.md §6). So at the start the
// block builds its query's ADC table in shared memory, T[m][k] = sum_j
// q[m dsub + j] cb[m][k][j] in float32 (M x K floats: 48 KB at PQ48, K
// 256), in place of the query; then a thread scores a candidate: 16-byte
// loads of its codes (the loads of all the block's candidates in flight
// at once) and M table lookups, dot = sum_m T[m][code_m]; for euclidean c2
// = sum_m C[m][code_m] from one table of centroid squared norms a launch
// (`cnorm`, cached in L1), then the plain chain as for rows.
//
// Every shape the callers may ask for runs here. Where one block's state
// (`beam_layout`) outgrows the 227 KB of shared memory a Hopper block may
// use (a wide pool: k in the thousands, or a wide adjacency), the same
// kernel keeps it in a per-query slice of a workspace in device memory
// instead (template flag G), which the L1 and L2 caches serve; the steps
// and their order are the same.
//
// One step of one query (thread block of 256, one query a block):
//   1. pick the first E unexpanded candidates of the pool, which is kept
//      sorted by score (descending), so the pick is a prefix count;
//   2. mark them expanded and append them to the visited ring;
//   3. gather their adjacency rows (E * M new neighbour ids);
//   4. deduplicate the new ids against the CURRENT pool, the visited ring
//      and each other, keeping the first occurrence, through a hash set in
//      shared memory that is rebuilt each step (an evicted node may be
//      admitted again, as in the plain version). Pool and ring ids carry
//      the tag -1, a new id its column; atomicMin keeps the smallest tag
//      per slot, so the survivor of a repeated id is its first column
//      whatever the order the threads insert in (deterministic);
//   5. compact the survivors (order kept), score them, one warp a row;
//   6. sort them by (score descending, column ascending) with a bitonic
//      sort of 64-bit keys, and merge them into the pool by rank (pool
//      entries first among equal scores), keeping the top L;
//   7. a query stops when its pool has no unexpanded candidate, or after
//      max_iters steps.
// Scores follow the plain formula chains term by term with IEEE roundings
// (no contraction into FMA across terms): euclidean q2 + c2 - 2 dot, the
// clamp at 0, 1 / (1 + d2); dot (1 + dot) / 2; cosine (1 + dot / |c|) / 2
// with the queries normalised by the caller. bf16 rows (the decoded PQ
// cache) round the candidate's squared norm, and for cosine its inverse
// norm, to bf16 as PQDecodedProvider does. PQ codes score as the `pq`
// provider's decode does (euclidean or dot product; cosine corpora as a
// dot product of normalised queries). Only the order of the float32 sums
// differs from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared-memory layout of one block; ops/beam_kernel.py:beam_smem_bytes
// mirrors it region by region. `d` is the floats of the scoring state at
// the front: the query (rows) or its ADC table (codes, M x K).
struct BeamLayout {
  size_t qv, pool_s, pool_id, pool_x, ring, pick, nb_id, nb_slot, sv_id,
      sv_key, red, scratch, total;
  int hbits, p;
};

__host__ __device__ inline BeamLayout beam_layout(int L, int E, int M,
                                                  int iters, int d) {
  BeamLayout l;
  const long em = long(E) * M, v = long(iters) * E;
  int p = 1;
  while (p < em) p <<= 1;
  const long want = (5 * (long(L) + v + em) + 3) / 4;
  int hb = 6;
  while ((1L << hb) < want) ++hb;
  size_t o = 0;
  l.qv = o; o += align16(4 * size_t(d));
  l.pool_s = o; o += align16(4 * size_t(L));
  l.pool_id = o; o += align16(4 * size_t(L));
  l.pool_x = o; o += align16(size_t(L));
  l.ring = o; o += align16(4 * size_t(v));
  l.pick = o; o += align16(4 * size_t(E));
  l.nb_id = o; o += align16(4 * size_t(em));
  l.nb_slot = o; o += align16(4 * size_t(em));
  l.sv_id = o; o += align16(4 * size_t(p));
  l.sv_key = o; o += align16(8 * size_t(p));
  l.red = o; o += align16(4 * 64);
  l.scratch = o;
  const size_t hash = 8 * (size_t(1) << hb);
  const size_t merge = 2 * align16(4 * size_t(L)) + align16(size_t(L));
  o += align16(hash > merge ? hash : merge);
  l.total = o;
  l.hbits = hb;
  l.p = p;
  return l;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Ascending order of the result = descending score, then ascending column.
__device__ __forceinline__ unsigned desc_bits(float f) {
  unsigned u = __float_as_uint(f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);  // ascending order
  return ~u;                                         // descending
}

__device__ __forceinline__ float from_desc_bits(unsigned d) {
  unsigned u = ~d;
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

// Warp-wide dot of the query (shared memory, float) with one row (device
// memory), and the row's squared norm; every lane returns the totals.
template <typename T>
__device__ __forceinline__ void warp_dot_norm(const T* __restrict__ row,
                                              const float* __restrict__ q,
                                              int d, bool vec, int lane,
                                              float& dot, float& nrm) {
  float a = 0.f, b = 0.f;
  if (vec) {
    constexpr int V = 16 / sizeof(T);  // 4 floats or 8 bf16 a 16-byte load
    for (int i = lane * V; i < d; i += 32 * V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + i));
      float c[V];
      if constexpr (std::is_same<T, float>::value) {
        c[0] = __uint_as_float(raw.x); c[1] = __uint_as_float(raw.y);
        c[2] = __uint_as_float(raw.z); c[3] = __uint_as_float(raw.w);
      } else {
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int k = 0; k < V; ++k) c[k] = __bfloat162float(h[k]);
      }
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(q + i + k);
        a = fmaf(c[k], qq.x, a); b = fmaf(c[k], c[k], b);
        a = fmaf(c[k + 1], qq.y, a); b = fmaf(c[k + 1], c[k + 1], b);
        a = fmaf(c[k + 2], qq.z, a); b = fmaf(c[k + 2], c[k + 2], b);
        a = fmaf(c[k + 3], qq.w, a); b = fmaf(c[k + 3], c[k + 3], b);
      }
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      float c;
      if constexpr (std::is_same<T, float>::value) c = __ldg(row + i);
      else c = __bfloat162float(row[i]);
      a = fmaf(c, q[i], a);
      b = fmaf(c, c, b);
    }
  }
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    a += __shfl_xor_sync(kFull, a, o);
    b += __shfl_xor_sync(kFull, b, o);
  }
  dot = a;
  nrm = b;
}

// The plain formula chains (ops/distances.py:batched_candidate_scores; for
// bf16 rows models/searcher.py:PQDecodedProvider).
template <typename T, int SIMF>
__device__ __forceinline__ float finish_score(float dot, float c2, float q2) {
  constexpr bool kRound = std::is_same<T, __nv_bfloat16>::value;
  if (SIMF == 0) {
    const float c2r = kRound ? bf16_round(c2) : c2;
    float t = __fsub_rn(__fadd_rn(q2, c2r), __fmul_rn(2.0f, dot));
    t = fmaxf(t, 0.0f);
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, t));
  }
  if (SIMF == 2) {
    const float c2r = kRound ? bf16_round(c2) : c2;
    float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(c2r, 1e-30f)));
    if (kRound) inv = bf16_round(inv);
    dot = __fmul_rn(dot, inv);
  }
  return __fdiv_rn(__fadd_rn(1.0f, dot), 2.0f);
}

template <typename T, int SIMF>
__device__ __forceinline__ float score_row(const T* __restrict__ rows,
                                           int id, int d, bool vec,
                                           const float* __restrict__ q,
                                           float q2, int lane) {
  float dot, c2;
  warp_dot_norm<T>(rows + int64_t(id) * d, q, d, vec, lane, dot, c2);
  return finish_score<T, SIMF>(dot, c2, q2);
}

// Exclusive prefix sum of one int a thread over the block; `total` gets
// the block's sum. Leaves `red` free again on return.
__device__ __forceinline__ int block_exclusive_scan(int v, int* red,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? red[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) red[32 + lane] = w;
  }
  __syncthreads();
  const int base = warp ? red[32 + warp - 1] : 0;
  total = red[32 + kWarps - 1];
  __syncthreads();
  return base + x - v;
}

// Insert `id` with `tag` into the open-addressing set; returns its slot.
// The slot's tag ends as the smallest inserted (-1 for pool and ring ids).
__device__ __forceinline__ int hash_insert(int* keys, int* tags, int hbits,
                                           int id, int tag) {
  const unsigned mask = (1u << hbits) - 1u;
  unsigned h = (unsigned(id) * 2654435761u) >> (32 - hbits);
  while (true) {
    const int prev = atomicCAS(&keys[h], -1, id);
    if (prev == -1 || prev == id) {
      atomicMin(&tags[h], tag);
      return int(h);
    }
    h = (h + 1) & mask;
  }
}

struct BeamParams {
  const int32_t* adj;
  int m;
  const void* rows;  // rows [N, d] float or bf16, or codes [N, msub] uint8
  int d;
  int vec;  // a row (codes row) may be read in 16-byte loads
  const float* queries;
  const float* qnorm2;
  const int64_t* entries;
  int L, E, iters;
  unsigned char* ws;  // G: the per-query state, beam_layout().total each
  int64_t* out_ids;
  float* out_scores;
  int32_t* out_visited;
  int32_t* out_expanded;
  // codes: codebooks [msub, ksub, d / msub]; for euclidean the centroids'
  // squared norms [msub, ksub]
  const float* codebooks;
  const float* cnorm;
  int msub, ksub;
};

// How a block scores candidates. Rows (float or bf16): the query sits in
// the state region (d floats) and a warp scores a row.
template <typename T, int SIMF>
struct Score {
  __device__ static int state_floats(const BeamParams& p) { return p.d; }

  __device__ static void prepare(const BeamParams& p, int qi, float* qv,
                                 int tid) {
    for (int i = tid; i < p.d; i += kThreads)
      qv[i] = p.queries[int64_t(qi) * p.d + i];
  }

  // every lane of a warp calls it; every lane returns the score
  __device__ static float one(const BeamParams& p, const float* qv,
                              float q2, int id, int lane) {
    return score_row<T, SIMF>(static_cast<const T*>(p.rows), id, p.d,
                              p.vec != 0, qv, q2, lane);
  }

  // the keys of candidates ids[0, n): the score's descending bits, then s
  __device__ static void many(const BeamParams& p, const float* qv,
                              float q2, const int* ids, int n,
                              unsigned long long* keys, int tid) {
    const int lane = tid & 31, warp = tid >> 5;
    for (int s = warp; s < n; s += kWarps) {
      const float sc = one(p, qv, q2, ids[s], lane);
      if (lane == 0)
        keys[s] = (static_cast<unsigned long long>(desc_bits(sc)) << 32) |
                  unsigned(s);
    }
  }
};

// PQ codes: the query's ADC table sits in the state region (msub x ksub
// floats) and a thread scores a candidate.
template <int SIMF>
struct Score<uint8_t, SIMF> {
  static_assert(SIMF == 0 || SIMF == 1, "codes score euclidean or dot");

  __device__ static int state_floats(const BeamParams& p) {
    return p.msub * p.ksub;
  }

  // table[m][k] = sum_j q[m dsub + j] cb[m][k][j], a float32 chain over j
  __device__ static void prepare(const BeamParams& p, int qi, float* table,
                                 int tid) {
    const int dsub = p.d / p.msub, n = p.msub * p.ksub;
    const float* q = p.queries + int64_t(qi) * p.d;
    for (int e = tid; e < n; e += kThreads) {
      const float* qm = q + (e / p.ksub) * dsub;
      const float* c = p.codebooks + int64_t(e) * dsub;
      float t = 0.f;
      for (int j = 0; j < dsub; ++j) t = fmaf(__ldg(qm + j), __ldg(c + j), t);
      table[e] = t;
    }
  }

  __device__ static float one(const BeamParams& p, const float* table,
                              float q2, int id, int lane) {
    const int M = p.msub, K = p.ksub;
    const uint8_t* row = static_cast<const uint8_t*>(p.rows) + int64_t(id) * M;
    float dot = 0.f, c2 = 0.f;  // summed in the order of the subspaces
    if (p.vec) {
      for (int m0 = 0; m0 < M; m0 += 64) {
        uint4 raw[4];  // up to 64 codes, the loads issued together
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (m0 + 16 * c < M)
            raw[c] = __ldg(reinterpret_cast<const uint4*>(row + m0 + 16 * c));
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (m0 + 16 * c >= M) break;
          const unsigned w[4] = {raw[c].x, raw[c].y, raw[c].z, raw[c].w};
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int m = m0 + 16 * c + i;
            const int k = (w[i >> 2] >> (8 * (i & 3))) & 0xff;
            dot += table[m * K + k];
            if (SIMF == 0) c2 += __ldg(p.cnorm + m * K + k);
          }
        }
      }
    } else {
      for (int m = 0; m < M; ++m) {
        const int k = __ldg(row + m);
        dot += table[m * K + k];
        if (SIMF == 0) c2 += __ldg(p.cnorm + m * K + k);
      }
    }
    return finish_score<float, SIMF>(dot, c2, q2);
  }

  __device__ static void many(const BeamParams& p, const float* table,
                              float q2, const int* ids, int n,
                              unsigned long long* keys, int tid) {
    for (int s = tid; s < n; s += kThreads) {
      const float sc = one(p, table, q2, ids[s], 0);
      keys[s] = (static_cast<unsigned long long>(desc_bits(sc)) << 32) |
                unsigned(s);
    }
  }
};

template <typename T, int SIMF, bool G>
__global__ void __launch_bounds__(kThreads)
    beam_search_kernel(const BeamParams p) {
  using S = Score<T, SIMF>;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int qi = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int L = p.L, E = p.E, M = p.m;
  const int EM = E * M, V = p.iters * E;
  const BeamLayout lay = beam_layout(L, E, M, p.iters, S::state_floats(p));
  unsigned char* smem = G ? p.ws + size_t(qi) * lay.total : dyn_smem;
  float* qv = reinterpret_cast<float*>(smem + lay.qv);
  float* pool_s = reinterpret_cast<float*>(smem + lay.pool_s);
  int* pool_id = reinterpret_cast<int*>(smem + lay.pool_id);
  unsigned char* pool_x = smem + lay.pool_x;
  int* ring = reinterpret_cast<int*>(smem + lay.ring);
  int* pick = reinterpret_cast<int*>(smem + lay.pick);
  int* nb_id = reinterpret_cast<int*>(smem + lay.nb_id);
  int* nb_slot = reinterpret_cast<int*>(smem + lay.nb_slot);
  int* sv_id = reinterpret_cast<int*>(smem + lay.sv_id);
  unsigned long long* sv_key =
      reinterpret_cast<unsigned long long*>(smem + lay.sv_key);
  int* red = reinterpret_cast<int*>(smem + lay.red);
  // the scratch region: the hash set during the dedup, the merge's output
  // pool after it
  const int H = 1 << lay.hbits;
  int* keys = reinterpret_cast<int*>(smem + lay.scratch);
  int* tags = keys + H;
  float* out_s = reinterpret_cast<float*>(smem + lay.scratch);
  int* out_id = reinterpret_cast<int*>(smem + lay.scratch + align16(4 * size_t(L)));
  unsigned char* out_x = smem + lay.scratch + 2 * align16(4 * size_t(L));

  S::prepare(p, qi, qv, tid);
  for (int i = tid; i < L; i += kThreads) {
    pool_s[i] = -INFINITY;
    pool_id[i] = -1;
    pool_x[i] = 0;
  }
  for (int i = tid; i < V; i += kThreads) ring[i] = -1;
  __syncthreads();
  const float q2 = p.qnorm2[qi];
  if (warp == 0) {
    const int entry = int(p.entries[qi]);  // scored as row 0 if < 0
    const float s = S::one(p, qv, q2, entry < 0 ? 0 : entry, lane);
    if (lane == 0) {
      pool_s[0] = s;
      pool_id[0] = entry;
    }
  }
  int visited = 1, expanded = 0;  // block-uniform
  __syncthreads();

  const int pchunk = (L + kThreads - 1) / kThreads;
  const int nchunk = (EM + kThreads - 1) / kThreads;
  for (int it = 0; it < p.iters; ++it) {
    // ---- 1-2. pick the first E unexpanded candidates, mark, record ----
    const int plo = min(tid * pchunk, L), phi = min(plo + pchunk, L);
    int cnt = 0;
    for (int i = plo; i < phi; ++i) cnt += (!pool_x[i] && pool_id[i] >= 0);
    int total;
    int r = block_exclusive_scan(cnt, red, total);
    const int npick = min(total, E);
    if (npick == 0) break;  // the query's walk is over (block-uniform)
    for (int i = plo; i < phi && r < E; ++i)
      if (!pool_x[i] && pool_id[i] >= 0) pick[r++] = i;
    __syncthreads();
    if (tid < E) {
      int id = -1;
      if (tid < npick) {
        pool_x[pick[tid]] = 1;
        id = pool_id[pick[tid]];
      }
      ring[it * E + tid] = id;
    }
    expanded += npick;
    for (int h = tid; h < H; h += kThreads) {
      keys[h] = -1;
      tags[h] = INT_MAX;
    }
    __syncthreads();

    // ---- 3-4. gather the neighbours, dedup through the hash set -------
    for (int j = tid; j < EM; j += kThreads) {
      const int k = j / M;
      nb_id[j] = k < npick ? p.adj[int64_t(ring[it * E + k]) * M + (j - k * M)]
                           : -1;
    }
    for (int i = tid; i < L; i += kThreads)
      if (pool_id[i] >= 0) hash_insert(keys, tags, lay.hbits, pool_id[i], -1);
    for (int i = tid; i < (it + 1) * E; i += kThreads)
      if (ring[i] >= 0) hash_insert(keys, tags, lay.hbits, ring[i], -1);
    __syncthreads();  // nb_id complete
    for (int j = tid; j < EM; j += kThreads)
      nb_slot[j] = nb_id[j] >= 0 ? hash_insert(keys, tags, lay.hbits, nb_id[j], j)
                                 : -1;
    __syncthreads();

    // ---- 5. compact the survivors (column order kept), score them -----
    const int nlo = min(tid * nchunk, EM), nhi = min(nlo + nchunk, EM);
    cnt = 0;
    for (int j = nlo; j < nhi; ++j)
      cnt += (nb_slot[j] >= 0 && tags[nb_slot[j]] == j);
    int n_new;
    r = block_exclusive_scan(cnt, red, n_new);
    for (int j = nlo; j < nhi; ++j)
      if (nb_slot[j] >= 0 && tags[nb_slot[j]] == j) sv_id[r++] = nb_id[j];
    __syncthreads();
    visited += n_new;
    if (n_new == 0) continue;
    int p2 = 1;
    while (p2 < n_new) p2 <<= 1;
    S::many(p, qv, q2, sv_id, n_new, sv_key, tid);
    for (int s = n_new + tid; s < p2; s += kThreads) sv_key[s] = ~0ull;
    __syncthreads();

    // ---- 6. sort the new candidates, merge them into the pool ---------
    for (int k = 2; k <= p2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int i = tid; i < p2; i += kThreads) {
          const int ixj = i ^ j;
          if (ixj > i) {
            const unsigned long long a = sv_key[i], b = sv_key[ixj];
            if ((a > b) == ((i & k) == 0)) {
              sv_key[i] = b;
              sv_key[ixj] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    // a pool entry moves down by the new entries scoring strictly above it
    for (int i = tid; i < L; i += kThreads) {
      const unsigned key = desc_bits(pool_s[i]);
      int lo = 0, hi = n_new;  // first new entry not above pool entry i
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (unsigned(sv_key[mid] >> 32) < key) lo = mid + 1; else hi = mid;
      }
      const int pos = i + lo;
      if (pos < L) {
        out_s[pos] = pool_s[i];
        out_id[pos] = pool_id[i];
        out_x[pos] = pool_x[i];
      }
    }
    // a new entry moves down by the pool entries scoring at least as high
    for (int j = tid; j < n_new; j += kThreads) {
      const unsigned long long kj = sv_key[j];
      const float s = from_desc_bits(unsigned(kj >> 32));
      int lo = 0, hi = L;  // first pool entry scoring below s
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (pool_s[mid] >= s) lo = mid + 1; else hi = mid;
      }
      const int pos = j + lo;
      if (pos < L) {
        out_s[pos] = s;
        out_id[pos] = sv_id[unsigned(kj & 0xffffffffu)];
        out_x[pos] = 0;
      }
    }
    __syncthreads();
    for (int i = tid; i < L; i += kThreads) {
      pool_s[i] = out_s[i];
      pool_id[i] = out_id[i];
      pool_x[i] = out_x[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < L; i += kThreads) {
    p.out_ids[int64_t(qi) * L + i] = pool_id[i];
    p.out_scores[int64_t(qi) * L + i] = pool_s[i];
  }
  if (tid == 0) {
    p.out_visited[qi] = visited;
    p.out_expanded[qi] = expanded;
  }
}

template <typename T, int SIMF, bool G>
cudaError_t launch(const BeamParams& p, int q, size_t smem,
                   cudaStream_t stream) {
  auto kernel = beam_search_kernel<T, SIMF, G>;
  if (G) smem = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<q, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long beam_smem_bytes_c(int L, int E, int M, int iters,
                                       int d) {
  return static_cast<long long>(beam_layout(L, E, M, iters, d).total);
}

template <typename T, int SIMF>
cudaError_t launch_on(const BeamParams& p, int q, size_t smem,
                      cudaStream_t s) {
  return p.ws ? launch<T, SIMF, true>(p, q, smem, s)
              : launch<T, SIMF, false>(p, q, smem, s);
}

// rows [N, d] float32 (row_bf16 = 0) or bf16 (1); queries [Q, d] float32
// prepared for the formula; qnorm2 [Q]; entries [Q] int64; simf 0
// euclidean, 1 dot product, 2 cosine; ws null (the state in shared memory)
// or Q * beam_smem_bytes_c(...) bytes of device memory. Outputs: the pool
// ids [Q, L] int64 and scores [Q, L], visited and expanded [Q] int32.
// Returns a cudaError_t.
extern "C" int beam_search_launch(const int32_t* adj, int m, const void* rows,
                                  int row_bf16, int d, int vec,
                                  const float* queries, const float* qnorm2,
                                  const int64_t* entries, int q, int L, int E,
                                  int iters, int simf, void* ws,
                                  int64_t* out_ids, float* out_scores,
                                  int32_t* out_visited, int32_t* out_expanded,
                                  void* stream) {
  const BeamParams p{adj, m, rows, d, vec, queries, qnorm2, entries, L, E,
                     iters, static_cast<unsigned char*>(ws), out_ids,
                     out_scores, out_visited, out_expanded, nullptr, nullptr,
                     0, 0};
  const size_t smem = beam_layout(L, E, m, iters, d).total;
  if (ws == nullptr && smem > 232448) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (row_bf16) {
    switch (simf) {
      case 0: err = launch_on<__nv_bfloat16, 0>(p, q, smem, s); break;
      case 1: err = launch_on<__nv_bfloat16, 1>(p, q, smem, s); break;
      default: err = launch_on<__nv_bfloat16, 2>(p, q, smem, s); break;
    }
  } else {
    switch (simf) {
      case 0: err = launch_on<float, 0>(p, q, smem, s); break;
      case 1: err = launch_on<float, 1>(p, q, smem, s); break;
      default: err = launch_on<float, 2>(p, q, smem, s); break;
    }
  }
  return int(err);
}

// The walk over PQ codes: codes [N, msub] uint8; codebooks [msub, ksub,
// d / msub] float32; cnorm [msub, ksub] (the centroids' squared norms,
// simf 0 only, else null); queries [Q, d] float32 as the `pq` provider
// prepares them (centred; normalised for a cosine corpus) and qnorm2 [Q];
// simf 0 euclidean or 1 dot product; vec: codes rows may be read in
// 16-byte loads; ws null or Q * beam_smem_bytes_c(L, E, m, iters, msub *
// ksub) bytes. Outputs and return as beam_search_launch.
extern "C" int beam_search_codes_launch(
    const int32_t* adj, int m, const uint8_t* codes, int msub, int ksub,
    const float* codebooks, const float* cnorm, int d, int vec,
    const float* queries, const float* qnorm2, const int64_t* entries, int q,
    int L, int E, int iters, int simf, void* ws, int64_t* out_ids,
    float* out_scores, int32_t* out_visited, int32_t* out_expanded,
    void* stream) {
  if (simf != 0 && simf != 1) return int(cudaErrorInvalidValue);
  const BeamParams p{adj, m, codes, d, vec, queries, qnorm2, entries, L, E,
                     iters, static_cast<unsigned char*>(ws), out_ids,
                     out_scores, out_visited, out_expanded, codebooks, cnorm,
                     msub, ksub};
  const size_t smem = beam_layout(L, E, m, iters, msub * ksub).total;
  if (ws == nullptr && smem > 232448) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = simf == 0
                              ? launch_on<uint8_t, 0>(p, q, smem, s)
                              : launch_on<uint8_t, 1>(p, q, smem, s);
  return int(err);
}
