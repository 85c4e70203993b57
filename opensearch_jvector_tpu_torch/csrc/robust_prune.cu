// The batched alpha-robust prune in one launch, for Hopper (sm_90a).
//
// Replaces the compiled `lax.fori_loop` of
// opensearch_jvector_tpu/models/builder.py:robust_prune_batch (every prune
// of the graph build: insert rounds, overflow re-prunes, the bootstrap
// block, the cleanup's splice). The port's plain version
// (ops/prune_kernel.py:robust_prune_reference) gathers the [B, C, d]
// candidate rows, materialises the [B, C, C] distances (1.14 GB at the
// build's B = 16,384 and C = 132) and runs m_out selection steps of ~8
// launches each.
//
// One block a row b (256 threads, each taking every 256th candidate
// column) reads its candidates' rows by id from the corpus (float32, or
// bf16 upcast in the kernel), so neither the gather nor the distance
// tensor reaches device memory. A selection step needs only the distances from the chosen
// c* to the candidates still alive, so the block computes exactly those:
// c*'s row is staged in shared memory and each group of 8 lanes takes one
// alive candidate (16-byte loads across the row, lanes on neighbouring
// addresses), 32 rows in flight a block: a step waits on the latency of
// its row reads, so more rows in flight, not wider reads, shorten it.
// Over a prune that is at most m_out rows of the C x C matrix, and usually
// far fewer entries, since pruning empties the alive set quickly; the rows
// come from L2 after their first read. What bounds it on an H100: the
// float32 operations of those distances, and the first read of the B x C
// candidate rows from device memory.
//
// A block keeps c*'s row and 13 bytes a candidate column in shared memory
// (`prune_smem_bytes`). Where that outgrows the 227 KB a Hopper block may
// use (tens of thousands of candidates, or a very wide row), the same
// kernel keeps them in a per-row slice of a workspace in device memory
// instead (template flag G); every candidate width the builder can ask for
// runs.
//
// The rules are the plain version's exactly: the first occurrence of an id
// only, the point itself never, argmin ties to the lowest column, and the
// strict alpha * d(c*, c) < d(p, c), so duplicate vectors stay selectable.
// d(p, c) comes from the given scores by the same float32 operations as
// `_score_to_dist` (bit-equal); d(c*, c) follows `pairwise_scores` then
// `_score_to_dist` term by term with IEEE roundings, its sums in another
// float32 order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 8;                     // lanes a candidate row
constexpr int kGroups = kThreads / kGroup;    // rows in flight a block
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory: c*'s row (d floats), then a candidate column each of id,
// d(p, c), norm term and alive flag, then the reduction scratch.
__host__ __device__ inline size_t prune_smem_bytes(int C, int d) {
  return align16(4 * size_t(d)) + 3 * align16(4 * size_t(C)) +
         align16(size_t(C)) + align16(8 * kWarps + 16);
}

template <typename T>
__device__ __forceinline__ float load_f(const T* p) {
  if constexpr (std::is_same<T, float>::value) return __ldg(p);
  else return __bfloat162float(*p);
}

// Dot over a group of kGroup lanes of `a` (shared, float) with row `b`
// (device memory), or of `b` with itself when `a` is null; every lane of
// the group (`gl` its lane in the group, `gmask` the group's lanes)
// returns the total.
template <typename T>
__device__ __forceinline__ float group_dot(const float* __restrict__ a,
                                           const T* __restrict__ b, int d,
                                           bool vec, int gl, unsigned gmask) {
  float acc = 0.f;
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    for (int i = gl * V; i < d; i += kGroup * V) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(b + i));
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
        if (a) {
          const float4 x = *reinterpret_cast<const float4*>(a + i + k);
          acc = fmaf(c[k], x.x, acc); acc = fmaf(c[k + 1], x.y, acc);
          acc = fmaf(c[k + 2], x.z, acc); acc = fmaf(c[k + 3], x.w, acc);
        } else {
          acc = fmaf(c[k], c[k], acc); acc = fmaf(c[k + 1], c[k + 1], acc);
          acc = fmaf(c[k + 2], c[k + 2], acc);
          acc = fmaf(c[k + 3], c[k + 3], acc);
        }
      }
    }
  } else {
    for (int i = gl; i < d; i += kGroup) {
      const float c = load_f(b + i);
      acc = fmaf(c, a ? a[i] : c, acc);
    }
  }
#pragma unroll
  for (int o = kGroup / 2; o; o >>= 1) acc += __shfl_xor_sync(gmask, acc, o);
  return acc;
}

// _score_to_dist of ops/prune_kernel.py.
template <int SIMF>
__device__ __forceinline__ float score_to_dist(float s) {
  if (SIMF == 0) {
    const float x = __fsub_rn(__fdiv_rn(1.0f, fmaxf(s, 1e-30f)), 1.0f);
    return __fsqrt_rn(fmaxf(x, 0.0f));
  }
  return __fsub_rn(1.0f, s);
}

// pairwise_scores for one pair, from the dot and the norm terms (squared
// norms for euclidean, inverse norms for cosine).
template <int SIMF>
__device__ __forceinline__ float pair_score(float dot, float ta, float tb) {
  if (SIMF == 0) {
    float t = __fsub_rn(__fadd_rn(ta, tb), __fmul_rn(2.0f, dot));
    t = fmaxf(t, 0.0f);
    return __fdiv_rn(1.0f, __fadd_rn(1.0f, t));
  }
  if (SIMF == 2) dot = __fmul_rn(__fmul_rn(dot, ta), tb);
  return __fdiv_rn(__fadd_rn(1.0f, dot), 2.0f);
}

struct PruneParams {
  const void* rows;
  int d;
  int vec;
  const int64_t* cand_ids;
  const float* cand_scores;
  const int64_t* point_ids;
  int C;
  float alpha;
  int m_out;
  unsigned char* ws;  // G: the per-row state, prune_smem_bytes() each
  int64_t* out;
};

template <typename T, int SIMF, bool G>
__global__ void __launch_bounds__(kThreads)
    robust_prune_kernel(const PruneParams p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.C, d = p.d;
  unsigned char* smem =
      G ? p.ws + size_t(b) * prune_smem_bytes(C, d) : dyn_smem;
  float* row_s = reinterpret_cast<float*>(smem);
  size_t o = align16(4 * size_t(d));
  int* ids = reinterpret_cast<int*>(smem + o); o += align16(4 * size_t(C));
  float* dp = reinterpret_cast<float*>(smem + o); o += align16(4 * size_t(C));
  float* nt = reinterpret_cast<float*>(smem + o); o += align16(4 * size_t(C));
  unsigned char* alive = smem + o; o += align16(size_t(C));
  float* red_v = reinterpret_cast<float*>(smem + o);
  int* red_i = reinterpret_cast<int*>(red_v + kWarps);
  int* chosen = red_i + kWarps;
  const T* rows = static_cast<const T*>(p.rows);
  const bool vec = p.vec != 0;
  int64_t* out = p.out + int64_t(b) * p.m_out;
  const int grp = tid / kGroup, gl = tid % kGroup;
  const unsigned gmask = ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));

  for (int c = tid; c < C; c += kThreads) {
    ids[c] = int(p.cand_ids[int64_t(b) * C + c]);
    dp[c] = score_to_dist<SIMF>(p.cand_scores[int64_t(b) * C + c]);
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    const int id = ids[c];
    bool ok = id >= 0 && (p.point_ids == nullptr || id != p.point_ids[b]);
    for (int j = 0; ok && j < c; ++j) ok = ids[j] != id;
    alive[c] = ok;
  }
  __syncthreads();
  // the norm term of every alive candidate, one group of lanes a row
  if (SIMF != 1) {
    for (int c = grp; c < C; c += kGroups) {
      if (!alive[c]) continue;
      const float n2 = group_dot<T>(nullptr, rows + int64_t(ids[c]) * d, d,
                                    vec, gl, gmask);
      if (gl == 0)
        nt[c] = SIMF == 0 ? n2
                          : __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(n2, 1e-30f)));
    }
  }
  __syncthreads();

  int t = 0;
  for (; t < p.m_out; ++t) {
    // argmin of d(p, c) over the alive columns, the lowest column on ties
    float v = INFINITY;
    int i = C;
    for (int c = tid; c < C; c += kThreads)
      if (alive[c] && dp[c] < v) {  // ascending c: the lowest on ties
        v = dp[c];
        i = c;
      }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float v2 = __shfl_down_sync(kFull, v, off);
      const int i2 = __shfl_down_sync(kFull, i, off);
      if (v2 < v || (v2 == v && i2 < i)) { v = v2; i = i2; }
    }
    if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
    __syncthreads();
    if (tid == 0) {
      float bv = red_v[0];
      int bi = red_i[0];
      for (int w = 1; w < kWarps; ++w)
        if (red_v[w] < bv || (red_v[w] == bv && red_i[w] < bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      chosen[0] = bv < INFINITY ? bi : -1;
      if (bv < INFINITY) {
        out[t] = ids[bi];
        alive[bi] = 0;
      }
    }
    __syncthreads();
    const int ci = chosen[0];
    if (ci < 0) break;  // nothing left (block-uniform)
    const T* row = rows + int64_t(ids[ci]) * d;
    for (int k = tid; k < d; k += kThreads) row_s[k] = load_f(row + k);
    __syncthreads();
    const float ta = nt[ci];
    for (int c = grp; c < C; c += kGroups) {
      if (!alive[c]) continue;  // c* was cleared above
      const float dot = group_dot<T>(row_s, rows + int64_t(ids[c]) * d, d,
                                     vec, gl, gmask);
      const float dist = score_to_dist<SIMF>(pair_score<SIMF>(dot, ta, nt[c]));
      if (gl == 0 && __fmul_rn(p.alpha, dist) < dp[c]) alive[c] = 0;
    }
    __syncthreads();
  }
  for (int k = t + tid; k < p.m_out; k += kThreads) out[k] = -1;
}

template <typename T, int SIMF, bool G>
cudaError_t launch(const PruneParams& p, int b, size_t smem,
                   cudaStream_t stream) {
  auto kernel = robust_prune_kernel<T, SIMF, G>;
  if (G) smem = 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<b, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int SIMF>
cudaError_t launch_on(const PruneParams& p, int b, size_t smem,
                      cudaStream_t s) {
  return p.ws ? launch<T, SIMF, true>(p, b, smem, s)
              : launch<T, SIMF, false>(p, b, smem, s);
}

}  // namespace

extern "C" long long prune_smem_bytes_c(int C, int d) {
  return static_cast<long long>(prune_smem_bytes(C, d));
}

// rows [N, d] float32 (row_bf16 = 0) or bf16 (1); cand_ids [B, C] int64
// (-1 pad); cand_scores [B, C] float32; point_ids [B] int64 or null; simf
// 0 euclidean, 1 dot product, 2 cosine; ws null (the state in shared
// memory) or B * prune_smem_bytes_c(C, d) bytes of device memory; out
// [B, m_out] int64. Returns a cudaError_t.
extern "C" int robust_prune_launch(const void* rows, int row_bf16, int d,
                                   int vec, const int64_t* cand_ids,
                                   const float* cand_scores,
                                   const int64_t* point_ids, int b, int C,
                                   float alpha, int m_out, int simf, void* ws,
                                   int64_t* out, void* stream) {
  if (C < 1) return int(cudaErrorInvalidValue);
  const PruneParams p{rows, d, vec, cand_ids, cand_scores, point_ids, C,
                      alpha, m_out, static_cast<unsigned char*>(ws), out};
  const size_t smem = prune_smem_bytes(C, d);
  if (ws == nullptr && smem > 232448) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (row_bf16) {
    switch (simf) {
      case 0: err = launch_on<__nv_bfloat16, 0>(p, b, smem, s); break;
      case 1: err = launch_on<__nv_bfloat16, 1>(p, b, smem, s); break;
      default: err = launch_on<__nv_bfloat16, 2>(p, b, smem, s); break;
    }
  } else {
    switch (simf) {
      case 0: err = launch_on<float, 0>(p, b, smem, s); break;
      case 1: err = launch_on<float, 1>(p, b, smem, s); break;
      default: err = launch_on<float, 2>(p, b, smem, s); break;
    }
  }
  return int(err);
}
