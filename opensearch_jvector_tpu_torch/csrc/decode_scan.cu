// Fused PQ decode-then-score scan for Hopper (sm_90a): raw inner products
// of queries with the PQ reconstruction of every code row, without ever
// writing the reconstruction to device memory.
//
//   out[q, n] = sum_j bf16(q_c[q, j]) * bf16(cb[j / dsub, codes[n, j / dsub],
//                                                j % dsub])
//   q_c [Q, d] float32 (centered; cosine also normalized), codes [N, M]
//   uint8, cb [M, K, dsub] float32 (K <= 256, d = M * dsub),
//   out [Q, N] float32. A code >= K decodes to zero.
//
// Replaces: opensearch_jvector_tpu/ops/pallas/pq_scan_kernel.py:
// fused_decode_scan (kernel body _decode_score_kernel). The TPU kernel
// decodes each block with one-hot matmuls against a block-diagonal grouped
// codebook because Mosaic cannot gather. Hopper gathers from shared memory,
// so this kernel decodes with a plain gather from a staged codebook slice.
//
// What bounds it on an H100: operations. At the on_disk cell (Q = 512,
// N = 2^20, d = 960) the product is 2*Q*N*d = 1.03e12 FLOP, 1.04 ms at the
// 989 TFLOP/s bf16 tensor-core peak, while the bytes it must move (67 MB of
// codes, 2.15 GB of scores) take 0.66 ms at 3.35 TB/s. This first version
// runs the product on the CUDA cores (float32 FMA, 67 TFLOP/s, so no better
// than 15.4 ms there); the tensor-core (mma / wgmma) form is later work.
//
// What the design does about it:
//   * A block owns a 128-query x 128-row output tile; each of its 256
//     threads keeps an 8 x 8 tile of float32 sums in registers, so every
//     pair of shared-memory operands feeds 64 FMAs.
//   * The dimension runs in chunks of 32. Per chunk the block stages (a)
//     the 32 x 256 codebook slice of those dimensions, (b) its 128 queries'
//     32 values, and (c) decodes its 128 rows' 32 values by gathering from
//     the staged slice with the row's code byte. The decoded tile lives
//     only in shared memory.
//   * A small prep kernel first rounds the queries to bf16 and lays the
//     codebook out per dimension (cbt[j][c] = cb[j / dsub][c][j % dsub],
//     256 slots, zero past K and past d), so each chunk's slice is one
//     contiguous 16 KB copy and codes >= K read zeros: no bounds checks in
//     the inner loops.
//   * Operands are rounded to bf16 (the TPU kernel's numerics) and held as
//     float32 in shared memory; a product of two bf16 values is exact in
//     float32, so the sums are the bf16-operand, float32-accumulate product.
//   * Ragged edges are masked (queries past Q and rows past N), no padding
//     of the inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 128;
constexpr int kTileN = 128;
constexpr int kChunk = 32;   // dimensions per staged chunk
constexpr int kSlots = 256;  // codebook slots per dimension (one per byte)

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// qb[q][j] = bf16(q_c[q][j]) (zero for j >= d), [Q, d_pad];
// cbt[j][c] = bf16(cb[j / dsub][c][j % dsub]) (zero for c >= K or j >= d),
// [d_pad, 256].
__global__ void prep_kernel(const float* __restrict__ q,
                            const float* __restrict__ cb,
                            __nv_bfloat16* __restrict__ qb,
                            __nv_bfloat16* __restrict__ cbt,
                            int Q, int d, int d_pad, int K, int dsub) {
  const long long nq = static_cast<long long>(Q) * d_pad;
  const long long total = nq + static_cast<long long>(d_pad) * kSlots;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < total; i += stride) {
    if (i < nq) {
      const long long row = i / d_pad;
      const int j = static_cast<int>(i - row * d_pad);
      qb[i] = __float2bfloat16(j < d ? q[row * d + j] : 0.0f);
    } else {
      const long long r = i - nq;
      const int j = static_cast<int>(r / kSlots);
      const int c = static_cast<int>(r - static_cast<long long>(j) * kSlots);
      float v = 0.0f;
      if (j < d && c < K) {
        const int m = j / dsub;
        v = cb[(static_cast<long long>(m) * K + c) * dsub + (j - m * dsub)];
      }
      cbt[r] = __float2bfloat16(v);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
decode_scan_kernel(const __nv_bfloat16* __restrict__ qb,
                   const uint8_t* __restrict__ codes,
                   const __nv_bfloat16* __restrict__ cbt,
                   float* __restrict__ out,
                   int Q, int N, int M, int d_pad, int dsub, int vec_out) {
  __shared__ __align__(16) float a_s[kChunk][kTileQ];
  __shared__ __align__(16) float b_s[kChunk][kTileN];
  __shared__ __align__(16) __nv_bfloat16 cb_s[kChunk][kSlots];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output rows tx*4..+3 and 64+tx*4..+3
  const int ty = tid >> 4;  // output queries ty*4..+3 and 64+ty*4..+3
  const long long n0 = static_cast<long long>(blockIdx.x) * kTileN;
  const int q0 = blockIdx.y * kTileQ;

  // decode role: one row, half of each chunk's dimensions
  const int dn = tid & (kTileN - 1);
  const int dk0 = (tid >> 7) * (kChunk / 2);
  const bool row_ok = n0 + dn < N;
  const uint8_t* code_row =
      codes + (row_ok ? n0 + dn : 0) * static_cast<long long>(M);

  // query staging role: one query, 16 of each chunk's dimensions
  const int aq = tid >> 1;
  const int ak0 = (tid & 1) * 16;
  const bool q_ok = q0 + aq < Q;
  const __nv_bfloat16* q_row =
      qb + static_cast<long long>(q_ok ? q0 + aq : 0) * d_pad;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < d_pad; k0 += kChunk) {
    {  // the chunk's codebook slice: 16 KB, contiguous in cbt
      const uint4* src =
          reinterpret_cast<const uint4*>(cbt + static_cast<long long>(k0) *
                                                   kSlots);
      uint4* dst = reinterpret_cast<uint4*>(&cb_s[0][0]);
#pragma unroll
      for (int i = 0; i < kChunk * kSlots * 2 / 16 / kThreads; ++i) {
        dst[tid + i * kThreads] = __ldg(src + tid + i * kThreads);
      }
    }
    {  // the chunk's query values, transposed to a_s[dim][query]
      uint4 w0 = make_uint4(0, 0, 0, 0);
      uint4 w1 = make_uint4(0, 0, 0, 0);
      if (q_ok) {
        const uint4* src = reinterpret_cast<const uint4*>(q_row + k0 + ak0);
        w0 = __ldg(src);
        w1 = __ldg(src + 1);
      }
      const uint32_t h[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a_s[ak0 + 2 * i][aq] = bf16_lo(h[i]);
        a_s[ak0 + 2 * i + 1][aq] = bf16_hi(h[i]);
      }
    }
    __syncthreads();
    {  // decode: b_s[dim][row] = staged slice at the row's code
      const int j = k0 + dk0;
      int m = j / dsub;
      int t = j - m * dsub;
      int code = (row_ok && m < M) ? __ldg(code_row + m) : 0;
#pragma unroll 4
      for (int kk = 0; kk < kChunk / 2; ++kk) {
        const int k = dk0 + kk;
        b_s[k][dn] = row_ok ? __bfloat162float(cb_s[k][code]) : 0.0f;
        if (++t == dsub) {
          t = 0;
          ++m;
          code = (row_ok && m < M) ? __ldg(code_row + m) : 0;
        }
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int q = q0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (q >= Q) continue;
    float* orow = out + static_cast<long long>(q) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long n = n0 + h * 64 + tx * 4;
      if (vec_out && n + 3 < N) {
        *reinterpret_cast<float4*>(orow + n) =
            make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                        acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (n + e < N) orow[n + e] = acc[i][h * 4 + e];
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). `qb` ([Q, d_pad] bf16) and
// `cbt` ([d_pad, 256] bf16) are scratch the caller allocates, with d_pad =
// M * dsub rounded up to a multiple of 32. Launches the prep kernel and the
// scan on `stream`, does not synchronise, and returns the cudaError_t of
// the launches (0 on success).
extern "C" int decode_scan_launch(const void* q_c, const void* codes,
                                  const void* codebooks, void* qb, void* cbt,
                                  void* out, int Q, int N, int M, int K,
                                  int dsub, void* stream) {
  if (Q <= 0 || N <= 0 || M <= 0 || dsub <= 0 || K <= 0 || K > kSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int d = M * dsub;
  const int d_pad = (d + kChunk - 1) / kChunk * kChunk;
  const long long total = static_cast<long long>(Q) * d_pad +
                          static_cast<long long>(d_pad) * kSlots;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  prep_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const float*>(q_c), static_cast<const float*>(codebooks),
      static_cast<__nv_bfloat16*>(qb), static_cast<__nv_bfloat16*>(cbt), Q, d,
      d_pad, K, dsub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((N + kTileN - 1) / kTileN),
            static_cast<unsigned>((Q + kTileQ - 1) / kTileQ));
  decode_scan_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(qb),
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(cbt), static_cast<float*>(out), Q, N,
      M, d_pad, dsub, N % 4 == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
