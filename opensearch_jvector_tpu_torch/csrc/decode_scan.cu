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
// codes, 2.15 GB of scores) take 0.66 ms at 3.35 TB/s. On the CUDA cores
// (float32 FMA, 67 TFLOP/s) the same product could take no less than
// 15.4 ms, so the product runs on the tensor cores.
//
// What the design does about it:
//   * A block owns a 128-query x 128-row output tile, 8 warps in a 2 x 4
//     layout; each warp owns 64 queries x 32 rows, i.e. 4 x 4 tiles of
//     warp-level mma.sync.m16n8k16 (bf16 operands, float32 accumulators,
//     64 sums a thread).
//   * The dimension runs in chunks of 32 (two k16 steps). Per chunk the
//     block holds in shared memory, all bf16: (a) the 32 x 256 codebook
//     slice of those dimensions, (b) its queries' 32 values as a [query]
//     [dim] tile (the mma's row-major A operand, copied straight from the
//     prep kernel's bf16 queries), and (c) its rows' 32 values, decoded by
//     gathering from the staged slice with the row's code byte, as a
//     [row][dim] tile (the column-major B operand). The decoded tile lives
//     only in shared memory. Rows of the A and B tiles are skewed by 16 B,
//     so ldmatrix reads them without bank conflicts.
//   * (a) and (b) are double-buffered: cp.async copies the next chunk's
//     slices while this chunk decodes and multiplies, so the block waits
//     on L2 only for the first chunk (two barriers a chunk).
//   * A small prep kernel first rounds the queries to bf16 and lays the
//     codebook out per dimension (cbt[j][c] = cb[j / dsub][c][j % dsub],
//     256 slots, zero past K and past d), so each chunk's slice is one
//     contiguous 16 KB copy and codes >= K read zeros: no bounds checks in
//     the inner loops.
//   * Numerics are the TPU kernel's: bf16 operands, float32 sums. Every
//     output element is summed over the same chunks and k16 steps in the
//     same order wherever its row sits in a tile, so scanning a slice of
//     the codes gives exactly the full scan's values.
//   * Ragged edges are masked: query rows past Q and code rows past N are
//     staged as zeros and never written; no padding of the inputs. Code
//     bytes are read one at a time, so a slice may start at any row.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700 W power
// limit): 6.29 ms at the cell, 17 % of the bound, against 26.84 ms for the
// earlier float32 CUDA-core form of this kernel and 1.70 ms for a bf16
// matmul over rows decoded beforehand; PERF.md has the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 128;
constexpr int kTileN = 128;
constexpr int kChunk = 32;          // dimensions per staged chunk
constexpr int kPitch = kChunk + 8;  // bf16 per A / B tile row: 16 B skew
constexpr int kSlots = 256;  // codebook slots per dimension (one per byte)
constexpr int kWarpQ = 64;   // queries per warp (4 m16 tiles)
constexpr int kWarpN = 32;   // code rows per warp (4 n8 tiles)
// dynamic shared memory: two codebook slices, two query tiles, one
// decoded tile (62 KB)
constexpr int kCbBytes = kChunk * kSlots * 2;
constexpr int kABytes = kTileQ * kPitch * 2;
constexpr int kBBytes = kTileN * kPitch * 2;
constexpr int kSmemBytes = 2 * kCbBytes + 2 * kABytes + kBBytes;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 B from device memory to shared memory, asynchronously; zeros where
// !valid (nothing is read then).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// Four 8 x 8 b16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i, and each lane receives row lane / 4, columns
// 2 * (lane % 4) and +1 of every matrix.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.x4.m8n8.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c[16 x 8] += a[16 x 16] (row-major) * b[16 x 8] (column-major), bf16
// operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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
  // raw bf16 bits throughout: cb_s[2][kChunk][kSlots],
  // a_s[2][kTileQ][kPitch], b_s[kTileN][kPitch]
  extern __shared__ __align__(16) uint8_t smem[];
  auto cb_s = reinterpret_cast<uint16_t (*)[kChunk][kSlots]>(smem);
  auto a_s =
      reinterpret_cast<uint16_t (*)[kTileQ][kPitch]>(smem + 2 * kCbBytes);
  auto b_s = reinterpret_cast<uint16_t (*)[kPitch]>(smem + 2 * kCbBytes +
                                                    2 * kABytes);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wq = (warp >> 2) * kWarpQ;  // the warp's first query in the tile
  const int wn = (warp & 3) * kWarpN;   // the warp's first row in the tile
  const long long n0 = static_cast<long long>(blockIdx.x) * kTileN;
  const int q0 = blockIdx.y * kTileQ;

  // decode role: one row, half of each chunk's dimensions
  const int dn = tid & (kTileN - 1);
  const int dk0 = (tid >> 7) * (kChunk / 2);
  const bool row_ok = n0 + dn < N;
  const uint8_t* code_row =
      codes + (row_ok ? n0 + dn : 0) * static_cast<long long>(M);

  // ldmatrix roles: A rows (lane & 15) at dims (lane >> 4) * 8; B matrix
  // lane >> 3 of an x4 pair of n8 tiles: rows ((lane >> 4) * 8 +
  // (lane & 7)) at dims ((lane >> 3) & 1) * 8
  const int a_row = wq + (lane & 15);
  const int a_col = (lane >> 4) * 8;
  const uint16_t* b_frag =
      &b_s[wn + (lane >> 4) * 8 + (lane & 7)][((lane >> 3) & 1) * 8];

  // the codebook slice (contiguous in cbt) and the query values (16 B
  // per copy, zero past Q) of the chunk at k0, into buffer buf
  auto stage = [&](int k0, int buf) {
    const __nv_bfloat16* src = cbt + static_cast<long long>(k0) * kSlots;
#pragma unroll
    for (int i = 0; i < kCbBytes / 16 / kThreads; ++i) {
      const int e = (tid + i * kThreads) * 8;
      cp_async16(&cb_s[buf][0][0] + e, src + e, true);
    }
#pragma unroll
    for (int i = 0; i < kTileQ * kChunk * 2 / 16 / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx >> 2;
      const int s = (idx & 3) * 8;
      const bool ok = q0 + r < Q;
      cp_async16(&a_s[buf][r][s],
                 qb + static_cast<long long>(ok ? q0 + r : 0) * d_pad + k0 +
                     s,
                 ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    }
  }

  stage(0, 0);
  int buf = 0;
  for (int k0 = 0; k0 < d_pad; k0 += kChunk, buf ^= 1) {
    // this chunk's slices have landed, and every warp is done with the
    // previous chunk's b_s and its other buffer
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (k0 + kChunk < d_pad) stage(k0 + kChunk, buf ^ 1);
    {  // decode: b_s[row][dim] = staged slice at the row's code
      const int j = k0 + dk0;
      int m = j / dsub;
      int t = j - m * dsub;
      int code = (row_ok && m < M) ? __ldg(code_row + m) : 0;
      uint32_t h[kChunk / 4];
#pragma unroll
      for (int kk = 0; kk < kChunk / 2; ++kk) {
        const uint32_t v = cb_s[buf][dk0 + kk][code];
        if (kk & 1) {
          h[kk >> 1] |= v << 16;
        } else {
          h[kk >> 1] = v;
        }
        if (++t == dsub) {
          t = 0;
          ++m;
          code = (row_ok && m < M) ? __ldg(code_row + m) : 0;
        }
      }
      const uint4 w0 = row_ok ? make_uint4(h[0], h[1], h[2], h[3])
                              : make_uint4(0, 0, 0, 0);
      const uint4 w1 = row_ok ? make_uint4(h[4], h[5], h[6], h[7])
                              : make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(&b_s[dn][dk0]) = w0;
      *reinterpret_cast<uint4*>(&b_s[dn][dk0 + 8]) = w1;
    }
    __syncthreads();
    const uint16_t* a_frag = &a_s[buf][a_row][a_col];
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {  // n8 tiles 2p and 2p + 1
        uint32_t r[4];
        ldmatrix_x4(r, b_frag + p * 16 * kPitch + kk);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // m16 tile i
        uint32_t a[4];
        ldmatrix_x4(a, a_frag + i * 16 * kPitch + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
  }

  // accumulator fragment: rows lane / 4 and + 8 of each m16 tile, columns
  // 2 * (lane % 4) and + 1 of each n8 tile
  const int g = lane >> 2;
  const int c2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wq + i * 16 + h * 8 + g;
      if (q >= Q) continue;
      float* orow = out + static_cast<long long>(q) * N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long n = n0 + wn + j * 8 + c2;
        const float v0 = acc[i][j][2 * h];
        const float v1 = acc[i][j][2 * h + 1];
        if (vec_out && n + 1 < N) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < N) orow[n] = v0;
          if (n + 1 < N) orow[n + 1] = v1;
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
  // above 48 KB, dynamic shared memory has to be asked for
  err = cudaFuncSetAttribute(decode_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(static_cast<unsigned>((N + kTileN - 1) / kTileN),
            static_cast<unsigned>((Q + kTileQ - 1) / kTileQ));
  decode_scan_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(qb),
      static_cast<const uint8_t*>(codes),
      static_cast<const __nv_bfloat16*>(cbt), static_cast<float*>(out), Q, N,
      M, d_pad, dsub, N % 2 == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
