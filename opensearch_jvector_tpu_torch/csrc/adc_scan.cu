// Fused ADC scan for Hopper (sm_90a): PQ lookup-table accumulation over
// every code row of a segment.
//
//   out[q, n] = sum_m luts[q, m, codes[n, m]]
//   luts  [Q, M, K] float32 (K <= 256), codes [N, M] uint8, out [Q, N] float32
//
// Replaces: opensearch_jvector_tpu/ops/pallas/adc_kernel.py:fused_adc_scan
// (kernel body _adc_kernel). The TPU kernel turns each code column into a
// one-hot row and runs one [NB, K] x [K, QB] matmul per subspace, because a
// TPU gathers slowly. Hopper gathers from shared memory at full rate, so
// this kernel keeps the tables in shared memory and gathers one entry per
// code instead.
//
// What bounds it on an H100: not device memory. A [512, 2^18] scan reads
// N*M = 16.8 MB of codes and writes Q*N*4 = 537 MB of scores, about 0.17 ms
// at 3.35 TB/s. It does Q*N*M = 8.6e9 table lookups; shared memory serves
// 32 banks x 132 SMs per clock, and random codes put several lanes of a
// warp on one bank, so the lookups are the bound.
//
// What the design does about it:
//   * Tables are stored in bf16 (the TPU kernel's numerics), query-minor:
//     the G tables of a block's query group sit side by side for each
//     (subspace, code) entry, so one 8-byte shared load feeds G = 4
//     queries. A query's tables take M * 256 * 2 bytes (32 KB at M = 64),
//     so G = 4 uses 128 KB of the 227 KB a block may opt in to.
//   * Each thread owns one code row at a time, reads its M codes once
//     (4 per 32-bit load) and keeps the G sums in float32 registers.
//   * A block stages its tables once and then walks a long run of rows, so
//     the table traffic (G * M * K * 4 bytes of f32 per block) stays small
//     next to the code and score traffic.
//   * Every subspace gets 256 table slots (zero past K), so no code byte can
//     read outside the table: a code >= K adds 0, as the one-hot form does.
//   * Ragged edges are masked: no padding of N or Q to a block multiple.
// The one-hot wgmma form and fusing the score map, mask and top-r into the
// epilogue are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSlots = 256;  // table slots per subspace (one per code byte)

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

template <int G>
__device__ __forceinline__ void add_entry(const uint16_t* p, float* acc);

template <>
__device__ __forceinline__ void add_entry<4>(const uint16_t* p, float* acc) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  acc[0] += bf16_lo(w.x);
  acc[1] += bf16_hi(w.x);
  acc[2] += bf16_lo(w.y);
  acc[3] += bf16_hi(w.y);
}

template <>
__device__ __forceinline__ void add_entry<2>(const uint16_t* p, float* acc) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  acc[0] += bf16_lo(w);
  acc[1] += bf16_hi(w);
}

template <>
__device__ __forceinline__ void add_entry<1>(const uint16_t* p, float* acc) {
  acc[0] += __uint_as_float(static_cast<uint32_t>(*p) << 16);
}

template <int G, bool VEC4>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const float* __restrict__ luts,
                const uint8_t* __restrict__ codes,
                float* __restrict__ out,
                int Q, int M, int K, int N, int rows_per_block) {
  extern __shared__ __align__(16) uint16_t lut_s[];

  // Stage the query group's tables: lut_s[(m * 256 + k) * G + g].
  const int q0 = blockIdx.y * G;
  const int slots = M * kSlots;
  for (int i = threadIdx.x; i < G * slots; i += blockDim.x) {
    const int g = i / slots;
    const int r = i - g * slots;
    const int m = r / kSlots;
    const int k = r - m * kSlots;
    const int q = q0 + g;
    const float v = (q < Q && k < K)
        ? luts[(static_cast<size_t>(q) * M + m) * K + k] : 0.0f;
    lut_s[r * G + g] = __bfloat16_as_ushort(__float2bfloat16(v));
  }
  __syncthreads();

  const long long n_begin = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long n_stop = n_begin + rows_per_block;
  const long long n_end = n_stop < N ? n_stop : static_cast<long long>(N);
  for (long long n = n_begin + threadIdx.x; n < n_end; n += blockDim.x) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
    const uint8_t* row = codes + n * M;
    if (VEC4) {
      const uint32_t* row4 = reinterpret_cast<const uint32_t*>(row);
      for (int w = 0; w < M / 4; ++w) {
        const uint32_t c4 = __ldg(row4 + w);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int m = 4 * w + b;
          const int c = (c4 >> (8 * b)) & 0xff;
          add_entry<G>(lut_s + (m * kSlots + c) * G, acc);
        }
      }
    } else {
      for (int m = 0; m < M; ++m) {
        add_entry<G>(lut_s + (m * kSlots + __ldg(row + m)) * G, acc);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (q0 + g < Q) out[static_cast<size_t>(q0 + g) * N + n] = acc[g];
    }
  }
}

template <int G>
cudaError_t launch(const float* luts, const uint8_t* codes, float* out,
                   int Q, int M, int K, int N, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * kSlots * G * sizeof(uint16_t);
  const bool vec4 = (M % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(codes) % 4 == 0);
  auto kernel = vec4 ? adc_scan_kernel<G, true> : adc_scan_kernel<G, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0;
  int sms = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;

  // Split N into as few row runs as keep about four waves of blocks in
  // flight: every block re-stages its tables, so fewer, longer runs.
  const long long q_groups = (Q + G - 1) / G;
  const long long tiles = (static_cast<long long>(N) + kThreads - 1) / kThreads;
  long long chunks = (4LL * sms + q_groups - 1) / q_groups;
  if (chunks > tiles) chunks = tiles;
  if (chunks < 1) chunks = 1;
  const long long tiles_per_chunk = (tiles + chunks - 1) / chunks;
  chunks = (tiles + tiles_per_chunk - 1) / tiles_per_chunk;
  const int rows_per_block = static_cast<int>(tiles_per_chunk * kThreads);

  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(q_groups));
  kernel<<<grid, kThreads, smem, stream>>>(luts, codes, out, Q, M, K, N,
                                           rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). `group` is the number of
// queries sharing one block (4, 2 or 1; the caller picks the largest whose
// tables fit in shared memory). Launches on `stream`, does not synchronise,
// and returns the cudaError_t of the launch (0 on success).
extern "C" int adc_scan_launch(const void* luts, const void* codes, void* out,
                               int Q, int M, int K, int N, int group,
                               void* stream) {
  const float* l = static_cast<const float*>(luts);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4: return static_cast<int>(launch<4>(l, c, o, Q, M, K, N, s));
    case 2: return static_cast<int>(launch<2>(l, c, o, Q, M, K, N, s));
    case 1: return static_cast<int>(launch<1>(l, c, o, Q, M, K, N, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
