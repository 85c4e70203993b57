// Fused ADC scan for Hopper (sm_90a): PQ lookup-table accumulation over
// every code row of a segment, with the score map and the validity mask
// in the epilogue.
//
//   v[q, n]   = sum_m luts[q, m, codes[n, m]]   (m = 0 .. M-1, in order)
//   out[q, n] = -inf                 where valid[n] is false, else
//               v                    (mode 0, raw)
//               1 / (1 + v)          (mode 1, euclidean)
//               (1 + v) / 2          (mode 2, dot product and cosine)
//   luts [Q, M, K] float32 (K <= 256), codes [N, M] uint8, valid [N] bool
//   (or null), out [Q, N] float32
//
// Replaces: opensearch_jvector_tpu/ops/pallas/adc_kernel.py:fused_adc_scan
// (kernel body _adc_kernel). The TPU kernel turns each code column into a
// one-hot row and runs one [NB, K] x [K, QB] matmul per subspace, because a
// TPU gathers slowly. Hopper gathers from shared memory, so this kernel
// keeps the tables in shared memory and gathers one entry per code.
//
// What bounds it on an H100: not device memory. A [512, 2^18] scan reads
// N*M = 16.8 MB of codes and writes Q*N*4 = 537 MB of scores, about
// 0.17 ms at 3.35 TB/s. It does Q*N*M = 8.6e9 table lookups, all through
// the SM's shared-memory pipe, which issues about one wavefront a cycle.
// A warp's 8-byte table gather (one entry for 4 queries) is served half a
// warp at a time over 16 bank pairs; random codes put about 3 lanes of a
// half-warp on one pair, so a gather costs about 6 wavefronts for 128
// lookups: ~24 wavefronts per 512 lookups. That is the bound of this form
// (~2 ms at the [512, 2^18] cell on 132 SMs). The code loads add about 4
// wavefronts per 512 lookups, the table staging and the epilogue little.
//
// What the design does about it:
//   * A prep kernel lays the tables out once per call as bf16 (the TPU
//     kernel's numerics) [ceil(Q/G), M, 256, G], query-minor, zero past K
//     and past Q: the G tables of a query group sit side by side for each
//     (subspace, code), so one shared load feeds G queries (an 8-byte load
//     at G = 4), and a block stages its group with one contiguous copy of
//     16-byte cp.async (no per-element conversion or divides). A query's
//     tables take M * 256 * 2 bytes (32 KB at M = 64); G = 4 uses 128 KB of
//     the 227 KB a block may opt in to. The caller picks G from Q as well:
//     one query stages 32 KB, not 128 KB.
//   * Each thread owns one code row at a time and reads it in 16-byte
//     vectors (16 codes; 4-byte or 1-byte where the rows are not 16-byte
//     aligned), always one vector ahead, so the load of the next 16 codes
//     (or of its next row's first 16) is in flight while these are summed.
//     A warp's 16-byte load brings 512 codes from 16 lines; 4-byte loads
//     would need four such requests for the same codes.
//   * The G sums stay in float32 registers and run over m = 0 .. M-1 in
//     order whatever the load width, so a slice of the codes gives exactly
//     the full scan's values.
//   * Every subspace gets 256 table slots (zero past K), so no code byte
//     can read outside the table: a code >= K adds 0, as the one-hot form
//     does. Ragged edges are masked: no padding of N or Q.
//   * The epilogue maps the sum (IEEE division; the library is built
//     without fast math) and writes -inf for rows whose valid byte is 0, so
//     the [Q, N] slab is written once, already scored and masked.
//
// Forms ruled out, by reckoning at the cell:
//   * the TPU's one-hot tensor-core form costs 2 * K = 512 operations per
//     lookup, 4.4e15 in all: 4.4 ms at the bf16 peak, slower than this;
//   * a conflict-free form with one query per lane needs at least 32
//     queries' tables of one subspace at once, more than 227 KB at M = 64;
//     re-staging them costs about a byte of L2 traffic per lookup (~8.6 GB).
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700 W power
// limit): 1.85-1.87 ms raw and 0.003 ms more fused at the cell, 9.4 % of
// the byte bound, against 13.65 ms for a summing embedding_bag. Launch shape, tuned
// on the same card: 512 and 1024 threads a block tie, 256 lose 0.08 ms in
// the fused mode; the row split matters only where it leaves a partial
// wave (Q=128 over 2^20 codes: 2.93 ms at one wave, 1.82 ms with the split
// below). PERF.md has the numbers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int kThreads = 512;  // threads per scan block
constexpr int kWaves = 8;  // most waves of resident blocks a launch takes
constexpr int kSlots = 256;  // table slots per subspace (one per code byte)
constexpr int kPrepThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// lb[qg][m][k][g] = bf16(luts[qg * G + g][m][k]), zero past K and past Q;
// `entries` = ceil(Q / G) * M * 256, one thread per (qg, m, k).
template <int G>
__global__ void adc_prep_kernel(const float* __restrict__ luts,
                                uint16_t* __restrict__ lb,
                                int Q, int M, int K, long long entries) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < entries; i += stride) {
    const int k = static_cast<int>(i & (kSlots - 1));
    const int r = static_cast<int>(i >> 8);  // qg * M + m
    const int qg = r / M;
    const int m = r - qg * M;
    uint32_t h[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int q = qg * G + g;
      h[g] = bf16_bits((q < Q && k < K)
                           ? luts[(static_cast<long long>(q) * M + m) * K + k]
                           : 0.0f);
    }
    if constexpr (G == 4) {
      reinterpret_cast<uint2*>(lb)[i] =
          make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
    } else if constexpr (G == 2) {
      reinterpret_cast<uint32_t*>(lb)[i] = h[0] | (h[1] << 16);
    } else {
      lb[i] = static_cast<uint16_t>(h[0]);
    }
  }
}

// acc[g] += entry p's value for query g of the group.
template <int G>
__device__ __forceinline__ void add_entry(const uint16_t* p, float* acc) {
  if constexpr (G == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    acc[0] += bf16_lo(w.x);
    acc[1] += bf16_hi(w.x);
    acc[2] += bf16_lo(w.y);
    acc[3] += bf16_hi(w.y);
  } else if constexpr (G == 2) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    acc[0] += bf16_lo(w);
    acc[1] += bf16_hi(w);
  } else {
    acc[0] += __uint_as_float(static_cast<uint32_t>(*p) << 16);
  }
}

// A row is read W codes at a time: a 16-byte, 4-byte or 1-byte vector.
template <int W> struct Vec;
template <> struct Vec<16> { using T = uint4; };
template <> struct Vec<4> { using T = uint32_t; };
template <> struct Vec<1> { using T = uint8_t; };

__device__ __forceinline__ int code_of(const uint4& v, int b) {
  const uint32_t w = b < 4 ? v.x : b < 8 ? v.y : b < 12 ? v.z : v.w;
  return static_cast<int>((w >> (8 * (b & 3))) & 0xffu);
}

__device__ __forceinline__ int code_of(uint32_t v, int b) {
  return static_cast<int>((v >> (8 * b)) & 0xffu);
}

__device__ __forceinline__ int code_of(uint8_t v, int) {
  return static_cast<int>(v);
}

__device__ __forceinline__ float score_of(float v, int mode) {
  if (mode == 1) return 1.0f / (1.0f + v);
  if (mode == 2) return (1.0f + v) / 2.0f;
  return v;
}

// Grid: x = runs of rows_per_block code rows, y = query groups of G.
template <int G, int W>
__global__ void __launch_bounds__(kThreads)
adc_scan_kernel(const uint16_t* __restrict__ lb,
                const uint8_t* __restrict__ codes,
                const uint8_t* __restrict__ valid,
                float* __restrict__ out,
                int Q, int M, int N, int rows_per_block, int mode) {
  using T = typename Vec<W>::T;
  extern __shared__ __align__(16) uint16_t lut_s[];

  // Stage the group's tables: one contiguous run of M * 256 * G bf16.
  const int q0 = blockIdx.y * G;
  {
    const int bytes = M * kSlots * G * 2;
    const uint8_t* src = reinterpret_cast<const uint8_t*>(lb) +
                         static_cast<long long>(blockIdx.y) * bytes;
    uint8_t* dst = reinterpret_cast<uint8_t*>(lut_s);
    for (int off = threadIdx.x * 16; off < bytes; off += kThreads * 16) {
      cp_async16(dst + off, src + off);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }

  const long long n_stop =
      static_cast<long long>(blockIdx.x) * rows_per_block + rows_per_block;
  const long long n_end = n_stop < N ? n_stop : static_cast<long long>(N);
  long long n = static_cast<long long>(blockIdx.x) * rows_per_block +
                threadIdx.x;
  if (n >= n_end) return;
  const int vecs = M / W;  // vectors per row
  const T* rows = reinterpret_cast<const T*>(codes);
  const int group_stride = kSlots * G;  // bf16 per subspace's table

  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  T cur = __ldg(rows + n * vecs);
  const uint16_t* tab = lut_s;  // the table of the vector's first subspace
  int c = 0;
  for (;;) {
    // issue the next vector's load (this row's next, or the next row's
    // first) before summing this one
    int c_next = c + 1;
    long long n_next = n;
    if (c_next == vecs) {
      c_next = 0;
      n_next = n + kThreads;
    }
    T nxt = T();
    if (n_next < n_end) nxt = __ldg(rows + n_next * vecs + c_next);
#pragma unroll
    for (int b = 0; b < W; ++b) {
      add_entry<G>(tab + b * group_stride + code_of(cur, b) * G, acc);
    }
    tab += W * group_stride;
    if (c_next == 0) {  // row n is summed: score, mask, store
      const bool ok = valid == nullptr || valid[n] != 0;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (q0 + g < Q) {
          out[static_cast<long long>(q0 + g) * N + n] =
              ok ? score_of(acc[g], mode) : __uint_as_float(0xff800000u);
        }
        acc[g] = 0.0f;
      }
      tab = lut_s;
      if (n_next >= n_end) break;
    }
    n = n_next;
    c = c_next;
    cur = nxt;
  }
}

template <int G>
cudaError_t prep(const float* luts, uint16_t* lb, int Q, int M, int K,
                 cudaStream_t stream) {
  const long long entries =
      static_cast<long long>((Q + G - 1) / G) * M * kSlots;
  long long blocks = (entries + kPrepThreads - 1) / kPrepThreads;
  if (blocks > 8192) blocks = 8192;
  adc_prep_kernel<G><<<static_cast<unsigned>(blocks), kPrepThreads, 0,
                       stream>>>(luts, lb, Q, M, K, entries);
  return cudaGetLastError();
}

// The current device's SM count and how many blocks of scan instantiation
// <G, W> with `smem` bytes of tables fit on one SM. Looked up once per
// (device, smem) and kept, so a launch makes no query of the driver after
// the first; the kernel is opted in to a larger dynamic shared memory only
// when a launch on that device needs more than any before it.
template <int G, int W>
cudaError_t residency(int smem, int* sms, int* per_sm) {
  struct Seen {
    int device, smem, sms, per_sm;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  static std::vector<int> opted_in;  // per device: the largest smem set
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen) {
    if (s.device == device && s.smem == smem) {
      *sms = s.sms;
      *per_sm = s.per_sm;
      return cudaSuccess;
    }
  }
  auto kernel = adc_scan_kernel<G, W>;
  if (static_cast<int>(opted_in.size()) <= device) {
    opted_in.resize(device + 1, 0);
  }
  if (smem > opted_in[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in[device] = smem;
  }
  Seen s{device, smem, 0, 0};
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (s.per_sm < 1) s.per_sm = 1;
  seen.push_back(s);
  *sms = s.sms;
  *per_sm = s.per_sm;
  return cudaSuccess;
}

template <int G, int W>
cudaError_t scan(const uint16_t* lb, const uint8_t* codes,
                 const uint8_t* valid, float* out, int Q, int M, int N,
                 int mode, cudaStream_t stream) {
  const int smem = M * kSlots * G * 2;
  int sms = 0;
  int per_sm = 0;
  const cudaError_t err = residency<G, W>(smem, &sms, &per_sm);
  if (err != cudaSuccess) return err;

  // Split N into runs of whole tiles (kThreads rows, one a thread). The
  // runs x query-group blocks go in waves of `resident` blocks, and a wave
  // lasts as long as its longest block, so take the split into at most
  // kWaves waves (more where the query groups alone fill more) that
  // minimises waves x tiles per run; among equals the fewest runs, since
  // every block stages its tables once. For w waves the most runs that fit
  // give the fewest tiles per run, so those splits are the only candidates.
  const long long q_groups = (Q + G - 1) / G;
  const long long resident = static_cast<long long>(sms) * per_sm;
  const long long tiles = (static_cast<long long>(N) + kThreads - 1) / kThreads;
  long long runs = 1;
  long long tiles_per_run = tiles;
  long long best = -1;
  const long long w_max = kWaves + (q_groups + resident - 1) / resident;
  for (long long w = 1; w <= w_max; ++w) {
    long long r = w * resident / q_groups;
    if (r > tiles) r = tiles;
    if (r < 1) r = 1;
    const long long per = (tiles + r - 1) / r;
    const long long used = (tiles + per - 1) / per;
    const long long cost = (used * q_groups + resident - 1) / resident * per;
    if (best < 0 || cost < best) {
      best = cost;
      runs = used;
      tiles_per_run = per;
    }
  }
  const int rows_per_block = static_cast<int>(tiles_per_run * kThreads);

  dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(q_groups));
  adc_scan_kernel<G, W><<<grid, kThreads, smem, stream>>>(
      lb, codes, valid, out, Q, M, N, rows_per_block, mode);
  return cudaGetLastError();
}

template <int G>
cudaError_t scan_any_width(const uint16_t* lb, const uint8_t* codes,
                           const uint8_t* valid, float* out, int Q, int M,
                           int N, int mode, cudaStream_t stream) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
  if (M % 16 == 0 && at % 16 == 0) {
    return scan<G, 16>(lb, codes, valid, out, Q, M, N, mode, stream);
  }
  if (M % 4 == 0 && at % 4 == 0) {
    return scan<G, 4>(lb, codes, valid, out, Q, M, N, mode, stream);
  }
  return scan<G, 1>(lb, codes, valid, out, Q, M, N, mode, stream);
}

bool args_ok(int Q, int M, int K, int group) {
  return Q > 0 && M > 0 && K > 0 && K <= kSlots &&
         (group == 1 || group == 2 || group == 4);
}

}  // namespace

// Plain C entry points (loaded with ctypes). `group` is the number of
// queries sharing one block (4, 2 or 1; the caller picks it from Q and M).
// `lb` is scratch the caller allocates: ceil(Q / group) * M * 256 * group
// bf16. Each launches on `stream`, does not synchronise, and returns the
// cudaError_t of its launches (0 on success).

// The prep kernel alone: lb = the bf16 table layout.
extern "C" int adc_prep_launch(const void* luts, void* lb, int Q, int M,
                               int K, int group, void* stream) {
  if (!args_ok(Q, M, K, group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* l = static_cast<const float*>(luts);
  uint16_t* b = static_cast<uint16_t*>(lb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4: return static_cast<int>(prep<4>(l, b, Q, M, K, s));
    case 2: return static_cast<int>(prep<2>(l, b, Q, M, K, s));
    default: return static_cast<int>(prep<1>(l, b, Q, M, K, s));
  }
}

// The prep kernel, then the scan. `mode`: 0 raw sums, 1 euclidean
// 1 / (1 + v), 2 dot product / cosine (1 + v) / 2. `valid` (N bytes, 0 or
// 1) may be null: no row is masked.
extern "C" int adc_scan_launch(const void* luts, const void* codes,
                               const void* valid, void* lb, void* out, int Q,
                               int M, int K, int N, int group, int mode,
                               void* stream) {
  if (!args_ok(Q, M, K, group) || N <= 0 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = adc_prep_launch(luts, lb, Q, M, K, group, stream);
  if (err != 0) return err;
  const uint16_t* b = static_cast<const uint16_t*>(lb);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (group) {
    case 4:
      return static_cast<int>(scan_any_width<4>(b, c, v, o, Q, M, N, mode, s));
    case 2:
      return static_cast<int>(scan_any_width<2>(b, c, v, o, Q, M, N, mode, s));
    default:
      return static_cast<int>(scan_any_width<1>(b, c, v, o, Q, M, N, mode, s));
  }
}
