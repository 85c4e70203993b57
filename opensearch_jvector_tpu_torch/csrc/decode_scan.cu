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
// 989 TFLOP/s bf16 tensor-core peak. The bytes it must move take 0.66 ms
// at 3.35 TB/s, nearly all of it the [Q, N] float32 slab (2.15 GB, 0.64
// ms; 67 MB of codes). Inside the card two more resources are near their
// limits: L2 (each tile re-reads its queries' and the codebook's slices)
// and shared memory (the decode's gathers sit beside the products'
// operand reads).
//
// What the design does about it (warp-specialised, one persistent block
// per SM walking 256-query x 128-row output tiles, 512 threads):
//   * Products: two consumer warpgroups issue wgmma.mma_async m64n128k16
//     (bf16 operands, float32 accumulators), both operands in shared
//     memory, K-major with the 128-byte swizzle, so the tensor cores read
//     them without bank conflicts. A warpgroup owns 128 queries (two m64
//     tiles) x 128 rows: 128 accumulators a thread. setmaxnreg gives the
//     consumers 184 registers and the decode warps 72.
//   * Each row is decoded Q / 256 times (twice at Q = 512), not Q / 128.
//   * The dimension runs in chunks of 64 (one swizzle row of bf16, four
//     k16 steps), through a ring of 3 stages. A stage holds the queries'
//     chunk (one TMA box [256, 64] of the prep kernel's bf16 queries; rows
//     past Q and columns past d_pad arrive as zeros) and the decoded tile
//     [128, 64]. Per stage a full mbarrier for each half and one empty
//     mbarrier, which the consumers release once their products have read
//     the stage; no __syncthreads after setup.
//   * Two decode warpgroups: a thread owns one row and half of each chunk
//     (16 dimension pairs). They gather from the chunk's codebook slice
//     (a bulk copy in a ring of 2, issued 2 chunks ahead) into the next
//     free stage while the consumers run wgmma on the stages before, so
//     the decode and the product overlap. Thread 0 of the decode warps
//     issues every copy.
//   * A small prep kernel first rounds the queries to bf16 and lays the
//     codebook out per dimension pair (cbt word [j / 2][c] = the bf16
//     values of dims j and j + 1 at code c, zero past K and past d), so a
//     chunk's slice is one contiguous copy and one 4-byte gather decodes
//     two dimensions. Which subspace each pair reads (and whether a pair
//     straddles two, for odd dsub, and takes a second gather) is a 32-bit
//     mask computed once a chunk; it is the same for every row, so each
//     choice is uniform across a warp and the gathers of a chunk are
//     independent of each other. dsub stays out of the inner loop.
//   * The tile's code bytes are staged in shared memory once a tile
//     (coalesced loads; rows padded to an odd number of words, so a warp's
//     32 rows read 32 banks) for M <= 128; above that each code is read
//     from global memory (a second instantiation of the kernel). Codes are
//     never loaded by TMA: a slice of the codes may start at any row.
//   * Numerics are the TPU kernel's: bf16 operands, float32 sums. Every
//     output element is summed over the same chunks and k16 steps in the
//     same order wherever its row sits in a tile, so scanning a slice of
//     the codes gives exactly the full scan's values.
//   * Ragged edges: rows past N decode to zeros and are never written.
//     Output pairs are stored as float2 (streaming stores) where N is
//     even.
//   * Every mbarrier wait gives up after about 2 s with a trap, so a fault
//     in the pipeline ends the launch with an error instead of hanging.
//
// What is left on the table: the gathers' bank conflicts (random codes,
// about three wavefronts a gather) and the stores of the slab, which the
// epilogue does not overlap with the next tile's products. chip_smoke.py
// phases 2-3 print the registers, the HGMMA count and the time at the
// cell beside the bound; PERF.md keeps the numbers.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up
                   // in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kTileQ = 256;  // queries a tile: 2 warpgroups x 2 m64 tiles
constexpr int kTileN = 128;  // code rows a tile: the wgmma's n
constexpr int kChunk = 64;   // dimensions a stage: 128 B of bf16
constexpr int kPairs = kChunk / 2;
constexpr int kSlots = 256;  // codebook slots a dimension (one a byte)
constexpr int kStages = 3;    // queries' chunks and decoded tiles
constexpr int kCbStages = 2;  // codebook slices
constexpr int kConsumerWarps = 8;
constexpr int kDecodeWarps = 8;
constexpr int kThreads = (kConsumerWarps + kDecodeWarps) * 32;
// registers a thread after setmaxnreg: the block keeps the registers it
// was launched with (65,536 / kThreads a thread, rounded down to 8), and
// the decode warpgroup hands some of its share to the consumers
constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
constexpr int kConsumerRegs = 184;
constexpr int kDecodeRegs = 72;
static_assert(kConsumerWarps * kConsumerRegs + kDecodeWarps * kDecodeRegs <=
                  (kConsumerWarps + kDecodeWarps) * kEntryRegs,
              "setmaxnreg would wait forever for registers");
constexpr int kQBytes = kTileQ * kChunk * 2;   // 32 KB
constexpr int kCbBytes = kPairs * kSlots * 4;  // 32 KB
constexpr int kDBytes = kTileN * kChunk * 2;   // 16 KB
constexpr int kQOff = 0;
constexpr int kCbOff = kQOff + kStages * kQBytes;
constexpr int kDOff = kCbOff + kCbStages * kCbBytes;
constexpr int kBarOff = kDOff + kStages * kDBytes;
constexpr int kBars = 3 * kStages + kCbStages;
constexpr int kCodesOff = kBarOff + 8 * kBars;
// the tile's codes are staged in shared memory up to this M (a row of
// 132 bytes at most)
constexpr int kMaxStagedM = 128;
// + 1 KB to align the tiles to the swizzle's 1,024-byte atoms
constexpr int kSmemBytes = 1024 + kCodesOff;
constexpr int kStagedSmemBytes = kSmemBytes + kTileN * (kMaxStagedM + 4);
// about 2 s at the H100's clocks
constexpr long long kWaitLimitCycles = 4000000000ll;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// one arrival that also tells the barrier to expect `bytes` of copies
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if ((tries & 63) == 63) {
      const long long now = clock64();
      if (start == 0) {
        start = now;
      } else if (now - start > kWaitLimitCycles) {
        __trap();
      }
    }
  }
}

// TMA: a 2D box of `map` at (c0, c1) into shared memory, completing on bar
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1)
      : "memory");
}

// a contiguous bulk copy (16-byte multiples) into shared memory
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 B, 8-row atoms 1,024 B apart (SBO), the atom 1,024-byte aligned
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d[64 x 128] += a[64 x 16] * b[16 x 128]: bf16 operands from shared
// memory (descriptors), float32 accumulators, asynchronous.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// qb[q][j] = bf16(q_c[q][j]) (zero for j >= d), [Q, d_pad];
// cbt, d_pad / 2 rows of 256 words: word [p][c] holds bf16(cb[j / dsub]
// [c][j % dsub]) for j = 2p (low half) and j = 2p + 1 (high half), zero
// for c >= K or j >= d.
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
      const int p = static_cast<int>(r / (2 * kSlots));
      const int rem = static_cast<int>(r - static_cast<long long>(p) * 2 *
                                               kSlots);
      const int c = rem >> 1;
      const int j = 2 * p + (rem & 1);
      float v = 0.0f;
      if (j < d && c < K) {
        const int m = j / dsub;
        v = cb[(static_cast<long long>(m) * K + c) * dsub + (j - m * dsub)];
      }
      cbt[r] = __float2bfloat16(v);
    }
  }
}

// the decode warpgroups' own barrier
__device__ __forceinline__ void decode_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kDecodeWarps * 32) : "memory");
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, 1)
decode_scan_kernel(__grid_constant__ const CUtensorMap qmap,
                   const uint8_t* __restrict__ codes,
                   const uint8_t* __restrict__ cbt,
                   float* __restrict__ out,
                   int Q, int N, int M, int d_pad, int dsub, int vec_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  // barriers: q_full, d_full, empty [kStages]; cb_full [kCbStages]
  const uint32_t q_full = base + kBarOff;
  const uint32_t d_full = q_full + 8 * kStages;
  const uint32_t empty = d_full + 8 * kStages;
  const uint32_t cb_full = empty + 8 * kStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nk = (d_pad + kChunk - 1) / kChunk;  // chunks a tile
  const int qtiles = (Q + kTileQ - 1) / kTileQ;
  const long long tiles =
      ((static_cast<long long>(N) + kTileN - 1) / kTileN) * qtiles;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(d_full + 8 * s, kDecodeWarps * 32);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    for (int s = 0; s < kCbStages; ++s) mbar_init(cb_full + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- decode (and every copy): one row and half a chunk a thread ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(kDecodeRegs));
    const int dw = warp - kConsumerWarps;
    const int r = (dw & 3) * 32 + lane;  // row in the tile
    const int half = dw >> 2;            // which 32 of a chunk's dims
    const bool issuer = dw == 0 && lane == 0;  // issues every copy
    const long long my_tiles =
        (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const long long chunks = my_tiles * nk;
    // the codebook slice of chunk c into stage s (only the pairs below
    // d_pad: the copy never reads past cbt)
    auto load_cb = [&](int s, int c) {
      const int pairs = min(kPairs, (d_pad - c * kChunk) / 2);
      const uint32_t bytes = static_cast<uint32_t>(pairs) * kSlots * 4;
      mbar_expect_tx(cb_full + 8 * s, bytes);
      bulk_load(base + kCbOff + s * kCbBytes,
                cbt + static_cast<long long>(c) * kPairs * kSlots * 4, bytes,
                cb_full + 8 * s);
    };
    if (issuer) {
      for (int s = 0; s < kCbStages && s < chunks; ++s) load_cb(s, s % nk);
    }
    // the tile's code bytes, when staged: row r at r * cstride, an odd
    // number of words, so a warp's 32 rows read 32 banks
    uint8_t* codes_s = smem + kCodesOff;
    int cstride = (M + 3) & ~3;
    if (((cstride >> 2) & 1) == 0) cstride += 4;
    const int dtid = dw * 32 + lane;
    int s = 0, scb = 0;
    uint32_t ph = 0, pcb = 0;
    long long g = 0;  // this block's chunks so far
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int q0 = static_cast<int>(tile % qtiles) * kTileQ;
      const long long n0 = (tile / qtiles) * kTileN;
      const bool row_ok = n0 + r < N;
      const uint8_t* grow = codes + (row_ok ? n0 + r : 0) *
                                        static_cast<long long>(M);
      const uint8_t* crow = codes_s + r * cstride;
      if (kStaged) {  // coalesced, 4 bytes a load where the slice allows
        decode_sync();  // every decode thread is done with the last tile's
        const uint8_t* src = codes + n0 * M;
        const int bytes =
            static_cast<int>(min(static_cast<long long>(kTileN), N - n0)) * M;
        if (((reinterpret_cast<uintptr_t>(src) | M) & 3) == 0) {
          const int mw = M >> 2;
          for (int i = dtid; i < bytes >> 2; i += kDecodeWarps * 32) {
            const int row = i / mw;
            *reinterpret_cast<uint32_t*>(codes_s + row * cstride +
                                         (i - row * mw) * 4) =
                __ldg(reinterpret_cast<const uint32_t*>(src) + i);
          }
        } else {
          for (int i = dtid; i < bytes; i += kDecodeWarps * 32) {
            const int row = i / M;
            codes_s[row * cstride + i - row * M] = __ldg(src + i);
          }
        }
        decode_sync();
      }
      // the code of subspace mi of this thread's row (zero past M)
      auto code_of = [&](int mi) -> uint32_t {
        if (mi >= M) return 0;
        if (kStaged) return crow[mi];
        return row_ok ? __ldg(grow + mi) : 0;
      };
      for (int c = 0; c < nk; ++c, ++g) {
        // the consumers are done with stage s: the queries' chunk in
        // first, then the decode
        mbar_wait(empty + 8 * s, ph ^ 1);
        if (issuer) {
          mbar_expect_tx(q_full + 8 * s, kQBytes);
          tma_load_2d(base + kQOff + s * kQBytes, &qmap, q_full + 8 * s,
                      c * kChunk, q0);
        }
        mbar_wait(cb_full + 8 * scb, pcb);
        // this half's 16 pairs of the codebook slice
        const uint32_t* cbw =
            reinterpret_cast<const uint32_t*>(smem + kCbOff + scb * kCbBytes) +
            half * (kPairs / 2) * kSlots;
        uint8_t* drow = smem + kDOff + s * kDBytes + r * 128;
        const int j0 = c * kChunk + half * (kChunk / 2);
        const int groups = min(kChunk / 2, d_pad - j0) / 8;  // may be <= 0
        // bit i of `last`: dim j0 + i ends its subspace (the same for every
        // row, so every choice below is uniform across the warp)
        const int m0 = j0 / dsub;
        uint32_t last = 0;
        for (int b = dsub - 1 - (j0 - m0 * dsub); b < 32; b += dsub) {
          last |= 1u << b;
        }
#pragma unroll
        for (int gi = 0; gi < kChunk / 16; ++gi) {
          uint4 w = make_uint4(0, 0, 0, 0);
          if (gi < groups) {
            uint32_t h[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int p = gi * 4 + e;  // dims j0 + 2p and j0 + 2p + 1
              const int mlo = m0 + __popc(last & ((1u << (2 * p)) - 1));
              uint32_t v = cbw[p * kSlots + code_of(mlo)];
              if ((last >> (2 * p)) & 1) {  // the pair spans two subspaces
                v = __byte_perm(v, cbw[p * kSlots + code_of(mlo + 1)],
                                0x7610);
              }
              h[e] = v;
            }
            if (row_ok) w = make_uint4(h[0], h[1], h[2], h[3]);
          }
          // 16-byte group of the row, swizzled as wgmma reads it
          const int grp = half * 4 + gi;
          *reinterpret_cast<uint4*>(drow + ((grp ^ (r & 7)) << 4)) = w;
        }
        // the decoded tile is read by the tensor cores (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(d_full + 8 * s);
        // every decode warp is done with this codebook stage: refill it
        decode_sync();
        if (issuer && g + kCbStages < chunks) {
          load_cb(scb, (c + kCbStages) % nk);
        }
        if (++scb == kCbStages) {
          scb = 0;
          pcb ^= 1;
        }
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: wgmma over the ring, then the epilogue --------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(kConsumerRegs));
    const int wg = warp >> 2;  // the warpgroup's 128 queries of the tile
    const int wq = warp & 3;   // the warp's 16 rows of each m64 tile
    float acc[2][64];
    int s = 0, prev = 0;
    uint32_t ph = 0;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int q0 = static_cast<int>(tile % qtiles) * kTileQ;
      const long long n0 = (tile / qtiles) * kTileN;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        acc[0][i] = 0.0f;
        acc[1][i] = 0.0f;
      }
      for (int c = 0; c < nk; ++c) {
        mbar_wait(q_full + 8 * s, ph);
        mbar_wait(d_full + 8 * s, ph);
        __syncwarp();  // the warpgroup's products need converged warps
        const uint32_t a = base + kQOff + s * kQBytes + wg * 128 * 128;
        const uint32_t b = base + kDOff + s * kDBytes;
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk) {
          const uint64_t db = sw128_desc(b + kk * 32);
          wgmma_m64n128k16(acc[0], sw128_desc(a + kk * 32), db);
          wgmma_m64n128k16(acc[1], sw128_desc(a + 64 * 128 + kk * 32), db);
        }
        wgmma_commit();
        fence_acc(acc[0]);
        fence_acc(acc[1]);
        if (c > 0) {  // the chunk before has been read: release it
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = s;
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (lane == 0) mbar_arrive(empty + 8 * prev);
      // accumulator fragment of m64 tile mt: rows wq * 16 + lane / 4 (+ 8),
      // columns 8i + 2 * (lane % 4) and + 1 of each n8 block i
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int q = q0 + wg * 128 + mt * 64 + wq * 16 + (lane >> 2) +
                        h * 8;
          if (q >= Q) continue;
          float* orow = out + static_cast<long long>(q) * N;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const long long n = n0 + i * 8 + (lane & 3) * 2;
            const float v0 = acc[mt][4 * i + 2 * h];
            const float v1 = acc[mt][4 * i + 2 * h + 1];
            if (vec_out && n + 1 < N) {
              __stcs(reinterpret_cast<float2*>(orow + n),
                     make_float2(v0, v1));
            } else {
              if (n < N) __stcs(orow + n, v0);
              if (n + 1 < N) __stcs(orow + n + 1, v1);
            }
          }
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the process has already loaded
// (no link against it)
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
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
  const int d_pad = (d + 31) / 32 * 32;
  const long long total = static_cast<long long>(Q) * d_pad +
                          static_cast<long long>(d_pad) * kSlots;
  long long blocks = (total + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  prep_kernel<<<static_cast<unsigned>(blocks), 256, 0, s>>>(
      static_cast<const float*>(q_c), static_cast<const float*>(codebooks),
      static_cast<__nv_bfloat16*>(qb), static_cast<__nv_bfloat16*>(cbt), Q, d,
      d_pad, K, dsub);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const EncodeTiled encode = encoder();
  if (encode == nullptr) {
    return static_cast<int>(cudaErrorSharedObjectInitFailed);
  }
  CUtensorMap qmap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d_pad),
                              static_cast<cuuint64_t>(Q)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d_pad) * 2};
  const cuuint32_t box[2] = {kChunk, kTileQ};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, qb, dims, strides,
             box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // above 48 KB, dynamic shared memory has to be asked for
  const bool staged = M <= kMaxStagedM;
  auto kernel = staged ? decode_scan_kernel<true> : decode_scan_kernel<false>;
  const int smem = staged ? kStagedSmemBytes : kSmemBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles =
      ((static_cast<long long>(N) + kTileN - 1) / kTileN) *
      ((Q + kTileQ - 1) / kTileQ);
  const unsigned grid = static_cast<unsigned>(tiles < sms ? tiles : sms);
  kernel<<<grid, kThreads, smem, s>>>(
      qmap, static_cast<const uint8_t*>(codes),
      static_cast<const uint8_t*>(cbt), static_cast<float*>(out), Q, N, M,
      d_pad, dsub, N % 2 == 0 ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
