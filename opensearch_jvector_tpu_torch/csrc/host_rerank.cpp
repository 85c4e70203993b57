// Exact fp32 rerank of the on_disk tier's candidate rows, on the host.
//
// The on_disk search gathers each query's r candidate rows from the host
// row store into one [Q, r, d] float32 block. This kernel scores every
// qualifying row of that block against its query and keeps each query's
// top k, in one pass split over threads by query. It computes the formulas
// of `ops/distances.py:host_candidate_scores` in float32:
//   euclidean    1 / (1 + sum((q - c)^2)), by direct difference;
//   dot product  (1 + q.c) / 2;
//   cosine       (1 + q.c / (sqrt(q.q + 1e-30) * sqrt(c.c + 1e-30))) / 2.
// A row whose `qualify` flag is false is never read and scores -inf. The
// top k are ordered by score, descending, ties broken by the lower
// candidate position; a score under `threshold` (-inf keeps every score),
// or -inf, leaves id -1 and score -inf. A NaN score (only NaN data gives
// one) is treated as -inf.
//
// The inner loops keep kLanes explicit partial sums, so they vectorise
// without -ffast-math; `target_clones` builds them for AVX-512, AVX2 and
// the portable baseline and picks one at load time, so the library runs
// on any x86-64 host. Plain C entry point for ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

namespace {

constexpr int kLanes = 16;  // one AVX-512 register, two of AVX2
constexpr int64_t kOneThreadBytes = int64_t{1} << 20;
constexpr float kNegInf = -std::numeric_limits<float>::infinity();

enum Similarity : int { kEuclidean = 0, kDotProduct = 1, kCosine = 2 };

inline float lane_sum(const float* acc) {
  float s = 0.0f;
  for (int j = 0; j < kLanes; ++j) s += acc[j];
  return s;
}

__attribute__((target_clones("avx512f", "avx2", "default")))
float squared_distance(const float* q, const float* c, int64_t d) {
  float acc[kLanes] = {};
  int64_t i = 0;
  for (; i + kLanes <= d; i += kLanes) {
    for (int j = 0; j < kLanes; ++j) {
      const float t = q[i + j] - c[i + j];
      acc[j] += t * t;
    }
  }
  for (int j = 0; i + j < d; ++j) {
    const float t = q[i + j] - c[i + j];
    acc[j] += t * t;
  }
  return lane_sum(acc);
}

__attribute__((target_clones("avx512f", "avx2", "default")))
float inner_product(const float* q, const float* c, int64_t d) {
  float acc[kLanes] = {};
  int64_t i = 0;
  for (; i + kLanes <= d; i += kLanes) {
    for (int j = 0; j < kLanes; ++j) acc[j] += q[i + j] * c[i + j];
  }
  for (int j = 0; i + j < d; ++j) acc[j] += q[i + j] * c[i + j];
  return lane_sum(acc);
}

// q.c and c.c in one read of c.
__attribute__((target_clones("avx512f", "avx2", "default")))
void inner_and_norm(const float* q, const float* c, int64_t d, float* dot,
                    float* norm) {
  float acc[kLanes] = {};
  float sq[kLanes] = {};
  int64_t i = 0;
  for (; i + kLanes <= d; i += kLanes) {
    for (int j = 0; j < kLanes; ++j) {
      acc[j] += q[i + j] * c[i + j];
      sq[j] += c[i + j] * c[i + j];
    }
  }
  for (int j = 0; i + j < d; ++j) {
    acc[j] += q[i + j] * c[i + j];
    sq[j] += c[i + j] * c[i + j];
  }
  *dot = lane_sum(acc);
  *norm = lane_sum(sq);
}

struct Problem {
  const float* queries;    // [Q, d]
  const float* rows;       // [Q, r, d]
  const int64_t* cand_ids; // [Q, r]
  const uint8_t* qualify;  // [Q, r]
  int64_t r, d, kk;        // kk = min(k, r): the output's width
  float threshold;
  int sim;
  int64_t* out_ids;        // [Q, kk]
  float* out_scores;       // [Q, kk]
};

// Scores and selects queries [lo, hi); `scores` and `order` hold r each.
// Returns the rows scored.
int64_t rerank_range(const Problem& p, int64_t lo, int64_t hi, float* scores,
                     int32_t* order) {
  const int64_t r = p.r, d = p.d;
  const auto better = [scores](int32_t a, int32_t b) {
    return scores[a] > scores[b] || (scores[a] == scores[b] && a < b);
  };
  int64_t scored = 0;
  for (int64_t qi = lo; qi < hi; ++qi) {
    const float* q = p.queries + qi * d;
    const float* block = p.rows + qi * r * d;
    const uint8_t* ok = p.qualify + qi * r;
    float q_norm = 0.0f;
    if (p.sim == kCosine) q_norm = std::sqrt(inner_product(q, q, d) + 1e-30f);
    int32_t n = 0;
    for (int64_t j = 0; j < r; ++j) {
      if (!ok[j]) continue;
      const float* c = block + j * d;
      float s;
      if (p.sim == kEuclidean) {
        s = 1.0f / (1.0f + squared_distance(q, c, d));
      } else if (p.sim == kDotProduct) {
        s = (1.0f + inner_product(q, c, d)) / 2.0f;
      } else {
        float dot, c_norm;
        inner_and_norm(q, c, d, &dot, &c_norm);
        s = (1.0f + dot / (q_norm * std::sqrt(c_norm + 1e-30f))) / 2.0f;
      }
      ++scored;
      if (std::isnan(s) || s == kNegInf) continue;
      scores[j] = s;
      order[n++] = static_cast<int32_t>(j);
    }
    const int32_t m = static_cast<int32_t>(std::min<int64_t>(p.kk, n));
    if (m < n) {
      std::partial_sort(order, order + m, order + n, better);
    } else {
      std::sort(order, order + n, better);
    }
    int64_t* ids = p.out_ids + qi * p.kk;
    float* top = p.out_scores + qi * p.kk;
    for (int64_t t = 0; t < p.kk; ++t) {
      const float s = t < m ? scores[order[t]] : kNegInf;
      if (s == kNegInf || !(s >= p.threshold)) {
        ids[t] = -1;
        top[t] = kNegInf;
      } else {
        ids[t] = p.cand_ids[qi * r + order[t]];
        top[t] = s;
      }
    }
  }
  return scored;
}

}  // namespace

extern "C" {

// Reranks Q queries' r gathered candidate rows each: queries [Q, d],
// rows [Q, r, d] float32 and cand_ids [Q, r] int64, qualify [Q, r] one
// byte each, all C-contiguous; sim 0 euclidean, 1 dot product, 2 cosine.
// Writes out_ids [Q, min(k, r)] int64 and out_scores [Q, min(k, r)]
// float32; `threshold` -inf keeps every score. Queries are split over at
// most `threads` threads, one when the block is under 1 MiB. Returns the
// rows scored, or -1 on a bad argument and -2 when no buffer could be
// allocated.
int64_t hr_rerank(const float* queries, const float* rows,
                  const int64_t* cand_ids, const uint8_t* qualify, int64_t Q,
                  int64_t r, int64_t d, int64_t k, float threshold, int sim,
                  int threads, int64_t* out_ids, float* out_scores) {
  if (Q < 0 || r < 0 || d < 1 || k < 1 || r > INT32_MAX ||
      sim < kEuclidean || sim > kCosine) {
    return -1;
  }
  if (Q == 0 || r == 0) return 0;
  if (!queries || !rows || !cand_ids || !qualify || !out_ids || !out_scores) {
    return -1;
  }
  const Problem p{queries,   rows, cand_ids, qualify, r, d, std::min(k, r),
                  threshold, sim,  out_ids,  out_scores};
  if (threads < 1) threads = 1;
  if (Q * r * d * static_cast<int64_t>(sizeof(float)) < kOneThreadBytes) {
    threads = 1;
  }
  if (threads > Q) threads = static_cast<int>(Q);

  std::vector<float> scores;
  std::vector<int32_t> order;
  std::vector<int64_t> scored;
  std::vector<std::thread> pool;
  std::vector<int> leftover;
  try {
    scores.resize(static_cast<size_t>(threads * r));
    order.resize(static_cast<size_t>(threads * r));
    scored.resize(static_cast<size_t>(threads), 0);
    pool.reserve(static_cast<size_t>(threads));
    leftover.reserve(static_cast<size_t>(threads));
  } catch (const std::bad_alloc&) {
    return -2;
  }
  const int64_t chunk = (Q + threads - 1) / threads;
  const auto work = [&](int t) {
    const int64_t lo = t * chunk;
    const int64_t hi = std::min(Q, lo + chunk);
    if (lo < hi) {
      scored[t] = rerank_range(p, lo, hi, scores.data() + t * r,
                               order.data() + t * r);
    }
  };
  // The caller's thread takes chunk 0; a chunk whose thread cannot be
  // started runs on the caller's thread too.
  for (int t = 1; t < threads; ++t) {
    try {
      pool.emplace_back(work, t);
    } catch (const std::system_error&) {
      leftover.push_back(t);
    }
  }
  work(0);
  for (int t : leftover) work(t);
  for (auto& th : pool) th.join();
  int64_t total = 0;
  for (int64_t s : scored) total += s;
  return total;
}

}  // extern "C"
