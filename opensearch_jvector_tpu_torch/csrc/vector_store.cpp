// The host row store of on_disk segments: fp32 rows in a raw row file,
// mapped read-only and gathered by id.
//
// The device holds the graph and the PQ codes; the full-precision rows stay
// in the file, and the on_disk rerank gathers only its candidates' rows
// into one block on the host. The gather is the hot path of that tier, so
// it costs its copy and little else:
//   - one mincore call over the pages the ids span tells which of them the
//     page cache lacks (only where that span is at most kMincorePagesPerId
//     pages an id: past that, as for one query's ids over a large file,
//     every row counts as absent);
//   - the ids are split into contiguous ranges, one a worker thread (one
//     thread under 1,024 ids, where starting threads costs more than it
//     saves);
//   - each worker first asks the kernel to read ahead the absent pages its
//     rows touch (MADV_WILLNEED, one call a run of adjacent pages), so a
//     cold file has its whole share queued before the worker copies, while
//     a file already in the page cache costs no call a row;
//   - then it copies its rows into the caller's buffer, which the caller
//     may reuse from batch to batch.
// Nothing is read at open: the file is mapped, never faulted in or copied
// whole into memory, since an on_disk corpus need not fit in RAM.
//
// The row format is the JAX package's (`native/vector_store.cpp`): rows of
// `row_bytes` after `header_bytes`, no footer. Plain C entry points for
// ctypes.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstring>
#include <new>
#include <system_error>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kOneThreadIds = 1024;
constexpr int kMaxThreads = 64;
// Past this many pages an id, advising every row costs less than asking
// mincore which pages of the whole span are absent. A page of mincore
// costs what ~1/250 of an madvise call costs on a plain Linux host and
// ~1/4,000 under a sandboxed kernel; 1,024 keeps both within ~4x of the
// cheaper choice.
constexpr int64_t kMincorePagesPerId = 1024;

struct Store {
  int fd = -1;
  const char* base = nullptr;  // mmap base
  int64_t file_bytes = 0;
  int64_t row_bytes = 0;
  int64_t header_bytes = 0;
  int64_t num_rows = 0;
  int64_t page = 4096;
};

inline bool valid(const Store* s, int64_t id) {
  return id >= 0 && id < s->num_rows;
}

inline const char* row_ptr(const Store* s, int64_t id) {
  return s->base + s->header_bytes + id * s->row_bytes;
}

// Which pages of the mapping the page cache holds, as mincore saw them
// over the pages [first, first + resident.size()); where `known` is false,
// every page counts as absent.
struct Residency {
  bool known = false;
  int64_t first = 0;
  std::vector<unsigned char> resident;

  Residency(const Store* s, const int64_t* ids, int64_t n) {
    int64_t lo = INT64_MAX, hi = -1;  // the rows' first and last page
    for (int64_t i = 0; i < n; ++i) {
      if (!valid(s, ids[i])) continue;
      const int64_t off = s->header_bytes + ids[i] * s->row_bytes;
      lo = std::min<int64_t>(lo, off / s->page);
      hi = std::max<int64_t>(hi, (off + s->row_bytes - 1) / s->page);
    }
    if (hi < lo || hi - lo + 1 > kMincorePagesPerId * n) return;
    try {
      resident.resize(static_cast<size_t>(hi - lo + 1));
    } catch (const std::bad_alloc&) {
      return;
    }
    first = lo;
    known = ::mincore(const_cast<char*>(s->base) + lo * s->page,
                      static_cast<size_t>(hi - lo + 1) * s->page,
                      resident.data()) == 0;
  }

  // Whether the page cache holds every page of [a, b).
  bool holds(int64_t a, int64_t b) const {
    if (!known) return false;
    for (int64_t p = a; p < b; ++p) {
      if (!(resident[static_cast<size_t>(p - first)] & 1)) return false;
    }
    return true;
  }
};

// Advises the pages that rows ids[0, n) touch and `res` does not hold with
// MADV_WILLNEED, one call a run of adjacent or overlapping pages, in the
// order the ids come. Returns the pages advised.
int64_t advise_rows(const Store* s, const Residency& res, const int64_t* ids,
                    int64_t n) {
  int64_t lo = 0, hi = 0;  // the open run of pages [lo, hi)
  int64_t pages = 0;
  const auto close_run = [&] {
    if (hi > lo) {
      ::madvise(const_cast<char*>(s->base) + lo * s->page,
                static_cast<size_t>(hi - lo) * s->page, MADV_WILLNEED);
      pages += hi - lo;
    }
  };
  for (int64_t i = 0; i < n; ++i) {
    if (!valid(s, ids[i])) continue;
    const int64_t off = s->header_bytes + ids[i] * s->row_bytes;
    const int64_t a = off / s->page;
    const int64_t b = (off + s->row_bytes - 1) / s->page + 1;
    if (res.holds(a, b)) continue;
    if (hi > lo && a <= hi && b >= lo) {
      lo = std::min(lo, a);
      hi = std::max(hi, b);
    } else {
      close_run();
      lo = a;
      hi = b;
    }
  }
  close_run();
  return pages;
}

void copy_rows(const Store* s, const int64_t* ids, int64_t n, char* out) {
  const int64_t rb = s->row_bytes;
  for (int64_t i = 0; i < n; ++i) {
    if (valid(s, ids[i])) {
      std::memcpy(out + i * rb, row_ptr(s, ids[i]), rb);
    } else {
      std::memset(out + i * rb, 0, rb);
    }
  }
}

// Splits ids [0, n) into contiguous ranges over at most `threads` threads
// (one under kOneThreadIds) and runs work(lo, hi) on each; the caller's
// thread takes the first range, and a range whose thread cannot be started
// runs on the caller's thread too. Returns the sum of what the calls
// return.
template <typename Work>
int64_t split(int64_t n, int threads, const Work& work) {
  if (threads < 1) threads = 1;
  if (threads > kMaxThreads) threads = kMaxThreads;
  if (n < kOneThreadIds) threads = 1;
  const int64_t chunk = threads > 1 ? (n + threads - 1) / threads : n;
  int64_t sums[kMaxThreads] = {};
  const auto run = [&](int t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo < hi) sums[t] = work(lo, hi);
  };
  std::vector<std::thread> pool;
  std::vector<int> leftover;
  for (int t = 1; t < threads && t * chunk < n; ++t) {
    try {
      pool.emplace_back(run, t);
    } catch (const std::system_error&) {
      leftover.push_back(t);
    }
  }
  run(0);
  for (int t : leftover) run(t);
  for (auto& th : pool) th.join();
  int64_t total = 0;
  for (int t = 0; t < threads; ++t) total += sums[t];
  return total;
}

}  // namespace

extern "C" {

// Opens a row-major binary file. header_bytes are skipped; row_bytes is the
// stride. Returns nullptr on failure.
void* vs_open(const char* path, int64_t row_bytes, int64_t header_bytes) {
  if (row_bytes <= 0 || header_bytes < 0) return nullptr;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->file_bytes = st.st_size;
  s->row_bytes = row_bytes;
  s->header_bytes = header_bytes;
  s->num_rows = st.st_size > header_bytes
                    ? (st.st_size - header_bytes) / row_bytes : 0;
  const long page = ::sysconf(_SC_PAGESIZE);
  if (page > 0) s->page = page;
  if (st.st_size > 0) {
    void* base = ::mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
    if (base == MAP_FAILED) {
      ::close(fd);
      delete s;
      return nullptr;
    }
    // Rows are gathered at random: no read-ahead beyond what is advised.
    ::madvise(base, st.st_size, MADV_RANDOM);
    s->base = static_cast<const char*>(base);
  }
  return s;
}

int64_t vs_num_rows(void* h) {
  return h ? static_cast<Store*>(h)->num_rows : -1;
}

// Gathers n rows (by id) into out (n * row_bytes). Out-of-range ids are
// zero-filled. Each of at most `threads` workers advises the absent pages
// of its share of the ids, then copies that share. Returns the pages
// advised, or -1 on a bad argument.
int64_t vs_gather(void* h, const int64_t* ids, int64_t n, char* out,
                  int threads) {
  if (!h || n < 0 || (n > 0 && (!ids || !out))) return -1;
  const Store* s = static_cast<Store*>(h);
  const Residency res(s, ids, n);
  return split(n, threads, [s, &res, ids, out](int64_t lo, int64_t hi) {
    const int64_t pages = advise_rows(s, res, ids + lo, hi - lo);
    copy_rows(s, ids + lo, hi - lo, out + lo * s->row_bytes);
    return pages;
  });
}

void vs_close(void* h) {
  if (!h) return;
  Store* s = static_cast<Store*>(h);
  if (s->base) ::munmap(const_cast<char*>(s->base), s->file_bytes);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"
