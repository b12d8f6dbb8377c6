// Native edge-list parser of pprx_torch: the port's own copy of the JAX
// package's native/edgeio.cpp, with the same C interface and output.
//
// An mmap + multithreaded scanner that turns whitespace-separated
// "src dst [timestamp]" text into packed int64/double arrays. Renumbering
// and sorting stay in NumPy on the Python side (pprx_torch/graph/io.py), so
// the deterministic first-seen order lives in one place. Consumed through
// ctypes (pprx_torch/graph/native_io.py); the pure-Python parser is the
// fallback where no C++ compiler exists, and the correctness oracle.
//
// Built at first use by pprx_torch._ext.build_host("edgeio") into
// build/pprx_torch/ (flags: -O3 -std=c++17 -fPIC -pthread -shared).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Shard {
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
  std::vector<double> ts;
  bool saw_ts = false;
};

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

// Parse one chunk [lo, hi) of the buffer. `lo` must point at a line start.
void parse_chunk(const char* buf, size_t lo, size_t hi, Shard* out) {
  size_t i = lo;
  while (i < hi) {
    // line start
    while (i < hi && is_space(buf[i])) i++;
    if (i >= hi) break;
    char c = buf[i];
    if (c == '\n') { i++; continue; }
    if (c == '#' || c == '%') {  // comment line
      while (i < hi && buf[i] != '\n') i++;
      continue;
    }
    // parse up to three numeric fields; skip malformed lines
    const char* p = buf + i;
    char* end = nullptr;
    errno = 0;
    long long a = strtoll(p, &end, 10);
    if (end == p) { while (i < hi && buf[i] != '\n') i++; continue; }
    i = end - buf;
    while (i < hi && is_space(buf[i])) i++;
    p = buf + i;
    long long b = strtoll(p, &end, 10);
    if (end == p) { while (i < hi && buf[i] != '\n') i++; continue; }
    i = end - buf;
    // optional timestamp
    while (i < hi && is_space(buf[i])) i++;
    double t = 0.0;
    if (i < hi && buf[i] != '\n') {
      p = buf + i;
      t = strtod(p, &end);
      if (end != p) {
        i = end - buf;
        out->saw_ts = true;
      }
    }
    out->src.push_back(a);
    out->dst.push_back(b);
    out->ts.push_back(t);
    while (i < hi && buf[i] != '\n') i++;  // rest of line
  }
}

}  // namespace

extern "C" {

// Parses `path`. On success returns 0 and fills outputs (caller frees each
// array with pprx_free). *out_has_ts is 1 if any line had a third column.
int pprx_parse_edgelist(const char* path, int64_t** out_src, int64_t** out_dst,
                        double** out_ts, int64_t* out_count, int* out_has_ts) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -2; }
  size_t len = (size_t)st.st_size;
  if (len == 0) {
    close(fd);
    *out_src = nullptr; *out_dst = nullptr; *out_ts = nullptr;
    *out_count = 0; *out_has_ts = 0;
    return 0;
  }
  const char* buf =
      (const char*)mmap(nullptr, len, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (buf == MAP_FAILED) return -3;

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = std::max(1u, std::min(hw ? hw : 4u, 32u));
  if (len < (1 << 20)) nthreads = 1;  // small files: skip thread overhead

  // chunk boundaries aligned to line starts
  std::vector<size_t> bounds(nthreads + 1, 0);
  bounds[nthreads] = len;
  for (size_t k = 1; k < nthreads; k++) {
    size_t pos = len * k / nthreads;
    while (pos < len && buf[pos] != '\n') pos++;
    bounds[k] = pos < len ? pos + 1 : len;
  }

  std::vector<Shard> shards(nthreads);
  std::vector<std::thread> threads;
  for (size_t k = 0; k < nthreads; k++) {
    threads.emplace_back(parse_chunk, buf, bounds[k], bounds[k + 1], &shards[k]);
  }
  for (auto& t : threads) t.join();
  munmap((void*)buf, len);

  size_t total = 0;
  bool has_ts = false;
  for (auto& s : shards) { total += s.src.size(); has_ts |= s.saw_ts; }

  int64_t* src = (int64_t*)malloc(total * sizeof(int64_t));
  int64_t* dst = (int64_t*)malloc(total * sizeof(int64_t));
  double* ts = (double*)malloc(total * sizeof(double));
  if ((!src || !dst || !ts) && total > 0) {
    free(src); free(dst); free(ts);
    return -4;
  }
  size_t off = 0;
  for (auto& s : shards) {
    std::memcpy(src + off, s.src.data(), s.src.size() * sizeof(int64_t));
    std::memcpy(dst + off, s.dst.data(), s.dst.size() * sizeof(int64_t));
    std::memcpy(ts + off, s.ts.data(), s.ts.size() * sizeof(double));
    off += s.src.size();
  }
  *out_src = src;
  *out_dst = dst;
  *out_ts = ts;
  *out_count = (int64_t)total;
  *out_has_ts = has_ts ? 1 : 0;
  return 0;
}

void pprx_free(void* p) { free(p); }

}  // extern "C"
