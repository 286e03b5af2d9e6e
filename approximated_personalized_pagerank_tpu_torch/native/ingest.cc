// Native host helpers of the PyTorch port: the edge-list parse and the
// 2-colouring, the host prep of a graph with tens of millions of edges.
//
// Built with g++ at first use into build/native/ and loaded through ctypes
// (utils/io.py).  The numpy parse (utils/io.py::_parse_bytes) and
// Graph._bfs_bipartition are the plain versions; both functions here give
// byte-equal results.
//
// C ABI:
//   ppr_parse_edge_csv(path, out, cap) -> number of edges parsed, or
//     -1 on an I/O error, -2 when more than `cap` edges are found,
//     -3 on an odd number of integers, -4 on a token that is not a
//     decimal int64.  The file is one stream of integers separated by
//     commas and ASCII whitespace (so "a,b" lines with \r\n endings and
//     blank lines, as the reference's importGraph reads them,
//     src/main.cc:78-112); `out` receives (src, dst) int64 pairs
//     interleaved.
//   ppr_bfs_bipartition(n, indptr, indices, cindptr, cindices, color) ->
//     BFS-level parity over the undirected closure (successors and
//     predecessors), one BFS per component in order of the lowest
//     unvisited id, each root coloured 0 (the reference's findPartitions,
//     include/internal/pprInternal.h:30-99).

#include <cstdint>
#include <cstdio>
#include <vector>

namespace {

inline bool is_sep(char c) {
  return c == ',' || c == ' ' || c == '\n' || c == '\r' || c == '\t' ||
         c == '\v' || c == '\f';
}

// Parses one token at p (not a separator); returns false unless it is an
// optional sign followed by decimal digits that fit in an int64.
bool parse_int(const char*& p, const char* end, long long* value) {
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = *p == '-';
    ++p;
  }
  const char* digits = p;
  unsigned long long v = 0;
  const unsigned long long limit =
      neg ? 9223372036854775808ULL : 9223372036854775807ULL;
  while (p < end && *p >= '0' && *p <= '9') {
    unsigned d = static_cast<unsigned>(*p - '0');
    if (v > (limit - d) / 10) return false;
    v = v * 10 + d;
    ++p;
  }
  if (p == digits || (p < end && !is_sep(*p))) return false;
  *value = neg ? static_cast<long long>(0ULL - v) : static_cast<long long>(v);
  return true;
}

}  // namespace

extern "C" {

long long ppr_parse_edge_csv(const char* path, long long* out, long long cap) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<char> buf;
  char chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof chunk, f)) > 0)
    buf.insert(buf.end(), chunk, chunk + got);
  bool failed = std::ferror(f) != 0;
  std::fclose(f);
  if (failed) return -1;

  const char* p = buf.data();
  const char* end = p + buf.size();
  long long n_ints = 0;
  while (true) {
    while (p < end && is_sep(*p)) ++p;
    if (p >= end) break;
    long long v;
    if (!parse_int(p, end, &v)) return -4;
    if (n_ints >= 2 * cap) return -2;
    out[n_ints++] = v;
  }
  if (n_ints % 2) return -3;
  return n_ints / 2;
}

void ppr_bfs_bipartition(int64_t n, const int32_t* indptr,
                         const int32_t* indices, const int32_t* cindptr,
                         const int32_t* cindices, uint8_t* color) {
  for (int64_t v = 0; v < n; ++v) color[v] = 255;  // unvisited
  std::vector<int32_t> queue;
  queue.reserve(1024);
  for (int64_t root = 0; root < n; ++root) {
    if (color[root] != 255) continue;
    color[root] = 0;
    queue.clear();
    queue.push_back(static_cast<int32_t>(root));
    for (size_t head = 0; head < queue.size(); ++head) {
      int32_t v = queue[head];
      uint8_t next = color[v] ^ 1;
      for (int32_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        int32_t s = indices[e];
        if (color[s] == 255) {
          color[s] = next;
          queue.push_back(s);
        }
      }
      for (int32_t e = cindptr[v]; e < cindptr[v + 1]; ++e) {
        int32_t s = cindices[e];
        if (color[s] == 255) {
          color[s] = next;
          queue.push_back(s);
        }
      }
    }
  }
}

}  // extern "C"
