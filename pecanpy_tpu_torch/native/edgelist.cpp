// Copied from pecanpy_tpu/native/edgelist.cpp (the JAX package), code and C ABI
// unchanged, so both packages build the same library from it.

// Fast edgelist parser: the native data-loading path.
//
// The reference parses .edg files line-by-line in pure Python
// (AdjlstGraph.read, graph.py:270-305) — the slowest stage for large
// graphs. This parser implements the same contract in C++:
//
//   * 2 or 3 columns, configurable (possibly multi-byte) delimiter,
//     whitespace-stripped tokens;
//   * weighted files must have exactly 3 columns (error otherwise);
//   * non-positive weights dropped (counted, reported to Python);
//   * duplicate edges: last weight wins (conflicts counted);
//   * undirected inserts both directions;
//   * node indices assigned in first-seen order;
//   * CSR rows emitted with neighbor indices ascending.
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ParsedGraph {
  std::vector<std::string> node_ids;
  std::vector<uint32_t> indptr;
  std::vector<uint32_t> indices;
  std::vector<float> data;
  int64_t dropped_nonpositive = 0;
  int64_t duplicate_conflicts = 0;
  std::string error;
};

inline void strip(const char*& b, const char*& e) {
  while (b < e && std::isspace(static_cast<unsigned char>(*b))) ++b;
  while (e > b && std::isspace(static_cast<unsigned char>(*(e - 1)))) --e;
}

}  // namespace

extern "C" {

ParsedGraph* pp_parse_edgelist(const char* path, int weighted, int directed,
                               const char* delim) {
  auto* g = new ParsedGraph();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    g->error = std::string("cannot open file: ") + path;
    return g;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::string buf(static_cast<size_t>(size), '\0');
  if (size > 0 && std::fread(&buf[0], 1, size, f) != static_cast<size_t>(size)) {
    g->error = "short read";
    std::fclose(f);
    return g;
  }
  std::fclose(f);

  const size_t dlen = std::strlen(delim);
  std::unordered_map<std::string, uint32_t> idmap;
  // (u << 32 | v) -> flat edge slot; edge weights stored flat, last wins.
  std::unordered_map<uint64_t, size_t> slot_of;
  std::vector<uint64_t> keys;   // insertion-ordered (u, v) codes
  std::vector<float> weights;   // parallel to keys

  auto node_index = [&](const char* b, const char* e) -> uint32_t {
    std::string id(b, e);
    auto it = idmap.find(id);
    if (it != idmap.end()) return it->second;
    uint32_t idx = static_cast<uint32_t>(g->node_ids.size());
    idmap.emplace(std::move(id), idx);
    g->node_ids.emplace_back(b, e);
    return idx;
  };

  auto put_edge = [&](uint32_t u, uint32_t v, float w) {
    uint64_t key = (static_cast<uint64_t>(u) << 32) | v;
    auto it = slot_of.find(key);
    if (it != slot_of.end()) {
      if (weights[it->second] != w) ++g->duplicate_conflicts;
      weights[it->second] = w;  // last wins
    } else {
      slot_of.emplace(key, keys.size());
      keys.push_back(key);
      weights.push_back(w);
    }
  };

  const char* p = buf.data();
  const char* end = p + buf.size();
  long lineno = 0;
  while (p < end) {
    const char* line_end = static_cast<const char*>(
        std::memchr(p, '\n', static_cast<size_t>(end - p)));
    if (!line_end) line_end = end;
    ++lineno;
    const char* cursor = p;
    p = line_end + 1;

    // split on the delimiter
    const char* cols[4];
    const char* cole[4];
    int ncols = 0;
    const char* field = cursor;
    while (ncols < 4) {
      const char* hit = nullptr;
      if (dlen && static_cast<size_t>(line_end - field) >= dlen) {
        hit = std::search(field, line_end, delim, delim + dlen);
        if (hit == line_end) hit = nullptr;
      }
      cols[ncols] = field;
      cole[ncols] = hit ? hit : line_end;
      ++ncols;
      if (!hit) break;
      field = hit + dlen;
    }
    // blank line (after strip) — skip, matching str.strip().split semantics
    if (ncols == 1) {
      const char* b = cols[0];
      const char* e = cole[0];
      strip(b, e);
      if (b == e) continue;
    }
    if (ncols < 2) {
      g->error = "line " + std::to_string(lineno) + ": expected at least 2 columns";
      return g;
    }

    double w = 1.0;
    if (weighted) {
      if (ncols != 3) {
        g->error = "Expecting three columns in the edge list file for a "
                   "weighted graph, got " + std::to_string(ncols) +
                   " instead (line " + std::to_string(lineno) + ")";
        return g;
      }
      const char* wb = cols[2];
      const char* we = cole[2];
      strip(wb, we);
      std::string wstr(wb, we);
      char* parse_end = nullptr;
      w = std::strtod(wstr.c_str(), &parse_end);
      if (parse_end == wstr.c_str() || *parse_end != '\0') {
        g->error = "line " + std::to_string(lineno) +
                   ": cannot parse weight '" + wstr + "'";
        return g;
      }
    }

    const char* b1 = cols[0]; const char* e1 = cole[0];
    const char* b2 = cols[1]; const char* e2 = cole[1];
    strip(b1, e1);
    strip(b2, e2);

    if (w <= 0.0) {
      ++g->dropped_nonpositive;
      continue;
    }
    uint32_t u = node_index(b1, e1);
    uint32_t v = node_index(b2, e2);
    put_edge(u, v, static_cast<float>(w));
    if (!directed) put_edge(v, u, static_cast<float>(w));
  }

  // Build sorted CSR: sort the (u << 32 | v) codes — one pass, rows come
  // out grouped by u with ascending v (the sorted-row invariant).
  std::vector<size_t> order(keys.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::sort(order.begin(), order.end(),
            [&](size_t a, size_t b) { return keys[a] < keys[b]; });

  const size_t n = g->node_ids.size();
  g->indptr.assign(n + 1, 0);
  g->indices.resize(keys.size());
  g->data.resize(keys.size());
  for (size_t i = 0; i < order.size(); ++i) {
    uint64_t key = keys[order[i]];
    uint32_t u = static_cast<uint32_t>(key >> 32);
    g->indices[i] = static_cast<uint32_t>(key & 0xffffffffu);
    g->data[i] = weights[order[i]];
    ++g->indptr[u + 1];
  }
  for (size_t i = 1; i <= n; ++i) g->indptr[i] += g->indptr[i - 1];
  return g;
}

const char* pp_error(ParsedGraph* g) {
  return g->error.empty() ? nullptr : g->error.c_str();
}

int64_t pp_num_nodes(ParsedGraph* g) {
  return static_cast<int64_t>(g->node_ids.size());
}

int64_t pp_num_edges(ParsedGraph* g) {
  return static_cast<int64_t>(g->indices.size());
}

int64_t pp_dropped_nonpositive(ParsedGraph* g) { return g->dropped_nonpositive; }

int64_t pp_duplicate_conflicts(ParsedGraph* g) { return g->duplicate_conflicts; }

void pp_fill_csr(ParsedGraph* g, uint32_t* indptr, uint32_t* indices,
                 float* data) {
  std::memcpy(indptr, g->indptr.data(), g->indptr.size() * sizeof(uint32_t));
  if (!g->indices.empty()) {
    std::memcpy(indices, g->indices.data(),
                g->indices.size() * sizeof(uint32_t));
    std::memcpy(data, g->data.data(), g->data.size() * sizeof(float));
  }
}

// Node IDs serialized as newline-joined bytes (IDs are tokens from a
// delimited file, so they cannot contain the newline separator).
int64_t pp_ids_bytes(ParsedGraph* g) {
  int64_t total = 0;
  for (const auto& s : g->node_ids) total += static_cast<int64_t>(s.size()) + 1;
  return total;
}

void pp_fill_ids(ParsedGraph* g, char* out) {
  for (const auto& s : g->node_ids) {
    std::memcpy(out, s.data(), s.size());
    out += s.size();
    *out++ = '\n';
  }
}

void pp_free(ParsedGraph* g) { delete g; }

}  // extern "C"
