// Copied from pecanpy_tpu/native/hubtables.cpp (the JAX package), code and C ABI
// unchanged, so both packages build the same library from it.

// Native builder for the hub (high-degree node) device structures.
//
// The Python builders in ops/hubs.py loop per hub row (Vose alias stacks,
// bucket-hash growth) — tens of seconds for a million-node power-law
// graph. This C++ implementation produces byte-identical tables:
//
//   * packed alias rows [E_hub, 8]: resolved Vose slot per edge
//     (acceptance prob, self neighbor/weight, alias neighbor/weight) —
//     LIFO small/large worklists exactly as ops/hubs.py `_vose_alias`;
//   * bucketized neighbor hashes [NB, 8]: each key lives in the bucket
//     its Knuth multiplicative hash selects; a node's bucket count
//     doubles until no bucket exceeds 8 keys; keys fill buckets in edge
//     order (matches the stable-argsort fill in `build_bucket_hash`).
//
// Exposed as a C ABI consumed via ctypes (no pybind11 in this image).
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kEpWidth = 8;
constexpr int kBucketWidth = 8;
constexpr uint32_t kKnuth = 2654435761u;

struct HubTables {
  std::vector<float> edge_pack;     // [E_hub, 8] (int columns bitcast)
  std::vector<int32_t> hub_base;    // [n_hubs]
  std::vector<int32_t> hkey;        // [NB, 8]
  std::vector<float> hval;          // [NB, 8]
  std::vector<int32_t> bucket_base; // [n_hubs]
  std::vector<int32_t> bucket_log;  // [n_hubs]
  std::string error;
};

inline void bitcast_store(float* dst, int32_t v) {
  std::memcpy(dst, &v, sizeof(float));
}

}  // namespace

extern "C" {

HubTables* pp_build_hub_tables(const int64_t* indptr, const int32_t* indices,
                               const float* data, const int32_t* hub_ids,
                               int64_t n_hubs) {
  auto* t = new HubTables();

  // ---- packed alias rows -------------------------------------------------
  int64_t total_edges = 0;
  t->hub_base.resize(n_hubs);
  for (int64_t i = 0; i < n_hubs; ++i) {
    t->hub_base[i] = static_cast<int32_t>(total_edges);
    total_edges += indptr[hub_ids[i] + 1] - indptr[hub_ids[i]];
  }
  t->edge_pack.assign(static_cast<size_t>(total_edges) * kEpWidth, 0.0f);

  std::vector<double> q;
  std::vector<int64_t> j, small, large;
  int64_t out = 0;
  for (int64_t i = 0; i < n_hubs; ++i) {
    const int64_t lo = indptr[hub_ids[i]];
    const int64_t k = indptr[hub_ids[i] + 1] - lo;
    if (k == 0) continue;
    double wsum = 0.0;
    for (int64_t s = 0; s < k; ++s) wsum += data[lo + s];
    q.resize(k);
    j.resize(k);
    small.clear();
    large.clear();
    for (int64_t s = 0; s < k; ++s) {
      q[s] = static_cast<double>(data[lo + s]) * (k / wsum);
      j[s] = s;
    }
    // LIFO worklists in ascending-index push order (= ops/hubs.py lists)
    for (int64_t s = 0; s < k; ++s) (q[s] < 1.0 ? small : large).push_back(s);
    while (!small.empty() && !large.empty()) {
      const int64_t s = small.back();
      small.pop_back();
      const int64_t g = large.back();
      large.pop_back();
      j[s] = g;
      q[g] = q[g] + q[s] - 1.0;
      (q[g] < 1.0 ? small : large).push_back(g);
    }
    for (int64_t s = 0; s < k; ++s) {
      float* row = &t->edge_pack[static_cast<size_t>(out + s) * kEpWidth];
      row[0] = static_cast<float>(q[s]);
      bitcast_store(&row[1], indices[lo + s]);
      row[2] = data[lo + s];
      bitcast_store(&row[3], indices[lo + j[s]]);
      row[4] = data[lo + j[s]];
    }
    out += k;
  }

  // ---- bucketized hashes ---------------------------------------------------
  // pass 1: size every hub's table (growing vectors per hub would be
  // quadratic in total table size)
  t->bucket_base.resize(n_hubs);
  t->bucket_log.resize(n_hubs);
  std::vector<int32_t> counts;
  int64_t offset = 0;
  for (int64_t i = 0; i < n_hubs; ++i) {
    const int64_t lo = indptr[hub_ids[i]];
    const int64_t k = indptr[hub_ids[i] + 1] - lo;
    int log2 = 2;
    while ((int64_t(1) << log2) * 4 < k) ++log2;  // ~4 keys per bucket
    for (;; ++log2) {
      const int64_t nb = int64_t(1) << log2;
      const uint32_t mask = static_cast<uint32_t>(nb - 1);
      counts.assign(nb, 0);
      bool ok = true;
      for (int64_t s = 0; s < k && ok; ++s) {
        const uint32_t b =
            (static_cast<uint32_t>(indices[lo + s]) * kKnuth) & mask;
        if (++counts[b] > kBucketWidth) ok = false;
      }
      if (ok) break;
    }
    t->bucket_base[i] = static_cast<int32_t>(offset);
    t->bucket_log[i] = log2;
    offset += int64_t(1) << log2;
  }
  // pass 2: allocate once, fill in edge order
  t->hkey.assign(static_cast<size_t>(offset) * kBucketWidth, -1);
  t->hval.assign(t->hkey.size(), 0.0f);
  for (int64_t i = 0; i < n_hubs; ++i) {
    const int64_t lo = indptr[hub_ids[i]];
    const int64_t k = indptr[hub_ids[i] + 1] - lo;
    const int64_t nb = int64_t(1) << t->bucket_log[i];
    const uint32_t mask = static_cast<uint32_t>(nb - 1);
    const size_t base = static_cast<size_t>(t->bucket_base[i]) * kBucketWidth;
    counts.assign(nb, 0);
    for (int64_t s = 0; s < k; ++s) {
      const uint32_t b =
          (static_cast<uint32_t>(indices[lo + s]) * kKnuth) & mask;
      const size_t slot = base + static_cast<size_t>(b) * kBucketWidth +
                          counts[b]++;
      t->hkey[slot] = indices[lo + s];
      t->hval[slot] = data[lo + s];
    }
  }
  return t;
}

int64_t pp_hub_edge_rows(HubTables* t) {
  return static_cast<int64_t>(t->edge_pack.size()) / kEpWidth;
}

int64_t pp_hub_buckets(HubTables* t) {
  return static_cast<int64_t>(t->hkey.size()) / kBucketWidth;
}

void pp_hub_fill(HubTables* t, float* edge_pack, int32_t* hub_base,
                 int32_t* hkey, float* hval, int32_t* bucket_base,
                 int32_t* bucket_log) {
  std::memcpy(edge_pack, t->edge_pack.data(),
              t->edge_pack.size() * sizeof(float));
  std::memcpy(hub_base, t->hub_base.data(),
              t->hub_base.size() * sizeof(int32_t));
  std::memcpy(hkey, t->hkey.data(), t->hkey.size() * sizeof(int32_t));
  std::memcpy(hval, t->hval.data(), t->hval.size() * sizeof(float));
  std::memcpy(bucket_base, t->bucket_base.data(),
              t->bucket_base.size() * sizeof(int32_t));
  std::memcpy(bucket_log, t->bucket_log.data(),
              t->bucket_log.size() * sizeof(int32_t));
}

void pp_hub_free(HubTables* t) { delete t; }

}  // extern "C"
