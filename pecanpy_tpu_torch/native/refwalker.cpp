// Copied from pecanpy_tpu/native/refwalker.cpp (the JAX package), code and C ABI
// unchanged, so both packages build the same library from it.

// Reference-semantics CPU walker: the honest baseline for bench.py.
//
// PecanPy's walk engine is a Numba-JIT-compiled scalar loop
// (reference: pecanpy.py:164-210 `_random_walks` prange over walks;
// sparse_rw.py:51-91 `get_normalized_probs`; pecanpy.py:543-559
// SparseOTF cumsum+search sampling). Numba is not installed in this
// image, so this file reproduces that exact execution shape — one
// scalar walker per thread, per-step O(deg_cur + deg_prev) work:
//   * biased weights: w(cur,x)/p when x == prev, w(cur,x)/q when x is
//     NOT a neighbor of prev (two-pointer sorted merge, the reference's
//     `isnotin`, sparse_rw.py:142-230), unchanged for common neighbors;
//   * sampling: cumulative scan against u * total (the inverse-CDF
//     draw of pecanpy.py:556-557, linear scan instead of binary search
//     — faster at the benchmark's mean degree);
//   * early termination on neighborless nodes with the effective
//     length recorded (pecanpy.py:189-206);
//   * `workers` threads strided over walks, per-thread RNG seeding
//     (the reference seeds numpy per thread, pecanpy.py:176-178).
//
// Compiled -O3 this is at least as fast as Numba emits for the same
// loop, so bench.py's `vs_baseline` measures the device engine against
// a real compiled-CPU reference rather than vectorized numpy.
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct SplitMix64 {
  uint64_t state;
  explicit SplitMix64(uint64_t seed) : state(seed) {}
  uint64_t next() {
    state += 0x9E3779B97f4A7C15ULL;
    uint64_t z = state;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
};

// Output mix for per-thread seed derivation: seeding thread k with
// `seed + GOLDEN * k` directly would make its stream a k-draw shift of
// thread 0's (GOLDEN is the state increment); mixing first makes the
// streams effectively independent.
inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

}  // namespace

extern "C" {

// Walks out_walks[w, 0..eff-1]; out_eff[w] = effective length (number
// of valid columns, walk_length + 1 when never terminated early).
void pp_walk_node2vec(const int64_t* indptr, const int32_t* indices,
                      const float* data, const int32_t* starts,
                      long long n_walks, int walk_length, double p,
                      double q, uint64_t seed, int workers,
                      int32_t* out_walks, int32_t* out_eff) {
  if (workers < 1) workers = 1;
  const double inv_p = 1.0 / p;
  const double inv_q = 1.0 / q;
  const int cols = walk_length + 1;

  auto worker_fn = [&](int tid) {
    SplitMix64 rng(
        mix64(seed + 0x9E3779B97f4A7C15ULL * (uint64_t)(tid + 1)));
    std::vector<float> w;  // biased weights of cur's row
    for (long long wk = tid; wk < n_walks; wk += workers) {
      int32_t* row = out_walks + wk * cols;
      int32_t cur = starts[wk];
      row[0] = cur;
      int step = 1;
      int32_t prev = -1;
      for (; step <= walk_length; ++step) {
        const int64_t lo = indptr[cur], hi = indptr[cur + 1];
        const int64_t deg = hi - lo;
        if (deg == 0) break;  // dead end: early termination
        double total = 0.0;
        w.resize((size_t)deg);
        if (prev < 0) {  // first step: 1st-order weights
          for (int64_t e = 0; e < deg; ++e) {
            w[(size_t)e] = data[lo + e];
            total += data[lo + e];
          }
        } else {
          // sorted-merge membership of cur's candidates in prev's row
          const int64_t plo = indptr[prev], phi = indptr[prev + 1];
          int64_t j = plo;
          for (int64_t e = 0; e < deg; ++e) {
            const int32_t x = indices[lo + e];
            double wx = data[lo + e];
            if (x == prev) {
              wx *= inv_p;
            } else {
              while (j < phi && indices[j] < x) ++j;
              const bool common = (j < phi && indices[j] == x);
              if (!common) wx *= inv_q;
            }
            w[(size_t)e] = (float)wx;
            total += wx;
          }
        }
        // inverse-CDF draw (linear scan; deg is small on OTF graphs)
        double u = rng.uniform() * total;
        double acc = 0.0;
        int64_t choice = deg - 1;
        for (int64_t e = 0; e < deg; ++e) {
          acc += w[(size_t)e];
          if (u < acc) {
            choice = e;
            break;
          }
        }
        prev = cur;
        cur = indices[lo + choice];
        row[step] = cur;
      }
      out_eff[wk] = step;
      for (int c = step; c < cols; ++c) row[c] = cur;  // resting emission
    }
  };

  if (workers == 1) {
    worker_fn(0);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int tid = 0; tid < workers; ++tid) threads.emplace_back(worker_fn, tid);
  for (auto& t : threads) t.join();
}

}  // extern "C"
