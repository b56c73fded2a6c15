// Copied from pecanpy_tpu/native/seqsgns.cpp (the JAX package), code and C ABI
// unchanged, so both packages build the same library from it.

// Sequential skip-gram negative-sampling trainer (gensim loop semantics).
//
// Two entry points:
//   * pp_train_sgns_sequential — single thread, strictly sequential
//     pair application. This is the EXACT-semantics path, pinned
//     bit-for-bit by tests/test_seqsgns.py's Python oracle, and the
//     evidence baseline for the capped-sum batching quality comparison
//     (benchmarks/bench_quality.py --trainer sequential).
//   * pp_train_sgns_sequential_mt — hogwild over `workers` threads,
//     mirroring gensim's worker threads (reference usage:
//     src/pecanpy/pecanpy.py:279-288, `workers` ctor
//     param): threads race lock-free updates into the shared tables,
//     each with its own RNG stream, walks strided across threads,
//     threads joined between epochs. Nondeterministic by design
//     (exactly like gensim with workers > 1); per-pair math identical
//     to the single-thread loop.
//
// Both implement the TPU trainer's per-pair math with sequential
// application, exposed to users as embed(trainer="sequential") /
// CLI --trainer sequential for small-graph gensim-parity quality.
//
// Loop contract (gensim word2vec train_batch_sg / train_sg_pair,
// reference usage: src/pecanpy/pecanpy.py:279-288):
//   * sentence = walk prefix, subsampled by keep_prob BEFORE windowing
//     (dropped tokens do not count as context);
//   * per center position a reduced window: b ~ U{0..window-1},
//     effective span = window - b;
//   * pair (center, context): input vector l1 = W_in[context], outputs
//     = W_out[center] (label 1) plus `negative` unigram^0.75 draws
//     (label 0), a draw colliding with the center skipped;
//   * updates applied immediately (W_out rows during the pair,
//     W_in[context] += neu1e after it);
//   * linear lr decay by token progress across all epochs.
//
// The RNG is splitmix64 (public-domain construction), duplicated
// bit-for-bit in tests/test_seqsgns.py's Python oracle so the C++ loop
// itself is pinned by an exact test at tiny scale.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
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
  // uniform in [0, 1)
  double uniform() { return (next() >> 11) * (1.0 / 9007199254740992.0); }
  // uniform integer in [0, n)
  uint64_t randint(uint64_t n) { return next() % n; }
};

// SplitMix64's output mix, used to derive per-thread seeds. Seeding a
// thread with `seed + GOLDEN * k` directly would make its stream an
// exact k-draw shift of thread 0's (GOLDEN is the state increment);
// mixing the derived value first breaks that arithmetic structure so
// the streams are effectively independent.
inline uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

inline float sigmoidf(float x) { return 1.0f / (1.0f + std::exp(-x)); }

struct SgnsTables {
  float* w_in;
  float* w_out;
  long long dim;
  const float* keep_prob;
  const int32_t* neg_table;
  long long neg_table_size;
  int window;
  int negative;
};

// Subsample one walk and train all its window pairs at learning rate
// `lr`. RNG consumption order (one uniform per token, one randint per
// center, one randint per negative) is the contract the Python oracle
// replays — shared verbatim by the single-thread and hogwild paths.
inline long long train_one_walk(const SgnsTables& tb, const int32_t* walk,
                                long long eff, float lr, SplitMix64& rng,
                                int32_t* sent, float* neu1e) {
  long long m = 0;
  for (long long i = 0; i < eff; ++i) {
    int32_t tok = walk[i];
    if (rng.uniform() < tb.keep_prob[tok]) sent[m++] = tok;
  }
  long long pairs = 0;
  const long long dim = tb.dim;
  for (long long i = 0; i < m; ++i) {  // center position
    long long b = (long long)rng.randint((uint64_t)tb.window);
    long long lo = i - (tb.window - b);
    long long hi = i + (tb.window - b);
    if (lo < 0) lo = 0;
    if (hi >= m) hi = m - 1;
    int32_t cen = sent[i];
    for (long long j = lo; j <= hi; ++j) {  // context position
      if (j == i) continue;
      int32_t ctx = sent[j];
      float* l1 = tb.w_in + (long long)ctx * dim;
      std::memset(neu1e, 0, dim * sizeof(float));
      // positive output row + `negative` sampled rows
      for (int k = 0; k < tb.negative + 1; ++k) {
        int32_t target;
        float label;
        if (k == 0) {
          target = cen;
          label = 1.0f;
        } else {
          target = tb.neg_table[rng.randint((uint64_t)tb.neg_table_size)];
          if (target == cen) continue;  // collision skip
          label = 0.0f;
        }
        float* l2 = tb.w_out + (long long)target * dim;
        float f = 0.0f;
        for (long long d = 0; d < dim; ++d) f += l1[d] * l2[d];
        float g = (label - sigmoidf(f)) * lr;
        for (long long d = 0; d < dim; ++d) neu1e[d] += g * l2[d];
        for (long long d = 0; d < dim; ++d) l2[d] += g * l1[d];
      }
      for (long long d = 0; d < dim; ++d) l1[d] += neu1e[d];
      ++pairs;
    }
  }
  return pairs;
}

}  // namespace

extern "C" {

// Trains in place; returns the number of trained (center, context) pairs.
long long pp_train_sgns_sequential(
    const int32_t* walks, const int32_t* eff_len, long long n_walks,
    long long t_cols, float* w_in, float* w_out, long long n_nodes,
    long long dim, const float* keep_prob, const int32_t* neg_table,
    long long neg_table_size, int window, int negative, float alpha,
    float min_alpha, double total_tokens, int epochs, uint64_t seed) {
  SplitMix64 rng(seed);
  std::vector<int32_t> sent(t_cols);
  std::vector<float> neu1e(dim);
  double done_tokens = 0.0;
  long long pairs = 0;
  (void)n_nodes;
  SgnsTables tb{w_in,      w_out,  dim,    keep_prob,
                neg_table, neg_table_size, window, negative};

  for (int epoch = 0; epoch < epochs; ++epoch) {
    for (long long w = 0; w < n_walks; ++w) {
      const int32_t* walk = walks + w * t_cols;
      long long eff = eff_len[w];
      if (eff > t_cols) eff = t_cols;
      float lr = alpha - (float)((alpha - min_alpha) *
                                 (done_tokens / (total_tokens > 1.0
                                                     ? total_tokens
                                                     : 1.0)));
      if (lr < min_alpha) lr = min_alpha;
      pairs +=
          train_one_walk(tb, walk, eff, lr, rng, sent.data(), neu1e.data());
      done_tokens += (double)eff;
    }
  }
  return pairs;
}

// Hogwild variant: `workers` threads race lock-free updates into the
// shared tables (gensim's worker-thread model). Walks are strided
// across threads within each epoch, threads join between epochs, and
// the learning rate follows a shared atomic token counter — the same
// global-progress schedule gensim's job dispatcher approximates.
// Nondeterministic for workers > 1 (by design, like gensim).
long long pp_train_sgns_sequential_mt(
    const int32_t* walks, const int32_t* eff_len, long long n_walks,
    long long t_cols, float* w_in, float* w_out, long long n_nodes,
    long long dim, const float* keep_prob, const int32_t* neg_table,
    long long neg_table_size, int window, int negative, float alpha,
    float min_alpha, double total_tokens, int epochs, uint64_t seed,
    int workers) {
  if (workers <= 1) {
    return pp_train_sgns_sequential(
        walks, eff_len, n_walks, t_cols, w_in, w_out, n_nodes, dim,
        keep_prob, neg_table, neg_table_size, window, negative, alpha,
        min_alpha, total_tokens, epochs, seed);
  }
  std::atomic<long long> done_tokens{0};
  std::atomic<long long> pairs_total{0};
  SgnsTables tb{w_in,      w_out,  dim,    keep_prob,
                neg_table, neg_table_size, window, negative};
  const double denom = total_tokens > 1.0 ? total_tokens : 1.0;

  for (int epoch = 0; epoch < epochs; ++epoch) {
    std::vector<std::thread> threads;
    threads.reserve(workers);
    for (int tid = 0; tid < workers; ++tid) {
      threads.emplace_back([&, tid, epoch]() {
        // distinct, non-overlapping stream per (thread, epoch) —
        // mirrors the reference's per-thread seeding
        // (pecanpy.py:176-178); see mix64 for why the raw offset
        // (a multiple of the state increment) must be mixed first
        SplitMix64 rng(mix64(seed + 0x9E3779B97f4A7C15ULL *
                                        (uint64_t)(1 + tid +
                                                   epoch * workers)));
        std::vector<int32_t> sent(t_cols);
        std::vector<float> neu1e(dim);
        long long local_pairs = 0;
        for (long long w = tid; w < n_walks; w += workers) {
          const int32_t* walk = walks + w * t_cols;
          long long eff = eff_len[w];
          if (eff > t_cols) eff = t_cols;
          double done =
              (double)done_tokens.load(std::memory_order_relaxed);
          float lr = alpha - (float)((alpha - min_alpha) * (done / denom));
          if (lr < min_alpha) lr = min_alpha;
          local_pairs += train_one_walk(tb, walk, eff, lr, rng,
                                        sent.data(), neu1e.data());
          done_tokens.fetch_add(eff, std::memory_order_relaxed);
        }
        pairs_total.fetch_add(local_pairs, std::memory_order_relaxed);
      });
    }
    for (auto& t : threads) t.join();
  }
  return pairs_total.load();
}

}  // extern "C"
