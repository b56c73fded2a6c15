// Rejection-trial kernels of the hub walkers for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels pecanpy_tpu/ops/trialkernel.py:_k1_propose
// (trial_propose) and :_k2_accept (trial_accept). Together they compute
// ops/rejection.py:_trial_block for node2vec (extend=False): T iid
// proposals per walker lane, each accepted with probability
// alpha(x) / alpha_np, first accepted wins.
//
//   trial_propose: per lane and trial, x ~ w(cur, .) and w(cur, x).
//     A capped cur row draws by inverse CDF over its carried fused row:
//     count the slots with cdf < u * total, from the packed cdf channel or
//     from a prefix sum of the wgt channel. A hub cur row (slot 0 of the
//     nbr channel > N) loads alias slot base + kk of the flat edge_pack
//     and takes self or alias against its acceptance. Then the return-edge
//     atom: u_atom < theta gives x = prev, w = w(cur, prev).
//   trial_accept: per lane and trial, is x a neighbor of prev? A hub prev
//     probes the 8 keys of its hash bucket (uint32 Knuth hash of x, masked
//     to the hub's bucket count); a capped prev compares x with its
//     carried nbr row. Then alpha in {1/p, 1, 1/q}, the accept bit
//     u_acc < alpha / alpha_np (always on for x == prev with the atom),
//     force_ok, and the first-accepted-wins combine into
//     (chosen, got, chosen_w).
//
// Design: one warp per walker lane, all trials inside that warp. The 32
// threads read a 128-slot channel in four coalesced 128-byte chunks; the
// CDF count is a ballot + popc per chunk, membership an __any_sync. Hub
// lanes take a warp-uniform branch that skips the row entirely. The TPU
// kernels' [L, 1] operand blocks and super-row mask-selects were TPU
// layout tricks and are not carried over: the flat tables are indexed
// directly.
//
// Exactness: the arithmetic is the plain version's, in the same order
// where it can matter: u * total, and alpha / alpha_np as a true IEEE
// division (no -use_fast_math). With the cdf channel, kernel and plain
// agree bit for bit. Without it, the warp's prefix sum adds in another
// order than torch.cumsum, so float weights can land a draw on the
// neighboring slot at a category boundary; integer weights stay exact.
// Neighbor ids are int32 bit patterns inside float lanes (small ids are
// denormals): they are read through int pointers, never through float
// arithmetic. Indices computed from a capped row's nbr slots would be
// garbage (those slots hold ids, not markers), so table loads happen only
// on hub lanes, and every table index is clamped into its table.
//
// What bounds it: bytes, and the latency of dependent loads. Per lane a
// capped row costs one dpad-float channel read (512 B at dpad = 128) in
// each kernel; a hub row costs a 32 B alias slot per trial in
// trial_propose and a 32 B bucket key read per trial in trial_accept.
// The arithmetic is a few dozen operations per lane. chip_smoke.py states
// the bound from the lanes of the run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kEpWidth = 8;       // floats per logical edge_pack slot
constexpr int kEpAccept = 0;      // alias acceptance probability
constexpr int kEpNbrSelf = 1;     // int32 bits
constexpr int kEpWgtSelf = 2;
constexpr int kEpNbrAlias = 3;    // int32 bits
constexpr int kEpWgtAlias = 4;
constexpr int kHbWidth = 16;      // floats per logical bucket: 8 keys, 8 vals
constexpr int kBucketWidth = 8;
constexpr uint32_t kKnuth = 2654435761u;
constexpr int kMaxTrials = 8;
constexpr int kThreads = 256;     // 8 warps per block, one lane each

// Draws are [T, 4, B] floats: u_self, u_small, u_atom, u_acc.
enum { kUSelf = 0, kUSmall = 1, kUAtom = 2, kUAcc = 3 };

__device__ __forceinline__ float draw(const float* u, int t, int k,
                                      long long b, long long B) {
  return u[(static_cast<long long>(t) * 4 + k) * B + b];
}

// Inclusive warp prefix sum of this chunk's 32 values, plus the carry of
// the chunks before it; returns this lane's prefix and updates carry.
__device__ __forceinline__ float chunk_prefix(float v, int lane, float& carry) {
  float s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float n = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s += n;
  }
  s += carry;
  carry = __shfl_sync(kFull, s, 31);
  return s;
}

__global__ void trial_propose_kernel(
    const float* __restrict__ rows, long long stride, int dpad, int cdf_off,
    const float* __restrict__ ep, long long n_slots,
    const int* __restrict__ kk, const float* __restrict__ u,
    const float* __restrict__ theta, const float* __restrict__ wp,
    const int* __restrict__ prev, int* __restrict__ x_out,
    float* __restrict__ w_out, long long B, int T, int num_nodes) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;  // whole warp: b is uniform across it
  const float* row = rows + b * stride;
  const int* nbr = reinterpret_cast<const int*>(row);
  const float* wgt = row + dpad;
  const bool use_atom = theta != nullptr;
  const int head = nbr[0];

  if (head > num_nodes) {
    // hub: one resolved alias slot per trial, one thread per trial
    const int* epi = reinterpret_cast<const int*>(ep);
    const long long base = nbr[1];
    for (int t = lane; t < T; t += 32) {
      long long slot = base + kk[static_cast<long long>(t) * B + b];
      slot = slot < 0 ? 0 : (slot >= n_slots ? n_slots - 1 : slot);
      const long long o = slot * kEpWidth;
      const bool self = draw(u, t, kUSelf, b, B) < ep[o + kEpAccept];
      int x = self ? epi[o + kEpNbrSelf] : epi[o + kEpNbrAlias];
      float w = self ? ep[o + kEpWgtSelf] : ep[o + kEpWgtAlias];
      if (use_atom && draw(u, t, kUAtom, b, B) < theta[b]) {
        x = prev[b];
        w = wp[b];
      }
      x_out[static_cast<long long>(t) * B + b] = x;
      w_out[static_cast<long long>(t) * B + b] = w;
    }
    return;
  }

  // capped row: inverse CDF, count of slots with cdf < u * total
  const float* cdf = cdf_off >= 0 ? row + cdf_off : nullptr;
  float total;
  if (cdf != nullptr) {
    total = cdf[dpad - 1];
  } else {
    float carry = 0.f;
    for (int c0 = 0; c0 < dpad; c0 += 32) chunk_prefix(wgt[c0 + lane], lane, carry);
    total = carry;
  }
  float thr[kMaxTrials];
  int cnt[kMaxTrials];
#pragma unroll
  for (int t = 0; t < kMaxTrials; ++t) {
    thr[t] = t < T ? draw(u, t, kUSmall, b, B) * total : 0.f;
    cnt[t] = 0;
  }
  float carry = 0.f;
  for (int c0 = 0; c0 < dpad; c0 += 32) {
    const float cv = cdf != nullptr ? cdf[c0 + lane]
                                    : chunk_prefix(wgt[c0 + lane], lane, carry);
#pragma unroll
    for (int t = 0; t < kMaxTrials; ++t) {
      if (t < T) cnt[t] += __popc(__ballot_sync(kFull, cv < thr[t]));
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxTrials; ++t) {
    if (t < T && lane == t) {
      const int c = cnt[t] < dpad - 1 ? cnt[t] : dpad - 1;
      int x = nbr[c];
      float w = wgt[c];
      if (use_atom && draw(u, t, kUAtom, b, B) < theta[b]) {
        x = prev[b];
        w = wp[b];
      }
      x_out[static_cast<long long>(t) * B + b] = x;
      w_out[static_cast<long long>(t) * B + b] = w;
    }
  }
}

__global__ void trial_accept_kernel(
    const float* __restrict__ rows, long long stride, int dpad,
    const float* __restrict__ hb, long long n_buckets,
    const int* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ u, const int* __restrict__ prev,
    const uint8_t* __restrict__ force_ok, float inv_p, float inv_q,
    float alpha_np, int use_atom, int* __restrict__ chosen,
    uint8_t* __restrict__ got, float* __restrict__ chosen_w, long long B,
    int T, int num_nodes) {
  const long long b =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (b >= B) return;
  const int* pn = reinterpret_cast<const int*>(rows + b * stride);
  const int head = pn[0];
  const int pv = prev[b];

  // membership of each trial's x in nbr(prev), warp-uniform flags
  bool found[kMaxTrials];
  if (head > num_nodes) {
    const int* hbi = reinterpret_cast<const int*>(hb);
    const long long hbase = pn[2];
    const int hlog = pn[3];
    const uint32_t mask =
        (1u << static_cast<uint32_t>(hlog < 0 ? 0 : (hlog > 30 ? 30 : hlog))) - 1u;
#pragma unroll
    for (int t = 0; t < kMaxTrials; ++t) {
      if (t >= T) break;
      const int x = xs[static_cast<long long>(t) * B + b];
      long long bucket = hbase + static_cast<long long>(
                                     (static_cast<uint32_t>(x) * kKnuth) & mask);
      bucket = bucket < 0 ? 0 : (bucket >= n_buckets ? n_buckets - 1 : bucket);
      const bool hit = lane < kBucketWidth && hbi[bucket * kHbWidth + lane] == x;
      found[t] = __any_sync(kFull, hit);
    }
  } else {
    int x[kMaxTrials];
    bool hit[kMaxTrials];
#pragma unroll
    for (int t = 0; t < kMaxTrials; ++t) {
      x[t] = t < T ? xs[static_cast<long long>(t) * B + b] : 0;
      hit[t] = false;
    }
    for (int c0 = 0; c0 < dpad; c0 += 32) {
      const int v = pn[c0 + lane];
#pragma unroll
      for (int t = 0; t < kMaxTrials; ++t) hit[t] |= t < T && v == x[t];
    }
#pragma unroll
    for (int t = 0; t < kMaxTrials; ++t) found[t] = __any_sync(kFull, hit[t]);
  }

  if (lane != 0) return;
  const bool forced = force_ok != nullptr && force_ok[b] != 0;
  int ch = 0;
  bool g = false;
  float cw = 0.f;
#pragma unroll
  for (int t = 0; t < kMaxTrials; ++t) {
    if (t >= T) break;
    const int x = xs[static_cast<long long>(t) * B + b];
    const float w = ws[static_cast<long long>(t) * B + b];
    const bool is_prev = x == pv;
    const float alpha = is_prev ? inv_p : (found[t] ? 1.0f : inv_q);
    float accept = alpha / alpha_np;
    if (use_atom && is_prev) accept = 1.0f;
    const bool ok = (draw(u, t, kUAcc, b, B) < accept) || forced;
    if (t == 0 || !g) {
      ch = x;
      cw = w;
    }
    g = g || ok;
  }
  chosen[b] = ch;
  got[b] = g ? 1 : 0;
  chosen_w[b] = cw;
}

int grid_of(long long B, unsigned* grid) {
  const long long blocks = (B * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  *grid = static_cast<unsigned>(blocks);
  return 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch's
// cudaGetLastError() code, 0 on success. rows: [B, stride] float32 fused
// rows (nbr channel at 0, wgt at dpad, cdf at cdf_off or -1); ep:
// [n_slots, 8] and hb: [n_buckets, 16] flat hub tables; kk: [T, B] int32;
// u: [T, 4, B] float32; xs/x_out: [T, B] int32; ws/w_out: [T, B] float32;
// theta/wp (both or neither) and force_ok may be null. A graph without
// hubs has empty tables, which no lane reads.
extern "C" int pecanpy_trial_propose(
    const float* rows, long long stride, int dpad, int cdf_off,
    const float* ep, long long n_slots, const int* kk, const float* u,
    const float* theta, const float* wp, const int* prev, int* x_out,
    float* w_out, long long B, int T, int num_nodes, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || T > kMaxTrials || dpad % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  if (int err = grid_of(B, &grid)) return err;
  trial_propose_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, stride, dpad, cdf_off, ep, n_slots, kk, u, theta, wp, prev, x_out,
      w_out, B, T, num_nodes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pecanpy_trial_accept(
    const float* rows, long long stride, int dpad, const float* hb,
    long long n_buckets, const int* xs, const float* ws, const float* u,
    const int* prev, const uint8_t* force_ok, float inv_p, float inv_q,
    float alpha_np, int use_atom, int* chosen, uint8_t* got, float* chosen_w,
    long long B, int T, int num_nodes, void* stream) {
  if (B <= 0) return 0;
  if (T < 1 || T > kMaxTrials || dpad % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  unsigned grid = 0;
  if (int err = grid_of(B, &grid)) return err;
  trial_accept_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, stride, dpad, hb, n_buckets, xs, ws, u, prev, force_ok, inv_p,
      inv_q, alpha_np, use_atom, chosen, got, chosen_w, B, T, num_nodes);
  return static_cast<int>(cudaGetLastError());
}
