// Rejection-trial kernels of the hub walkers for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels pecanpy_tpu/ops/trialkernel.py:_k1_propose
// (trial_propose) and :_k2_accept (trial_accept). Together they compute
// ops/rejection.py:_trial_block for node2vec (extend=False): T iid
// proposals per walker lane, each accepted with probability
// alpha(x) / alpha_np, first accepted wins.
//
//   trial_propose: per lane and trial, x ~ w(cur, .) and w(cur, x).
//     A capped cur row draws by inverse CDF: count the slots with
//     cdf < u * total, from the packed cdf channel or from a prefix sum of
//     the wgt channel. A hub cur row (slot 0 of the nbr channel > N) loads
//     alias slot base + kk of the flat edge_pack and takes self or alias
//     against its acceptance. Then the return-edge atom: u_atom < theta
//     gives x = prev, w = w(cur, prev).
//   trial_accept: per lane and trial, is x a neighbor of prev? A hub prev
//     probes the 8 keys of its hash bucket (uint32 Knuth hash of x, masked
//     to the hub's bucket count); a capped prev compares x with its nbr
//     slots. Then alpha in {1/p, 1, 1/q}, the accept bit
//     u_acc < alpha / alpha_np (always on for x == prev with the atom),
//     force_ok, and the first-accepted-wins combine into
//     (chosen, got, chosen_w).
//
// Both kernels take node ids and read the fused table (dg.fused, any row
// stride), the degrees (dg.deg) and the hub tables themselves: no caller
// gathers or carries rows for them.
//
// What bounds them on this card: the latency of dependent loads, not
// bytes. A lane's loads form a chain: its ids, then its row's head, then
// the rest of the row or its alias slots or hash bucket, then the picked
// slot. The bytes are small (chip_smoke.py counts them from the lanes'
// real degrees: 10.4 MB and 4.9 MB at 32,768 lanes and 2 trials, 3.1 and
// 1.5 us at 3.35 TB/s), so the time is the chain's round trips times the
// number of waves the lanes take.
//
// Design, against that:
// - A group of kGroup threads per lane, kThreads / kGroup lanes per block,
//   at most 8 trials, spread over the group's threads on the hub branch.
//   At kGroup = 4, 32,768 lanes are 131,072 threads: one resident wave at
//   1,024 threads (64 registers each) on each of the 132 SMs. The previous
//   design put a warp on each lane: about 3.9 waves of the card's 8,448
//   resident warps, each wave paying the whole chain.
// - Round 0 loads everything that depends only on the lane index (ids,
//   draws, theta, wp, x, force_ok) at once. Round 1 loads, at once, the
//   row's degree, its hub marker (a hub's alias base, hash base and log)
//   and the first 128 B of its count channel (propose: cdf, or wgt for
//   the prefix sum; accept: nbr) in float4 loads; propose also reads
//   the cdf channel's last slot, the total the plain version divides by.
// - A capped row then loads only the steps of 4 * kGroup slots that hold
//   its first min(deg, dpad) slots, all at once, after the head has been
//   counted; a hub row loads its trials' alias slots or all T bucket-key
//   rows before any reduction. The CDF count is a per-thread count and
//   one group sum per trial; membership is a group-wide OR of hit bits.
// - The picked slot's nbr and wgt are one 4-byte load each (holding the
//   nbr head in registers instead cost spills). A capped row of degree at
//   most 32 and a hub row finish in three rounds, a wider row in four.
// - Padded slots hold nbr = N, weight 0 and cdf equal to the total, so
//   reading only [0, deg) gives the count and the membership of the whole
//   row; x == N (the dead row's pick) is a member iff the row has
//   padding, as it is in the plain compare over all dpad slots.
// - The kernels are templates on T (and propose on the cdf channel), so
//   the per-trial arrays live in registers sized to the launch.
//
// Constants, from profile_port.py --sections trial-sweep: each build timed
// in a process of its own, in turns, on chip_smoke.py 6b's 32,768 edge
// lanes of the 1M-node power-law graph, 2 trials, cdf channel; one NVIDIA
// H100 80GB HBM3 at 700.00 W. Device ms (torch.profiler, mean of 20),
// propose / accept, with ptxas's registers (spilled bytes) at T = 2:
//   previous design, a warp per lane .... 0.0206 / 0.0188, 0.0207 / 0.0190
//   kGroup 4,  kMinBlocks 4 (chosen) .... 0.0059 / 0.0049   48 / 48 regs
//   kGroup 4,  kMinBlocks 8 ............. 0.0088 / 0.0059   32 (spills)
//   kGroup 8,  kMinBlocks 8 ............. 0.0066 / 0.0058   32 (12 B) / 32 (18 B)
//   kGroup 8,  kMinBlocks 4 ............. 0.0072 / 0.0061   40 / 46 regs
//   kGroup 16, kMinBlocks 4 ............. 0.0100 / 0.0089
//   kGroup 32, kMinBlocks 4 ............. 0.0141 / 0.0111
// Fewer threads per lane win while the lanes still fit in one wave; a
// 32-register cap (kMinBlocks 8) buys occupancy with spills that cost
// more. kThreads = 256: eight warps a block, 64 lanes.
//
// Exactness: the arithmetic is the plain version's, in the same order
// where it can matter: u * total, and alpha / alpha_np as a true IEEE
// division (no -use_fast_math). With the cdf channel, kernel and plain
// agree bit for bit. Without it, the group's prefix sum adds in another
// order than torch.cumsum, so float weights can land a draw on the
// neighboring slot at a category boundary; integer weights stay exact.
// Neighbor ids are int32 bit patterns inside float lanes (small ids are
// denormals): they are read through int pointers, never through float
// arithmetic. Indices computed from a capped row's nbr slots would be
// garbage (those slots hold ids, not markers), so table loads happen only
// on hub lanes, and every id and table index is clamped into its table.
#include <cooperative_groups.h>
#include <cooperative_groups/reduce.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kGroup = 4;        // threads per walker lane
constexpr int kThreads = 256;    // threads per block
constexpr int kMinBlocks = 4;    // resident blocks per SM asked of ptxas: 64 registers
constexpr int kLanesPerBlock = kThreads / kGroup;
constexpr int kStep = 4 * kGroup;  // slots of one float4 per thread
constexpr int kHeadSlots = 32;     // round 1 reads 128 B of a channel
constexpr int kHeadSteps = (kHeadSlots + kStep - 1) / kStep;
// steps a row of 128 slots has beyond the head, loaded at once in round 2
constexpr int kBatch = 128 / kStep - kHeadSteps > 0 ? 128 / kStep - kHeadSteps : 1;
constexpr int kRegSteps = kHeadSteps + kBatch;  // steps kept in registers
constexpr int kMaxTrials = 8;

constexpr int kEpWidth = 8;       // floats per logical edge_pack slot
constexpr int kEpWgtAlias = 4;    // (accept, nbr self, wgt self, nbr alias) precede it
constexpr int kHbWidth = 16;      // floats per logical bucket: 8 keys, 8 vals
constexpr uint32_t kKnuth = 2654435761u;

static_assert(kGroup >= 4 && kGroup <= 32 && (kGroup & (kGroup - 1)) == 0,
              "kGroup is a power of two in 4..32");
static_assert(kThreads % 32 == 0 && kThreads % kGroup == 0, "whole warps, whole groups");

using Tile = cg::thread_block_tile<kGroup, cg::thread_block>;

// Draws are [T, 4, B] floats: u_self, u_small, u_atom, u_acc.
enum { kUSelf = 0, kUSmall = 1, kUAtom = 2, kUAcc = 3 };

__device__ __forceinline__ float draw(const float* u, int t, int k,
                                      long long b, long long B) {
  return u[(static_cast<long long>(t) * 4 + k) * B + b];
}

__device__ __forceinline__ long long clamp_ll(long long v, long long hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ int4 load4i(const float* p) {
  return *reinterpret_cast<const int4*>(p);
}

// first slot of step j in this thread's float4
__device__ __forceinline__ int slot_of(int rank, int j) {
  return 4 * (rank + kGroup * j);
}

__device__ __forceinline__ int count_below(const float4& v, float thr) {
  return int(v.x < thr) + int(v.y < thr) + int(v.z < thr) + int(v.w < thr);
}

// In-place inclusive prefix sum of the group's step of 4 * kGroup values
// (each thread's float4 in rank order), plus carry; returns the new carry.
__device__ __forceinline__ float step_prefix(const Tile& tile, float4& v, float carry) {
  v.y += v.x;
  v.z += v.y;
  v.w += v.z;
  float incl = v.w;
#pragma unroll
  for (int o = 1; o < kGroup; o <<= 1) {
    const float lower = tile.shfl_up(incl, o);
    if (static_cast<int>(tile.thread_rank()) >= o) incl += lower;
  }
  float before = tile.shfl_up(incl, 1);
  before = (tile.thread_rank() == 0 ? 0.f : before) + carry;
  v.x += before;
  v.y += before;
  v.z += before;
  v.w += before;
  return tile.shfl(v.w, kGroup - 1);
}

template <int T, bool kCdf>
__global__ void __launch_bounds__(kThreads, kMinBlocks) trial_propose_kernel(
    const float* __restrict__ fused, long long stride, int dpad, int cdf_off,
    const int* __restrict__ deg, const float* __restrict__ ep, long long n_slots,
    const int* __restrict__ kk, const float* __restrict__ u,
    const float* __restrict__ theta, const float* __restrict__ wp,
    const int* __restrict__ prev, const int* __restrict__ cur,
    int* __restrict__ x_out, float* __restrict__ w_out, long long B, int num_nodes) {
  constexpr int kOwn = (T + kGroup - 1) / kGroup;  // trials per thread
  const Tile tile = cg::tiled_partition<kGroup>(cg::this_thread_block());
  const long long b = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  if (b >= B) return;  // the whole group: b is uniform across it
  const int rank = tile.thread_rank();

  // round 0: what depends only on the lane index
  const long long node = clamp_ll(cur[b], num_nodes - 1);
  float u_small[T];
#pragma unroll
  for (int t = 0; t < T; ++t) u_small[t] = draw(u, t, kUSmall, b, B);
  int own_kk[kOwn];
  float own_self[kOwn];
  bool own_atom[kOwn];
  int pv = 0;
  float wpv = 0.f;
  if (theta != nullptr) {
    pv = prev[b];
    wpv = wp[b];
  }
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int t = rank + i * kGroup;
    own_kk[i] = 0;
    own_self[i] = 0.f;
    own_atom[i] = false;
    if (t < T) {
      own_kk[i] = kk[static_cast<long long>(t) * B + b];
      own_self[i] = draw(u, t, kUSelf, b, B);
      own_atom[i] = theta != nullptr && draw(u, t, kUAtom, b, B) < theta[b];
    }
  }

  // round 1: the row's degree, hub marker and alias base, the head of its
  // count channel and, from the cdf channel, its last slot: the total the
  // plain version divides by (padding repeats it)
  const float* row = fused + node * stride;
  const float* cnt_ch = kCdf ? row + cdf_off : row + dpad;
  const int d = deg[node];
  const int2 marker = *reinterpret_cast<const int2*>(row);
  float total = kCdf ? cnt_ch[dpad - 1] : 0.f;
  float4 cv[kRegSteps];
#pragma unroll
  for (int j = 0; j < kHeadSteps; ++j) {
    const int s = slot_of(rank, j);
    cv[j] = s < dpad ? load4(cnt_ch + s) : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  if (marker.x > num_nodes) {
    // hub: one resolved alias slot per trial, one thread per trial
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int t = rank + i * kGroup;
      if (t >= T) continue;
      int x = pv;
      float w = wpv;
      if (!own_atom[i]) {
        const long long o = clamp_ll(marker.y + static_cast<long long>(own_kk[i]),
                                     n_slots - 1) * kEpWidth;
        const float4 a = load4(ep + o);  // accept, nbr self, wgt self, nbr alias
        const float w_alias = ep[o + kEpWgtAlias];
        const bool self = own_self[i] < a.x;
        x = self ? __float_as_int(a.y) : __float_as_int(a.w);
        w = self ? a.z : w_alias;
      }
      x_out[static_cast<long long>(t) * B + b] = x;
      w_out[static_cast<long long>(t) * B + b] = w;
    }
    return;
  }

  // capped row: inverse CDF over its first n slots (steps [0, steps)); the
  // padding beyond holds cdf = total, which no threshold u * total exceeds
  const int n = d < 0 ? 0 : (d > dpad ? dpad : d);
  const int steps = (n + kStep - 1) / kStep;
  float thr[T];
  int cnt[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    thr[t] = u_small[t] * total;
    cnt[t] = 0;
  }
  auto count = [&](const float4& v, int j) {
    if (j < steps && slot_of(rank, j) < dpad) {
#pragma unroll
      for (int t = 0; t < T; ++t) cnt[t] += count_below(v, thr[t]);
    }
  };
  if (kCdf) {  // the head counts before the rest arrives
#pragma unroll
    for (int j = 0; j < kHeadSteps; ++j) count(cv[j], j);
  }
  // round 2: the rest of the row, at once
#pragma unroll
  for (int j = kHeadSteps; j < kRegSteps; ++j) {
    const int s = slot_of(rank, j);
    cv[j] = j < steps && s < dpad ? load4(cnt_ch + s) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float carry = 0.f;
  if (!kCdf) {
    // prefix sums in place; rows wider than the registers sum the rest
    // from memory first, and the count below reads them again
#pragma unroll
    for (int j = 0; j < kRegSteps; ++j)
      if (j < steps) carry = step_prefix(tile, cv[j], carry);
    total = carry;
    for (int j = kRegSteps; j < steps; ++j) {
      const int s = slot_of(rank, j);
      float4 v = s < dpad ? load4(cnt_ch + s) : make_float4(0.f, 0.f, 0.f, 0.f);
      total = step_prefix(tile, v, total);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) thr[t] = u_small[t] * total;
#pragma unroll
    for (int j = 0; j < kHeadSteps; ++j) count(cv[j], j);
  }
#pragma unroll
  for (int j = kHeadSteps; j < kRegSteps; ++j) count(cv[j], j);
  for (int j = kRegSteps; j < steps; ++j) {  // a row wider than the registers
    const int s = slot_of(rank, j);
    float4 v = s < dpad ? load4(cnt_ch + s) : make_float4(0.f, 0.f, 0.f, 0.f);
    if (!kCdf) carry = step_prefix(tile, v, carry);
    count(v, j);
  }

  // the picked slot of each trial: its nbr and wgt, one load each
  const int* nbr = reinterpret_cast<const int*>(row);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    int c = cg::reduce(tile, cnt[t], cg::plus<int>());
    c = c < dpad - 1 ? c : dpad - 1;
    if (t % kGroup != rank) continue;
    const int i = t / kGroup;
    int x = pv;
    float w = wpv;
    if (!own_atom[i]) {
      x = nbr[c];
      w = row[dpad + c];
    }
    x_out[static_cast<long long>(t) * B + b] = x;
    w_out[static_cast<long long>(t) * B + b] = w;
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) trial_accept_kernel(
    const float* __restrict__ fused, long long stride, int dpad,
    const int* __restrict__ deg, const float* __restrict__ hb, long long n_buckets,
    const int* __restrict__ xs, const float* __restrict__ ws,
    const float* __restrict__ u, const int* __restrict__ prev,
    const uint8_t* __restrict__ force_ok, float inv_p, float inv_q,
    float alpha_np, int use_atom, int* __restrict__ chosen,
    uint8_t* __restrict__ got, float* __restrict__ chosen_w, long long B,
    int num_nodes) {
  constexpr int kOwn = (T + kGroup - 1) / kGroup;
  const Tile tile = cg::tiled_partition<kGroup>(cg::this_thread_block());
  const long long b = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / kGroup;
  if (b >= B) return;
  const int rank = tile.thread_rank();

  // round 0: what depends only on the lane index
  const int pv = prev[b];
  int x[T];
#pragma unroll
  for (int t = 0; t < T; ++t) x[t] = xs[static_cast<long long>(t) * B + b];
  float own_w[kOwn], own_u[kOwn];
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int t = rank + i * kGroup;
    own_w[i] = t < T ? ws[static_cast<long long>(t) * B + b] : 0.f;
    own_u[i] = t < T ? draw(u, t, kUAcc, b, B) : 0.f;
  }
  const bool forced = force_ok != nullptr && force_ok[b] != 0;

  // round 1: prev's degree and the head of its nbr channel
  const long long node = clamp_ll(pv, num_nodes - 1);
  const float* row = fused + node * stride;
  const int d = deg[node];
  int4 nb[kHeadSteps];
#pragma unroll
  for (int j = 0; j < kHeadSteps; ++j) {
    const int s = slot_of(rank, j);
    nb[j] = s < dpad ? load4i(row + s) : make_int4(0, 0, 0, 0);
  }
  const int head = tile.shfl(nb[0].x, 0);

  // membership of each trial's x in nbr(prev): bit t of found
  unsigned mine = 0;
  unsigned found = 0;
  if (head > num_nodes) {
    // hub prev: every trial's bucket keys at once, one thread per trial
    const long long hbase = tile.shfl(nb[0].z, 0);
    const int hlog = tile.shfl(nb[0].w, 0);
    const uint32_t mask =
        (1u << static_cast<uint32_t>(hlog < 0 ? 0 : (hlog > 30 ? 30 : hlog))) - 1u;
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      const int t = rank + i * kGroup;
      if (t >= T) continue;
      int xt = x[0];
#pragma unroll
      for (int tt = 1; tt < T; ++tt)
        if (tt == t) xt = x[tt];
      const long long bucket = clamp_ll(
          hbase + static_cast<long long>((static_cast<uint32_t>(xt) * kKnuth) & mask),
          n_buckets - 1);
      const int4 k0 = load4i(hb + bucket * kHbWidth);
      const int4 k1 = load4i(hb + bucket * kHbWidth + 4);
      const bool hit = k0.x == xt || k0.y == xt || k0.z == xt || k0.w == xt ||
                       k1.x == xt || k1.y == xt || k1.z == xt || k1.w == xt;
      mine |= static_cast<unsigned>(hit) << t;
    }
    found = cg::reduce(tile, mine, cg::bit_or<unsigned>());
  } else {
    // capped prev: its first n slots; the padding beyond holds N only
    const int n = d < 0 ? 0 : (d > dpad ? dpad : d);
    const int steps = (n + kStep - 1) / kStep;
    auto hits = [&](const int4& v, int j) {
      if (j >= steps || slot_of(rank, j) >= dpad) return;
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const bool h = v.x == x[t] || v.y == x[t] || v.z == x[t] || v.w == x[t];
        mine |= static_cast<unsigned>(h) << t;
      }
    };
#pragma unroll
    for (int j = 0; j < kHeadSteps; ++j) hits(nb[j], j);  // before the rest arrives
    int4 rest[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {  // round 2: the rest of the row, at once
      const int s = slot_of(rank, kHeadSteps + j);
      rest[j] = kHeadSteps + j < steps && s < dpad ? load4i(row + s)
                                                   : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) hits(rest[j], kHeadSteps + j);
    for (int j = kRegSteps; j < steps; ++j) {
      const int s = slot_of(rank, j);
      if (s < dpad) hits(load4i(row + s), j);
    }
    found = cg::reduce(tile, mine, cg::bit_or<unsigned>());
    if (steps * kStep < dpad) {  // unread padding: x == N is a member
#pragma unroll
      for (int t = 0; t < T; ++t) found |= static_cast<unsigned>(x[t] == num_nodes) << t;
    }
  }

  // accept bits of the owned trials, then first accepted wins
  unsigned ok_bits = 0;
#pragma unroll
  for (int i = 0; i < kOwn; ++i) {
    const int t = rank + i * kGroup;
    if (t >= T) continue;
    int xt = x[0];
#pragma unroll
    for (int tt = 1; tt < T; ++tt)
      if (tt == t) xt = x[tt];
    const bool is_prev = xt == pv;
    const float alpha = is_prev ? inv_p : (((found >> t) & 1u) ? 1.0f : inv_q);
    float accept = alpha / alpha_np;
    if (use_atom && is_prev) accept = 1.0f;
    const bool ok = (own_u[i] < accept) || forced;
    ok_bits |= static_cast<unsigned>(ok) << t;
  }
  ok_bits = cg::reduce(tile, ok_bits, cg::bit_or<unsigned>());
  const int first = ok_bits != 0 ? __ffs(ok_bits) - 1 : T - 1;
  float w_first = own_w[0];
#pragma unroll
  for (int i = 1; i < kOwn; ++i)
    if (i == first / kGroup) w_first = own_w[i];
  w_first = tile.shfl(w_first, first % kGroup);
  if (rank != 0) return;
  int ch = x[0];
#pragma unroll
  for (int t = 1; t < T; ++t)
    if (t == first) ch = x[t];
  chosen[b] = ch;
  got[b] = ok_bits != 0 ? 1 : 0;
  chosen_w[b] = w_first;
}

int check_launch(long long B, int T, int dpad, unsigned grid) {
  if (T < 1 || T > kMaxTrials || dpad <= 0 || dpad % 4 != 0 ||
      grid > 0x7fffffffu || static_cast<long long>(grid) * kLanesPerBlock < B)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int T>
void launch_propose(unsigned grid, cudaStream_t stream, bool use_cdf, const float* fused,
                    long long stride, int dpad, int cdf_off, const int* deg,
                    const float* ep, long long n_slots, const int* kk, const float* u,
                    const float* theta, const float* wp, const int* prev, const int* cur,
                    int* x_out, float* w_out, long long B, int num_nodes) {
  if (use_cdf)
    trial_propose_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        fused, stride, dpad, cdf_off, deg, ep, n_slots, kk, u, theta, wp, prev, cur,
        x_out, w_out, B, num_nodes);
  else
    trial_propose_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        fused, stride, dpad, cdf_off, deg, ep, n_slots, kk, u, theta, wp, prev, cur,
        x_out, w_out, B, num_nodes);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch's
// cudaGetLastError() code, 0 on success. fused: [N, *] float32 rows with
// row stride `stride` floats (nbr channel at 0, wgt at dpad, cdf at
// cdf_off or -1); deg: [N] int32; ep: [n_slots, 8] and hb: [n_buckets, 16]
// flat hub tables; cur/prev: [B] int32 node ids; kk: [T, B] int32;
// u: [T, 4, B] float32; xs/x_out: [T, B] int32; ws/w_out: [T, B] float32;
// theta/wp (both or neither) and force_ok may be null. grid: blocks of
// pecanpy_trial_lanes_per_block() lanes each, covering B (the wrapper's
// trial_grid). A graph without hubs has empty tables, which no lane reads.
extern "C" int pecanpy_trial_lanes_per_block() { return kLanesPerBlock; }

extern "C" int pecanpy_trial_propose(
    const float* fused, long long stride, int dpad, int cdf_off, const int* deg,
    const float* ep, long long n_slots, const int* kk, const float* u,
    const float* theta, const float* wp, const int* prev, const int* cur, int* x_out,
    float* w_out, long long B, int T, int num_nodes, unsigned grid, void* stream) {
  if (B <= 0) return 0;
  if (int err = check_launch(B, T, dpad, grid)) return err;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool use_cdf = cdf_off >= 0;
#define PECANPY_PROPOSE(TT)                                                              \
  case TT:                                                                              \
    launch_propose<TT>(grid, s, use_cdf, fused, stride, dpad, cdf_off, deg, ep, n_slots, \
                       kk, u, theta, wp, prev, cur, x_out, w_out, B, num_nodes);        \
    break;
  switch (T) {
    PECANPY_PROPOSE(1) PECANPY_PROPOSE(2) PECANPY_PROPOSE(3) PECANPY_PROPOSE(4)
    PECANPY_PROPOSE(5) PECANPY_PROPOSE(6) PECANPY_PROPOSE(7) PECANPY_PROPOSE(8)
  }
#undef PECANPY_PROPOSE
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pecanpy_trial_accept(
    const float* fused, long long stride, int dpad, const int* deg, const float* hb,
    long long n_buckets, const int* xs, const float* ws, const float* u,
    const int* prev, const uint8_t* force_ok, float inv_p, float inv_q,
    float alpha_np, int use_atom, int* chosen, uint8_t* got, float* chosen_w,
    long long B, int T, int num_nodes, unsigned grid, void* stream) {
  if (B <= 0) return 0;
  if (int err = check_launch(B, T, dpad, grid)) return err;
  const auto s = static_cast<cudaStream_t>(stream);
#define PECANPY_ACCEPT(TT)                                                              \
  case TT:                                                                             \
    trial_accept_kernel<TT><<<grid, kThreads, 0, s>>>(                                 \
        fused, stride, dpad, deg, hb, n_buckets, xs, ws, u, prev, force_ok, inv_p,     \
        inv_q, alpha_np, use_atom, chosen, got, chosen_w, B, num_nodes);               \
    break;
  switch (T) {
    PECANPY_ACCEPT(1) PECANPY_ACCEPT(2) PECANPY_ACCEPT(3) PECANPY_ACCEPT(4)
    PECANPY_ACCEPT(5) PECANPY_ACCEPT(6) PECANPY_ACCEPT(7) PECANPY_ACCEPT(8)
  }
#undef PECANPY_ACCEPT
  return static_cast<int>(cudaGetLastError());
}
