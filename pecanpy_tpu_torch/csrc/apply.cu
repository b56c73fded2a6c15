// Sorted-stream table applier for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pecanpy_tpu/ops/apply.py:_applier_kernel.
// Both compute, for a stream of R payload rows sorted by destination row
// id and already scaled by lr * min(total, cap) / total per group:
//
//     table[i] -= sum of the payload rows whose id is i
//
// in place; ids outside [0, N) are dropped, and rows that no id names are
// never read or written. A bf16 table is read as f32, updated in f32 and
// written back with stochastic rounding, so updates far below one bf16
// ulp still move the table in expectation.
//
// Design. The TPU kernel tiles the table and folds stream chunks in with
// one-hot matmuls, because its grid runs in order on one core. Here the
// blocks run in parallel in no order, so the work is a segmented
// reduction (a segment: the run of rows with one id), in two passes that
// one entry point launches back to back on one stream, with no host
// synchronisation, no host plan and no read of a count on the host:
//
// 1. The short pass: one warp per stream row r. Only segment heads work
//    (r == 0 or ids[r] != ids[r-1]); every other warp exits at once. The
//    stream is sorted, so a head's segment has more than kLongRows rows
//    iff ids[r + kLongRows] is its id: one load, made together with the
//    others the warp needs (its own id, the one before, the 32 after it). A short segment's warp starts the load of its table
//    row, sums the segment's payload rows in registers (lanes stride over
//    D, four floats a lane when D % 4 == 0), then subtracts and writes
//    the row once. A long segment's head warp finds the segment's end
//    with a gallop over the ids (first_above) and appends (first row, end,
//    id) to a list in device memory, behind a counter that the launcher
//    zeroes with cudaMemsetAsync.
// 2. The long pass: a fixed grid of one-warp blocks (SMs x resident
//    blocks) takes the items (long segment, slab of kSlab columns) in a
//    grid-stride loop, so the host never learns how many there are. A
//    block streams its slab's payload rows through a ring of kStages
//    stages of kStageRows rows in shared memory, filled by cp.async, lane
//    c adding column c, then reads, subtracts and writes the table row's
//    slab once.
//
// Each touched row is written by exactly one warp of one pass (a slab of
// it, in the long pass): no atomics on the table, and the result does not
// depend on scheduling. Both passes add each column's payload in stream
// order from 0 (no fused multiply-add, nothing reassociated), so the
// result is the plain version's (ops/apply.py:apply_sorted_stream_plain)
// and the windowed kernel's (csrc/apply_v2.cu) to the bit, and a bf16 slab
// rounds its columns with the (seed, row, col) hash as the short pass
// would. The price: a segment of n rows is summed serially in f32, so its
// error grows with n, up to gamma(n - 1) * sum |x| (gamma(k) = k u /
// (1 - k u), u = 2^-24), the bound tests/test_torch_kernels.py holds it to.
//
// What bounds it. The short pass: bytes. It reads the R x D x 4 payload
// bytes once and reads and writes each touched table row once; there is
// no arithmetic to speak of, and keeping each segment's sum in registers
// keeps the table traffic at one read and one write per touched row. The
// long pass: first the rate at which one warp streams its rows, then the
// chain of n dependent f32 adds per column, about 4 cycles each (about
// 2 us per 1,000 rows), whatever the slab. Before this design one warp
// walked every segment with about four loads in flight: a segment of
// 5,000 rows took 1.0 ms, and an SGNS stream whose hottest ids hold 300
// rows each took 0.11 ms where its bytes need 0.04.
//
// The constants, chosen with profile_port.py --sections apply-sweep on one
// NVIDIA H100 80GB HBM3 at 700 W (device time of the whole call, bf16 /
// f32, on chip_smoke.py's stream with a 5,000-row segment among 100,035
// rows into a [1M, 128] table; phase 3's W_in stream, as long but
// without that segment, takes 0.050 / 0.062 ms): slabs of 32 columns in a ring of 8 x 16 rows 0.1755 / 0.1866
// ms, and 16 x 16 rows no faster, so one warp's rate, not the ring's
// depth, was the limit; 16 columns in 12 x 64 rows 0.1065 / 0.1170; 8
// columns 0.0896 / 0.1018, and in 12 x 128 rows 0.0814 / 0.0930; 4 columns
// in 12 x 64 rows 0.0830 / 0.0917, 12 x 128 rows 0.0700 / 0.0808, and 8 x
// 256 rows (chosen) 0.0667 / 0.0779, within 4% of 12 x 256 and of 4 x 512
// rows. Narrower slabs put more warps on one segment, and longer stages
// wait less often. kLongRows of 16, 64 and 128 moved no stream by more
// than 1%: their shorter segments are rare there. 32 keeps every short
// segment within one ballot of 32 ids and its warp to at most eight round
// trips of four rows.
//
// Stochastic rounding bits come from a counter-based hash of
// (seed, row, col) (apply_common.cuh), so the result is a pure function of
// the inputs.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "apply_common.cuh"

namespace {

constexpr int kLongRows = 32;   // a segment of more rows takes the long pass
constexpr int kSlab = 4;         // columns of one long-pass item, one a lane
constexpr int kStageRows = 256;  // payload rows of one ring stage
constexpr int kStages = 8;       // stages in one long-pass block's ring
static_assert(kSlab <= 32 && kSlab % 4 == 0, "a slab's columns map onto lanes");
static_assert(kStages * kStageRows * kSlab * sizeof(float) <= 48 * 1024,
              "the ring is static shared memory");

// The short pass. kBf16: the table holds bf16 bit patterns (uint16_t),
// else float. kVec4: D % 4 == 0 and 16-byte aligned payload / table rows.
template <bool kBf16, bool kVec4>
__global__ void apply_sorted_kernel(void* __restrict__ table_v,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ upd,
                                    long long R, long long N, int D,
                                    uint32_t seed, long long* __restrict__ segs) {
  using Elem = typename std::conditional<kBf16, uint16_t, float>::type;
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warp: r is uniform across it
  // every id the warp may need, loaded at once: its own, the one before,
  // the one kLongRows on, and the 32 after it (one a lane)
  const long long j = r + 1 + lane;
  const int id = ids[r];
  const int before = r > 0 ? ids[r - 1] : ~id;
  const int ahead = r + kLongRows < R ? ids[r + kLongRows] : ~id;
  const int next = j < R ? ids[j] : ~id;
  if (before == id) return;  // not a segment head
  // an out-of-range id names no row: its segment is dropped (the JAX
  // package's scatter semantics), never written out of bounds
  if (id < 0 || id >= N) return;
  if (ahead == id) {  // more than kLongRows rows: the long pass sums it
    // rows r .. r + kLongRows hold the id: its end lies beyond them
    const long long e = first_above(ids, r + kLongRows + 1, R, id, lane);
    if (lane == 0) {
      const unsigned long long k =
          atomicAdd(reinterpret_cast<unsigned long long*>(segs), 1ull);
      long long* seg = segs + 1 + 3 * k;
      seg[0] = r;
      seg[1] = e;
      seg[2] = id;
    }
    return;
  }
  const unsigned m = __ballot_sync(kFull, next != id);
  // one past the segment's last row (rows r + 1 .. r + 32 all hold the id
  // only where kLongRows > 32)
  const long long e = m ? r + __ffs(m) : first_above(ids, r + 33, R, id, lane);
  const long long row_off = static_cast<long long>(id) * D;
  Elem* table = static_cast<Elem*>(table_v) + row_off;

  if (kVec4) {
    for (int c = lane * 4; c < D; c += 128) {
      // the table row's four elements, loaded before the payload rows
      uint2 raw;
      float4 tv;
      if constexpr (kBf16) raw = *reinterpret_cast<const uint2*>(table + c);
      else tv = *reinterpret_cast<const float4*>(table + c);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (long long k = r; k < e; ++k) {
        const float4 v =
            *reinterpret_cast<const float4*>(upd + k * D + c);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      if constexpr (kBf16) {
        const float t0 = bf16_to_f32(raw.x & 0xffffu) - acc.x;
        const float t1 = bf16_to_f32(raw.x >> 16) - acc.y;
        const float t2 = bf16_to_f32(raw.y & 0xffffu) - acc.z;
        const float t3 = bf16_to_f32(raw.y >> 16) - acc.w;
        uint2 out;
        out.x = static_cast<uint32_t>(sr_bf16(t0, seed, id, c)) |
                (static_cast<uint32_t>(sr_bf16(t1, seed, id, c + 1)) << 16);
        out.y = static_cast<uint32_t>(sr_bf16(t2, seed, id, c + 2)) |
                (static_cast<uint32_t>(sr_bf16(t3, seed, id, c + 3)) << 16);
        *reinterpret_cast<uint2*>(table + c) = out;
      } else {
        tv.x -= acc.x;
        tv.y -= acc.y;
        tv.z -= acc.z;
        tv.w -= acc.w;
        *reinterpret_cast<float4*>(table + c) = tv;
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      const Elem t = table[c];
      float acc = 0.f;
#pragma unroll 4
      for (long long k = r; k < e; ++k) acc += upd[k * D + c];
      if constexpr (kBf16) table[c] = sr_bf16(bf16_to_f32(t) - acc, seed, id, c);
      else table[c] = t - acc;
    }
  }
}

// The long pass: one warp a block. segs[0] is the number of long segments,
// then (first row, one past the last, id) for each, in no order. kVec:
// payload rows move in 16-byte copies (D % 4 == 0, 16-byte aligned), else
// in 4-byte ones.
template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(32)
    apply_long_kernel(void* __restrict__ table_v, const float* __restrict__ upd,
                      int D, uint32_t seed, const long long* __restrict__ segs) {
  using Elem = typename std::conditional<kBf16, uint16_t, float>::type;
  __shared__ __align__(16) float ring[kStages][kStageRows][kSlab];
  const int lane = threadIdx.x;
  const int nslab = (D + kSlab - 1) / kSlab;
  const long long items = segs[0] * nslab;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const long long* seg = segs + 1 + 3 * (it / nslab);
    const long long r = seg[0];
    const long long e = seg[1];
    const int id = static_cast<int>(seg[2]);
    const int c0 = static_cast<int>(it % nslab) * kSlab;
    const int width = min(kSlab, D - c0);
    Elem* t = static_cast<Elem*>(table_v) + static_cast<long long>(id) * D + c0;
    const Elem t_old = lane < width ? t[lane] : Elem(0);  // read while the ring fills
    const float* src = upd + r * D + c0;
    const long long n = e - r;
    const long long nst = (n + kStageRows - 1) / kStageRows;
    auto load = [&](long long s) {  // stage s into its slot, as one group
      const long long row0 = s * kStageRows;
      const int rows = static_cast<int>(min(static_cast<long long>(kStageRows), n - row0));
      float* dst = &ring[s % kStages][0][0];
      constexpr int kPer = kVec ? 4 : 1;     // floats a copy
      constexpr int kCopies = kSlab / kPer;  // copies a row
      for (int q = lane; q < rows * kCopies; q += 32) {
        const int i = q / kCopies, k = kPer * (q % kCopies);
        if (k >= width) continue;
        if constexpr (kVec) cp_async16(dst + i * kSlab + k, src + (row0 + i) * D + k);
        else cp_async4(dst + i * kSlab + k, src + (row0 + i) * D + k);
      }
      cp_async_commit();
    };
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nst) load(s);
      else cp_async_commit();  // an empty group keeps the count of groups
    }
    float acc = 0.f;
    for (long long s = 0; s < nst; ++s) {
      cp_async_wait<kStages - 2>();  // stage s has landed, for this lane
      __syncwarp();                  // and for every lane
      // into the slot of stage s - 1, which every lane has folded
      if (s + kStages - 1 < nst) load(s + kStages - 1);
      else cp_async_commit();
      const float* st = &ring[s % kStages][0][lane % kSlab];  // lanes >= kSlab idle
      const long long rows = min(static_cast<long long>(kStageRows), n - s * kStageRows);
      if (rows == kStageRows) {
#pragma unroll
        for (int i = 0; i < kStageRows; ++i) acc += st[i * kSlab];
      } else {
        for (int i = 0; i < rows; ++i) acc += st[i * kSlab];
      }
      __syncwarp();  // the slot is free for stage s + kStages
    }
    cp_async_wait<0>();
    __syncwarp();
    if (lane < width) {
      if constexpr (kBf16) t[lane] = sr_bf16(bf16_to_f32(t_old) - acc, seed, id, c0 + lane);
      else t[lane] = t_old - acc;
    }
  }
}

// The long pass's grid: SMs x resident blocks, queried once per device
// and instantiation.
template <bool kBf16, bool kVec>
cudaError_t long_grid(int* grid) {
  static int per_sm[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (per_sm[dev] == 0) {
    void (*kernel)(void*, const float*, int, uint32_t, const long long*) =
        apply_long_kernel<kBf16, kVec>;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, 32, 0);
    if (err != cudaSuccess) return err;
    if (n == 0) return cudaErrorInvalidConfiguration;
    per_sm[dev] = n;
  }
  const int sms = sm_count(dev, &err);
  if (err != cudaSuccess) return err;
  *grid = sms * per_sm[dev];
  return cudaSuccess;
}

// long longs of scratch a stream of R rows needs: the count of long
// segments, and three for each of at most R / (kLongRows + 1).
long long scratch_len(long long R) {
  return R > kLongRows ? 1 + 3 * (R / (kLongRows + 1)) : 0;
}

template <bool kBf16, bool kVec>
int launch_passes(void* table, const int* ids, const float* upd, long long R,
                  long long N, int D, uint32_t seed, long long* scratch,
                  cudaStream_t s) {
  constexpr int kThreads = 256;  // 8 warps, one stream row each
  const long long blocks = (R * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool maybe_long = R > kLongRows;
  if (maybe_long) {
    const cudaError_t err = cudaMemsetAsync(scratch, 0, sizeof(long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  apply_sorted_kernel<kBf16, kVec><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      table, ids, upd, R, N, D, seed, scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !maybe_long) return static_cast<int>(err);
  int grid = 0;
  err = long_grid<kBf16, kVec>(&grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  // no more items than the stream could hold
  const long long items = (R / (kLongRows + 1)) * ((D + kSlab - 1) / kSlab);
  if (items < grid) grid = static_cast<int>(items);
  if (grid > 0) {
    apply_long_kernel<kBf16, kVec><<<grid, 32, 0, s>>>(table, upd, D, seed, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16>
int launch(void* table, const int* ids, const float* upd, long long R,
           long long N, int D, uint32_t seed, long long* scratch,
           long long scratch_size, void* stream) {
  if (R <= 0) return 0;
  if (scratch_size < scratch_len(R)) return static_cast<int>(cudaErrorInvalidValue);
  const size_t align = kBf16 ? 8 : 16;  // one 4-element group per lane
  const bool vec4 = D % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % align == 0 &&
                    reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch_passes<kBf16, true>(table, ids, upd, R, N, D, seed, scratch, s)
              : launch_passes<kBf16, false>(table, ids, upd, R, N, D, seed, scratch, s);
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launches' CUDA
// error code, 0 on success. ids: [R] int32 sorted ascending; upd: [R, D]
// float32 row-major; table: [N, D] row-major, updated in place on
// `stream`; scratch: device memory of at least
// pecanpy_apply_sorted_scratch(R) long longs, which the launches use and
// no other work may touch until they end.
extern "C" int pecanpy_apply_sorted_f32(float* table, const int* ids,
                                        const float* upd, long long R,
                                        long long N, int D, unsigned seed,
                                        long long* scratch, long long scratch_size,
                                        void* stream) {
  return launch<false>(table, ids, upd, R, N, D, seed, scratch, scratch_size, stream);
}

extern "C" int pecanpy_apply_sorted_bf16(uint16_t* table, const int* ids,
                                         const float* upd, long long R,
                                         long long N, int D, unsigned seed,
                                         long long* scratch, long long scratch_size,
                                         void* stream) {
  return launch<true>(table, ids, upd, R, N, D, seed, scratch, scratch_size, stream);
}

// The long longs of scratch a stream of R rows needs (0 for R <= the
// longest short segment, pecanpy_apply_long_rows()).
extern "C" long long pecanpy_apply_sorted_scratch(long long R) { return scratch_len(R); }

// A segment of more rows than this takes the long pass.
extern "C" int pecanpy_apply_long_rows() { return kLongRows; }

extern "C" const char* pecanpy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
