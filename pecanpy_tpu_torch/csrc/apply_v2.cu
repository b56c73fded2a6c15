// Windowed sorted-stream table applier for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pecanpy_tpu/ops/apply.py:_applier_kernel_v2
// (:296, called at :413). It computes the function of csrc/apply.cu (the
// port of _applier_kernel): for a stream of R payload rows sorted by
// destination row id and already scaled,
//
//     table[i] -= sum of the payload rows whose id is i
//
// in place; ids outside [0, N) are dropped, and rows that no id names are
// never read or written. A bf16 table is read as f32, updated in f32 and
// written back with stochastic rounding from the same (seed, row, col)
// hash as csrc/apply.cu. The result is bit-equal to that kernel's: each
// table row has one owner, which sums the row's payload in stream order
// from 0 in f32 and computes t - sum once. No atomics.
//
// What bounds it: bytes. There is no arithmetic to speak of. A pass must
// read the ids and the f32 payload once and read and write each touched
// table row once: at R = 132,803 rows into a [1M, 128] bf16 table that is
// 131.14 MB, 0.0391 ms at 3.35 TB/s.
//
// Why the first design missed that. It ran one block per 32-row table
// tile, 31,250 blocks at N = 1M, each folding about four stream rows
// through a [32, D] f32 accumulator that it zeroed first, after a chain of
// dependent loads (its window plan, its first window, its slice bounds,
// the slice's ids, the table row, the store), in about 34 waves. On one
// NVIDIA H100 80GB HBM3 at a 700.00 W power limit that took 0.1903 ms of
// device time, and 0.4783 ms by CUDA events once the host had built the
// plan with a dozen small torch ops: latency, not bytes, set its time.
//
// The design here. Persistent blocks: the launcher starts as many blocks
// as fit on the card at once (SMs times resident blocks, queried once per
// process and instantiation) and block b takes the stream rows
// [b R / G, (b + 1) R / G). A segment (the run of rows with one id)
// belongs to the block whose range holds its first row, and that block
// finishes it even where it runs past the range's end, so a hot row of
// thousands of entries has one owner, as it has one warp in csrc/apply.cu.
// Each block finds its own first and last row with a few warp-wide
// searches of the ids (no plan from the host); segments of ids < 0 belong
// to no block. The block streams its rows in windows of kWin rows through
// a ring of kStages buffers in shared memory, filled by cp.async groups:
// while window j folds, windows j + 1 .. j + kStages - 1 are in flight,
// the counterpart of the TPU kernel's make_async_copy + semaphore pairs.
// The group of window j also carries the table rows of the segments that
// end in window j, so the write-back never waits on a dependent load, and
// the ids of window j + kStages - 1, which tell the block which table rows
// the next group must fetch. The warps take the window's segments in turn,
// each lane four columns, so several segments fold at once: a version in
// which every warp walked every row of the window was bound by that serial
// chain of shared-memory loads, adds and rounding hashes (0.0968 ms of
// device time at the shapes above on the same card, against 0.0667 ms for
// this one in chip_smoke.py's phase 7a). A segment that runs on
// into the next window leaves its partial sum in one carry row in shared
// memory, which only warp 0 touches. Nothing is zeroed, each touched row
// is read once (with its last window) and written once (when its segment
// ends), and the stream is read once.
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "apply_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kWin = 16;       // stream rows per window
constexpr int kStages = 4;     // windows in the shared-memory ring
constexpr int kIdSlots = 2 * kStages;  // ids run kStages - 1 windows ahead
// Widest row: kStages f32 payload windows, kStages windows of table rows and
// one f32 carry row in shared memory, 64 x 448 x 8 + 448 x 4 + 544 =
// 231,712 bytes in f32 of the 232,448 a block may use
// (ops/apply.py: MAX_WINDOWED_DIM).
constexpr int kMaxDim = 448;
static_assert(kWin <= 32, "a window's rows map onto the lanes of a warp");

// Start the copies of the ids of the window at stream row r, and of the
// row after it (which says whether the window's last segment ends there).
__device__ __forceinline__ void load_ids(int* dst, const int* ids, int r, int end) {
  const int n = min(kWin + 1, end - r);
  for (int k = threadIdx.x; k < n; k += kThreads) cp_async4(dst + k, ids + r + k);
}

// Does the segment of window row i end there? The ids in `iw` start at
// stream row r0; `end` is one past the block's last row.
__device__ __forceinline__ bool segment_ends(const int* iw, int i, int r0, int end) {
  return r0 + i + 1 == end || iw[i + 1] != iw[i];
}

// kBf16: the table holds bf16 bit patterns (uint16_t), else float.
// kVec: D % 4 == 0, a 16-byte aligned payload and a table aligned to four
// elements: payload rows move in 16-byte copies, table rows in 16-byte
// (f32) or 8-byte (bf16) copies; otherwise in 4-byte copies, and a bf16
// table row element by element with plain loads (no cp.async size fits 2
// bytes).
template <bool kBf16, bool kVec>
struct Windowed {
  using Elem = typename std::conditional<kBf16, uint16_t, float>::type;

  static size_t smem_bytes(int D) {
    return static_cast<size_t>(kStages) * kWin * D * (sizeof(float) + sizeof(Elem)) +
           static_cast<size_t>(D) * sizeof(float) +
           static_cast<size_t>(kIdSlots) * (kWin + 1) * sizeof(int);
  }

  // Start window w's copies: its payload rows, the table rows of the
  // segments that end in it (their ids are in `iw`), and the ids of window
  // w + kStages - 1 (into `ids_ahead`); commit them as one group.
  static __device__ __forceinline__ void load_window(
      float* pay, Elem* tab, const int* iw, int* ids_ahead, const int* ids,
      const float* upd, const Elem* table, int r0, int end, long long N, int D) {
    const int n = min(kWin, end - r0);
    const float* src = upd + static_cast<long long>(r0) * D;
    if constexpr (kVec) {
      for (int k = threadIdx.x; k < n * D / 4; k += kThreads)
        cp_async16(pay + 4 * k, src + 4 * k);
    } else {
      for (int k = threadIdx.x; k < n * D; k += kThreads) cp_async4(pay + k, src + k);
    }
    const int chunks = kVec ? D / 4 : D;
    for (int k = threadIdx.x; k < n * chunks; k += kThreads) {
      const int i = k / chunks;
      const int c = (k - i * chunks) * (kVec ? 4 : 1);
      const int id = iw[i];
      if (id >= N || !segment_ends(iw, i, r0, end)) continue;
      const Elem* row = table + static_cast<long long>(id) * D + c;
      Elem* dst = tab + i * D + c;
      if constexpr (kVec) {
        if constexpr (kBf16) cp_async8(dst, row);
        else cp_async16(dst, row);
      } else if constexpr (kBf16) {
        *dst = *row;
      } else {
        cp_async4(dst, row);
      }
    }
    load_ids(ids_ahead, ids, r0 + (kStages - 1) * kWin, end);
    cp_async_commit();
  }

  // One warp folds the window rows lo..hi of one segment, column by column
  // (four columns a lane where kVec): from 0, or from the carried partial
  // sum of the window before (cin), in stream order. A segment that runs on
  // into the next window leaves its partial sum in `carry` (cout); one
  // that ends here writes t - sum into its table row, with t from the row
  // fetched into the window's slot `tw`.
  static __device__ __forceinline__ void fold(
      const float* pw, const Elem* tw, float* carry, Elem* table, int lo, int hi,
      bool cin, bool cout, int id, long long N, int D, uint32_t seed, int lane) {
    if (!cout && id >= N) return;  // ids >= N are dropped
    const long long off = static_cast<long long>(id) * D;
    if constexpr (kVec) {
      for (int c = 4 * lane; c < D; c += 128) {
        float4 a = cin ? *reinterpret_cast<const float4*>(carry + c)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        for (int r = lo; r <= hi; ++r) {
          const float4 v = *reinterpret_cast<const float4*>(pw + r * D + c);
          a.x += v.x;
          a.y += v.y;
          a.z += v.z;
          a.w += v.w;
        }
        if (cout) {
          *reinterpret_cast<float4*>(carry + c) = a;
        } else if constexpr (kBf16) {
          const uint2 raw = *reinterpret_cast<const uint2*>(tw + hi * D + c);
          uint2 out;
          out.x = static_cast<uint32_t>(
                      sr_bf16(bf16_to_f32(raw.x & 0xffffu) - a.x, seed, id, c)) |
                  (static_cast<uint32_t>(
                       sr_bf16(bf16_to_f32(raw.x >> 16) - a.y, seed, id, c + 1)) << 16);
          out.y = static_cast<uint32_t>(
                      sr_bf16(bf16_to_f32(raw.y & 0xffffu) - a.z, seed, id, c + 2)) |
                  (static_cast<uint32_t>(
                       sr_bf16(bf16_to_f32(raw.y >> 16) - a.w, seed, id, c + 3)) << 16);
          *reinterpret_cast<uint2*>(table + off + c) = out;
        } else {
          float4 t = *reinterpret_cast<const float4*>(tw + hi * D + c);
          t.x -= a.x;
          t.y -= a.y;
          t.z -= a.z;
          t.w -= a.w;
          *reinterpret_cast<float4*>(table + off + c) = t;
        }
      }
    } else {
      for (int c = lane; c < D; c += 32) {
        float a = cin ? carry[c] : 0.f;
        for (int r = lo; r <= hi; ++r) a += pw[r * D + c];
        if (cout) {
          carry[c] = a;
        } else if constexpr (kBf16) {
          table[off + c] = sr_bf16(bf16_to_f32(tw[hi * D + c]) - a, seed, id, c);
        } else {
          table[off + c] = tw[hi * D + c] - a;
        }
      }
    }
  }
};

template <bool kBf16, bool kVec>
__global__ void __launch_bounds__(kThreads)
    apply_windowed_kernel(void* __restrict__ table_v, const int* __restrict__ ids,
                          const float* __restrict__ upd, int R, long long N, int D,
                          uint32_t seed) {
  using W = Windowed<kBf16, kVec>;
  using Elem = typename W::Elem;
  Elem* table = static_cast<Elem*>(table_v);
  const int G = gridDim.x;
  const int s = static_cast<int>(static_cast<long long>(blockIdx.x) * R / G);
  const int e = static_cast<int>((static_cast<long long>(blockIdx.x) + 1) * R / G);
  if (s >= e) return;  // more blocks than rows: an empty range

  // the block's rows: from the first segment head in [s, e) with an id
  // >= 0, to the end of the segment that holds row e - 1
  __shared__ int range[2];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == 0) {
    const int key = s == 0 ? -1 : max(ids[s - 1], -1);
    const int v = first_above(ids, s, R, key, lane);
    if (lane == 0) range[0] = v;
  } else if (warp == 1) {
    const int v = e == R ? R : first_above(ids, e, R, ids[e - 1], lane);
    if (lane == 0) range[1] = v;
  }
  __syncthreads();
  const int start = range[0];
  const int end = range[1];
  if (start >= e) return;  // no segment starts in the range
  const int nwin = (end - start + kWin - 1) / kWin;

  extern __shared__ __align__(16) unsigned char smem[];
  float* pay = reinterpret_cast<float*>(smem);                     // [kStages, kWin, D]
  Elem* tab = reinterpret_cast<Elem*>(pay + kStages * kWin * D);   // [kStages, kWin, D]
  float* carry = reinterpret_cast<float*>(tab + kStages * kWin * D);  // [D]
  int* idb = reinterpret_cast<int*>(carry + D);                     // [kIdSlots, kWin + 1]
  auto ids_of = [&](int w) { return idb + (w % kIdSlots) * (kWin + 1); };
  auto load_window = [&](int w) {
    const int slot = w % kStages;
    W::load_window(pay + slot * kWin * D, tab + slot * kWin * D, ids_of(w),
             ids_of(w + kStages - 1), ids, upd, table, start + w * kWin, end, N, D);
  };

  for (int w = 0; w < kStages - 1; ++w) load_ids(ids_of(w), ids, start + w * kWin, end);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int w = 0; w < kStages - 1; ++w) {
    if (w < nwin) load_window(w);
    else cp_async_commit();  // an empty group keeps the count of groups
  }

  bool cin = false;  // the block's first row starts a segment
  for (int j = 0; j < nwin; ++j) {
    cp_async_wait<kStages - 2>();  // window j's group has landed
    __syncthreads();
    if (j + kStages - 1 < nwin) load_window(j + kStages - 1);  // into slot (j - 1) % kStages
    else cp_async_commit();
    const int slot = j % kStages;
    const int* iw = ids_of(j);
    const int r0 = start + j * kWin;
    const int n = min(kWin, end - r0);
    // the window's segments, one bit at the last row of each; the warps
    // take them in turn, and warp 0 the one that runs on into the next
    // window (it also takes segment 0, which may carry in: only warp 0
    // touches the carry row)
    const unsigned ends = __ballot_sync(kFull, lane < n && segment_ends(iw, lane, r0, end));
    const bool cout = !((ends >> (n - 1)) & 1u);
    unsigned m = ends | (cout ? 1u << (n - 1) : 0u);
    for (int k = 0, lo = 0; m != 0; ++k) {
      const int hi = __ffs(m) - 1;
      m &= m - 1;
      const bool last_out = m == 0 && cout;
      if ((last_out ? 0 : k % kWarps) == warp) {
        W::fold(pay + slot * kWin * D, tab + slot * kWin * D, carry, table, lo, hi,
                lo == 0 && cin, last_out, iw[hi], N, D, seed, lane);
      }
      lo = hi + 1;
    }
    cin = cout;
    __syncthreads();  // slot j % kStages is free for window j + kStages
  }
}

// The launch's grid for rows of D elements: SMs x resident blocks. The
// shared-memory limit is raised, and the occupancy queried, once per
// instantiation, device and width.
template <bool kBf16, bool kVec>
cudaError_t grid_size(int D, int* grid) {
  static bool configured[kMaxDevices];
  static int per_sm[kMaxDevices][kMaxDim + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  void (*kernel)(void*, const int*, const float*, int, long long, int, uint32_t) =
      apply_windowed_kernel<kBf16, kVec>;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Windowed<kBf16, kVec>::smem_bytes(kMaxDim)));
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  if (per_sm[dev][D] == 0) {
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, kernel, kThreads, Windowed<kBf16, kVec>::smem_bytes(D));
    if (err != cudaSuccess) return err;
    if (n == 0) return cudaErrorInvalidConfiguration;
    per_sm[dev][D] = n;
  }
  const int sms = sm_count(dev, &err);
  if (err != cudaSuccess) return err;
  *grid = sms * per_sm[dev][D];
  return cudaSuccess;
}

template <bool kBf16>
bool use_vec(const void* table, const float* upd, int D) {
  const size_t align = kBf16 ? 8 : 16;  // four table elements
  return D % 4 == 0 && reinterpret_cast<uintptr_t>(upd) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(table) % align == 0;
}

template <bool kBf16>
int grid_for(const void* table, const float* upd, int D, int* grid) {
  if (D <= 0 || D > kMaxDim) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(use_vec<kBf16>(table, upd, D) ? grid_size<kBf16, true>(D, grid)
                                                         : grid_size<kBf16, false>(D, grid));
}

template <bool kBf16>
int launch(void* table, const int* ids, const float* upd, long long R, long long N,
           int D, uint32_t seed, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  if (R > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0;
  const int err = grid_for<kBf16>(table, upd, D, &grid);
  if (err != 0) return err;
  const bool vec = use_vec<kBf16>(table, upd, D);
  const size_t smem = vec ? Windowed<kBf16, true>::smem_bytes(D)
                          : Windowed<kBf16, false>::smem_bytes(D);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec) {
    apply_windowed_kernel<kBf16, true><<<grid, kThreads, smem, s>>>(
        table, ids, upd, static_cast<int>(R), N, D, seed);
  } else {
    apply_windowed_kernel<kBf16, false><<<grid, kThreads, smem, s>>>(
        table, ids, upd, static_cast<int>(R), N, D, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch's CUDA
// error code, 0 on success. ids: [R] int32 sorted ascending; upd: [R, D]
// float32 row-major, D <= 448; table: [N, D] row-major, updated in place
// on `stream`.
extern "C" int pecanpy_apply_windowed_f32(float* table, const int* ids,
                                          const float* upd, long long R,
                                          long long N, int D, unsigned seed,
                                          void* stream) {
  return launch<false>(table, ids, upd, R, N, D, seed, stream);
}

extern "C" int pecanpy_apply_windowed_bf16(uint16_t* table, const int* ids,
                                           const float* upd, long long R,
                                           long long N, int D, unsigned seed,
                                           void* stream) {
  return launch<true>(table, ids, upd, R, N, D, seed, stream);
}

// The grid (blocks) that a launch with these table and payload pointers and
// rows of D elements uses on the current device; block b takes the stream
// rows [b R / grid, (b + 1) R / grid). Returns the grid, or minus a CUDA
// error code.
extern "C" int pecanpy_apply_windowed_grid(const void* table, const float* upd, int D,
                                           int bf16) {
  int grid = 0;
  const int err = bf16 ? grid_for<true>(table, upd, D, &grid)
                       : grid_for<false>(table, upd, D, &grid);
  return err != 0 ? -err : grid;
}
