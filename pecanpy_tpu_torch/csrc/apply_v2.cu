// Windowed sorted-stream table applier for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pecanpy_tpu/ops/apply.py:_applier_kernel_v2.
// It computes the function of csrc/apply.cu (the port of _applier_kernel):
// for a stream of R payload rows sorted by destination row id and already
// scaled,
//
//     table[i] -= sum of the payload rows whose id is i
//
// in place; ids outside [0, N) are dropped, and rows that no id names are
// never read or written. A bf16 table is read as f32, updated in f32 and
// written back with stochastic rounding from the same (seed, row, col)
// hash as csrc/apply.cu.
//
// Design. The TPU kernel runs one grid step per 2048-row table tile, one
// after another on one core: it double-buffers 512-row windows of the
// sorted stream into VMEM by DMA and folds each window into a [TILE, D]
// f32 scratch with a one-hot matmul that masks out rows of neighbouring
// tiles. On Hopper the tiles run in parallel, one block each, so a tile is
// small: kTile = 32 rows, whose [32, D] f32 accumulator (16 KB at D = 128)
// sits in shared memory beside two kWin = 16-row payload windows, 32.1 KB
// in all at D = 128, so that seven blocks fit on an SM (wider rows raise
// the limit past 48 KB with cudaFuncSetAttribute). A block's time is a
// chain of dependent loads (plan, window, slice ids, table rows) more
// than its bytes, so more blocks in flight is what hides it. With about
// four stream rows per tile at the SGNS shapes, a window of 16 rows keeps
// the rows of neighbouring tiles that a block loads and masks to a few
// per tile. The block walks the windows that overlap its slice
// [bounds[t], bounds[t+1]) of the stream (the window plan of the JAX
// driver, computed by ops/apply.py:window_plan), copying window j + 1 with
// cp.async while it folds window j: the counterpart of the make_async_copy
// + semaphore pairs. Each thread owns fixed columns and adds, for every
// window row in stream order whose id falls in the tile, its payload into
// the accumulator row of that id: no atomics, and each row's sum is taken
// in stream order from 0 exactly as csrc/apply.cu sums a segment, so f32
// and bf16 results are bit-equal to that kernel's.
//
// What bounds it: bytes. There is no arithmetic to speak of. The table is
// the large operand, and the block writes back only the rows its slice
// names: one read and one write per touched row, where the TPU kernel
// rewrites every row of every tile. The stream is read about once (the
// windows at slice boundaries twice), and a tile with an empty slice exits
// before it touches memory.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // table rows per block (ops/apply.py: WINDOW_TILE)
constexpr int kWin = 16;       // stream rows per window (WINDOW_ROWS)
constexpr int kThreads = 128;  // each thread owns columns c = tid + k * 128

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// the stochastic-rounding bits of csrc/apply.cu:sr_bits
__device__ __forceinline__ uint32_t sr_bits(uint32_t seed, uint32_t row,
                                            uint32_t col) {
  return fmix32(fmix32(fmix32(seed) ^ row) ^ col);
}

__device__ __forceinline__ uint16_t sr_bf16(float x, uint32_t seed,
                                            uint32_t row, uint32_t col) {
  uint32_t b = __float_as_uint(x);
  b += sr_bits(seed, row, col) & 0xffffu;
  return static_cast<uint16_t>(b >> 16);
}

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Rows of stream window w: kWin, or fewer for the stream's last window.
__device__ __forceinline__ int window_rows(long long w, long long R) {
  const long long left = R - w * kWin;
  return left < kWin ? static_cast<int>(left) : kWin;
}

// Start the copies of window w's ids and payload rows into one buffer slot.
template <bool kVec4>
__device__ __forceinline__ void load_window(int* ids_buf, float* upd_buf,
                                            const int* ids, const float* upd,
                                            long long w, long long R, int D) {
  const long long r0 = w * kWin;
  const int rows = window_rows(w, R);
  for (int i = threadIdx.x; i < rows; i += kThreads)
    cp_async4(ids_buf + i, ids + r0 + i);
  const float* src = upd + r0 * D;
  if (kVec4) {
    const int n = rows * D / 4;
    for (int i = threadIdx.x; i < n; i += kThreads)
      cp_async16(upd_buf + 4 * i, src + 4 * i);
  } else {
    const int n = rows * D;
    for (int i = threadIdx.x; i < n; i += kThreads)
      cp_async4(upd_buf + i, src + i);
  }
}

// kBf16: the table holds bf16 bit patterns (uint16_t), else float.
// kVec4: D % 4 == 0 and a 16-byte aligned payload: 16-byte copies.
template <bool kBf16, bool kVec4>
__global__ void __launch_bounds__(kThreads)
    apply_windowed_kernel(void* __restrict__ table_v,
                          const int* __restrict__ ids,
                          const float* __restrict__ upd,
                          const int* __restrict__ bounds,
                          const int* __restrict__ w0s,
                          const int* __restrict__ nws, long long R,
                          long long N, int D, uint32_t seed) {
  const int t = blockIdx.x;
  const int nw = nws[t];
  if (nw == 0) return;  // empty slice: the whole block leaves at once
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);                       // [kTile, D]
  float* upd_buf = acc + kTile * D;                                  // [2, kWin, D]
  int* ids_buf = reinterpret_cast<int*>(upd_buf + 2 * kWin * D);     // [2, kWin]
  const long long w0 = w0s[t];
  const long long row0 = static_cast<long long>(t) * kTile;

  load_window<kVec4>(ids_buf, upd_buf, ids, upd, w0, R, D);
  cp_async_commit();
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) acc[i] = 0.f;

  for (int j = 0; j < nw; ++j) {
    const int slot = j & 1;
    if (j + 1 < nw) {  // the next window flies while this one folds
      load_window<kVec4>(ids_buf + (slot ^ 1) * kWin,
                         upd_buf + (slot ^ 1) * kWin * D, ids, upd,
                         w0 + j + 1, R, D);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // window j (and the zeroed accumulator) visible to all
    const int rows = window_rows(w0 + j, R);
    const int* wid = ids_buf + slot * kWin;
    const float* wu = upd_buf + slot * kWin * D;
    for (int i = 0; i < rows; ++i) {
      // rows of neighbouring tiles ride the shared boundary windows; they,
      // and ids past the table's end, fall outside the tile and are masked
      const long long local = static_cast<long long>(wid[i]) - row0;
      if (local < 0 || local >= kTile || row0 + local >= N) continue;
      float* a = acc + local * D;
      const float* u = wu + i * D;
      for (int c = threadIdx.x; c < D; c += kThreads) a[c] += u[c];
    }
    __syncthreads();  // slot j & 1 is free for window j + 2
  }

  // write back the rows the slice names, one read and one write each; the
  // warps take the slice's rows in turn, so their table round trips overlap
  const int lo = bounds[t];
  const int hi = bounds[t + 1];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = lo + warp; r < hi; r += kThreads / 32) {
    const int id = ids[r];
    if ((r > lo && ids[r - 1] == id) || id >= N) continue;  // warp-uniform
    const float* a = acc + (id - row0) * D;
    const long long off = static_cast<long long>(id) * D;
    for (int c = lane; c < D; c += 32) {
      if (kBf16) {
        uint16_t* p = static_cast<uint16_t*>(table_v) + off + c;
        *p = sr_bf16(bf16_to_f32(*p) - a[c], seed, id, c);
      } else {
        float* p = static_cast<float*>(table_v) + off + c;
        *p -= a[c];
      }
    }
  }
}

template <bool kBf16>
int launch(void* table, const int* ids, const float* upd, const int* bounds,
           const int* w0, const int* nw, long long R, long long N, int D,
           uint32_t seed, void* stream) {
  if (R <= 0 || N <= 0) return 0;
  const long long tiles = (N + kTile - 1) / kTile;
  if (D <= 0 || R > 0x7fffffffLL || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTile + 2 * kWin) * D * sizeof(float) +
                      2 * kWin * sizeof(int);
  const bool vec4 = D % 4 == 0 && reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  void (*kernel)(void*, const int*, const float*, const int*, const int*,
                 const int*, long long, long long, int, uint32_t) =
      vec4 ? apply_windowed_kernel<kBf16, true>
           : apply_windowed_kernel<kBf16, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(table, ids, upd, bounds, w0,
                                                nw, R, N, D, seed);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch's CUDA
// error code, 0 on success. ids: [R] int32 sorted ascending; upd: [R, D]
// float32 row-major; bounds [T + 1], w0 [T], nw [T] int32: the window plan
// of ops/apply.py:window_plan for T = ceil(N / 32) tiles of 32 rows and
// windows of 16 rows; table: [N, D] row-major, updated in place on
// `stream`.
extern "C" int pecanpy_apply_windowed_f32(float* table, const int* ids,
                                          const float* upd, const int* bounds,
                                          const int* w0, const int* nw,
                                          long long R, long long N, int D,
                                          unsigned seed, void* stream) {
  return launch<false>(table, ids, upd, bounds, w0, nw, R, N, D, seed, stream);
}

extern "C" int pecanpy_apply_windowed_bf16(uint16_t* table, const int* ids,
                                           const float* upd, const int* bounds,
                                           const int* w0, const int* nw,
                                           long long R, long long N, int D,
                                           unsigned seed, void* stream) {
  return launch<true>(table, ids, upd, bounds, w0, nw, R, N, D, seed, stream);
}
