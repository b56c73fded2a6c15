// Sorted-stream table applier for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pecanpy_tpu/ops/apply.py:_applier_kernel.
// Both compute, for a stream of R payload rows sorted by destination row
// id and already scaled by lr * min(total, cap) / total per group:
//
//     table[i] -= sum of the payload rows whose id is i
//
// in place; rows that no id names are never read or written. A bf16 table
// is read as f32, updated in f32 and written back with stochastic
// rounding, so updates far below one bf16 ulp still move the table in
// expectation.
//
// Design. The TPU kernel tiles the table and folds stream chunks in with
// one-hot matmuls, because its grid runs in order on one core. Here the
// blocks run in parallel in no order, so the work is a segmented
// reduction: one warp per stream row r. Only segment heads work (r == 0
// or ids[r] != ids[r-1]); every other warp exits at once. A head warp
// finds its segment's end with ballots over 32 ids at a time, sums the
// segment's payload rows in registers (lanes stride over D, four floats a
// lane when D % 4 == 0), then reads the table row once, subtracts and
// writes it once. Each row is owned by exactly one warp: no atomics, no
// host synchronisation, and the result does not depend on scheduling.
// The price: a segment of n rows is summed serially in f32, so its error
// grows with n, up to gamma(n - 1) * sum |x| (gamma(k) = k u / (1 - k u),
// u = 2^-24), the bound tests/test_torch_kernels.py holds it to.
//
// What bounds it: bytes. A pass reads the R x D x 4 payload bytes once and
// reads and writes each touched table row once; there is no arithmetic to
// speak of. Keeping each segment's sum in registers is what keeps the
// table traffic at one read and one write per touched row.
//
// Stochastic rounding bits come from a counter-based hash of
// (seed, row, col), so the result is a pure function of the inputs: add
// the low 16 random bits to the f32 bit pattern, then truncate to the top
// 16. ops/apply.py computes the same bits in its plain torch version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t sr_bits(uint32_t seed, uint32_t row,
                                            uint32_t col) {
  return fmix32(fmix32(fmix32(seed) ^ row) ^ col);
}

// f32 -> bf16 bits with stochastic rounding.
__device__ __forceinline__ uint16_t sr_bf16(float x, uint32_t seed,
                                            uint32_t row, uint32_t col) {
  uint32_t b = __float_as_uint(x);
  b += sr_bits(seed, row, col) & 0xffffu;
  return static_cast<uint16_t>(b >> 16);
}

__device__ __forceinline__ float bf16_to_f32(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

// One past the last stream row of the segment that starts at r.
__device__ __forceinline__ long long segment_end(const int* ids, long long r,
                                                 long long R, int id,
                                                 int lane) {
  long long e = r + 1;
  while (true) {
    long long j = e + lane;
    bool same = j < R && ids[j] == id;
    unsigned m = __ballot_sync(kFull, same);
    if (m != kFull) return e + (__ffs(~m) - 1);
    e += 32;
  }
}

// kBf16: the table holds bf16 bit patterns (uint16_t), else float.
// kVec4: D % 4 == 0 and 16-byte aligned payload / table rows.
template <bool kBf16, bool kVec4>
__global__ void apply_sorted_kernel(void* __restrict__ table_v,
                                    const int* __restrict__ ids,
                                    const float* __restrict__ upd,
                                    long long R, long long N, int D,
                                    uint32_t seed) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= R) return;  // whole warp: r is uniform across it
  const int id = ids[r];
  if (r > 0 && ids[r - 1] == id) return;  // not a segment head
  // an out-of-range id names no row: its segment is dropped (the JAX
  // package's scatter semantics), never written out of bounds
  if (id < 0 || id >= N) return;
  const long long e = segment_end(ids, r, R, id, lane);
  const long long row_off = static_cast<long long>(id) * D;

  if (kVec4) {
    for (int c = lane * 4; c < D; c += 128) {
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (long long j = r; j < e; ++j) {
        const float4 v =
            *reinterpret_cast<const float4*>(upd + j * D + c);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      if (kBf16) {
        uint16_t* t = static_cast<uint16_t*>(table_v) + row_off + c;
        const uint2 raw = *reinterpret_cast<const uint2*>(t);
        const float t0 = bf16_to_f32(raw.x & 0xffffu) - acc.x;
        const float t1 = bf16_to_f32(raw.x >> 16) - acc.y;
        const float t2 = bf16_to_f32(raw.y & 0xffffu) - acc.z;
        const float t3 = bf16_to_f32(raw.y >> 16) - acc.w;
        uint2 out;
        out.x = static_cast<uint32_t>(sr_bf16(t0, seed, id, c)) |
                (static_cast<uint32_t>(sr_bf16(t1, seed, id, c + 1)) << 16);
        out.y = static_cast<uint32_t>(sr_bf16(t2, seed, id, c + 2)) |
                (static_cast<uint32_t>(sr_bf16(t3, seed, id, c + 3)) << 16);
        *reinterpret_cast<uint2*>(t) = out;
      } else {
        float4* t = reinterpret_cast<float4*>(
            static_cast<float*>(table_v) + row_off + c);
        float4 v = *t;
        v.x -= acc.x;
        v.y -= acc.y;
        v.z -= acc.z;
        v.w -= acc.w;
        *t = v;
      }
    }
  } else {
    for (int c = lane; c < D; c += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (long long j = r; j < e; ++j) acc += upd[j * D + c];
      if (kBf16) {
        uint16_t* t = static_cast<uint16_t*>(table_v) + row_off + c;
        *t = sr_bf16(bf16_to_f32(*t) - acc, seed, id, c);
      } else {
        float* t = static_cast<float*>(table_v) + row_off + c;
        *t -= acc;
      }
    }
  }
}

template <bool kBf16>
int launch(void* table, const int* ids, const float* upd, long long R,
           long long N, int D, uint32_t seed, void* stream) {
  if (R <= 0) return 0;
  constexpr int kThreads = 256;  // 8 warps, one stream row each
  const long long blocks = (R * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t align = kBf16 ? 8 : 16;  // one 4-element group per lane
  const bool vec4 = D % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % align == 0 &&
                    reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (vec4) {
    apply_sorted_kernel<kBf16, true>
        <<<grid, kThreads, 0, s>>>(table, ids, upd, R, N, D, seed);
  } else {
    apply_sorted_kernel<kBf16, false>
        <<<grid, kThreads, 0, s>>>(table, ids, upd, R, N, D, seed);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the launch's
// cudaGetLastError() code, 0 on success. ids: [R] int32 sorted ascending;
// upd: [R, D] float32 row-major; table: [N, D] row-major, updated in
// place on `stream`.
extern "C" int pecanpy_apply_sorted_f32(float* table, const int* ids,
                                        const float* upd, long long R,
                                        long long N, int D, unsigned seed,
                                        void* stream) {
  return launch<false>(table, ids, upd, R, N, D, seed, stream);
}

extern "C" int pecanpy_apply_sorted_bf16(uint16_t* table, const int* ids,
                                         const float* upd, long long R,
                                         long long N, int D, unsigned seed,
                                         void* stream) {
  return launch<true>(table, ids, upd, R, N, D, seed, stream);
}

extern "C" const char* pecanpy_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
