// Device helpers shared by the two table appliers (apply.cu, apply_v2.cu):
// the stochastic-rounding hash, bf16 bit conversions, cp.async copies and
// the warp-wide search for the end of a segment of sorted ids, and the
// SM count the persistent launches size their grids by.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 16;  // devices whose launch settings are cached

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

// The stochastic-rounding bits of (seed, row, col); ops/apply.py:sr_bits
// computes the same in torch.
__device__ __forceinline__ uint32_t sr_bits(uint32_t seed, uint32_t row,
                                            uint32_t col) {
  return fmix32(fmix32(fmix32(seed) ^ row) ^ col);
}

// f32 -> bf16 bits with stochastic rounding: add the low 16 random bits to
// the f32 bit pattern, then truncate to the top 16.
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

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
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

// The first row r in [lo, R) with ids[r] > key, or R; ids sorted. One warp
// calls it and every lane returns the row: a look at the next 32 rows (the
// usual case), then a gallop of 32 * 2^lane rows and 32-way narrowing,
// which finds the end of a segment of n rows in about 2 + log32(n) loads.
__device__ long long first_above(const int* ids, long long lo, long long R, int key,
                                 int lane) {
  const long long j = lo + lane;
  unsigned m = __ballot_sync(kFull, j >= R || ids[j] > key);
  if (m) return min(lo + __ffs(m) - 1, R);
  // ids[lo + 31] <= key; lane 31's probe lies past any R < 2^36
  const long long p = lo + (32LL << lane) - 1;
  m = __ballot_sync(kFull, p >= R || ids[p] > key);
  const int l = __ffs(m) - 1;  // >= 1
  long long a = lo + (32LL << (l - 1)) - 1;      // ids[a] <= key
  long long hi = min(lo + (32LL << l) - 1, R);  // R, or ids[hi] > key
  while (hi - a > 32) {
    const long long step = (hi - a + 31) / 32;
    const long long q = a + step * (lane + 1);  // lane 31's q >= hi
    m = __ballot_sync(kFull, q >= hi || ids[q] > key);
    const int f = __ffs(m) - 1;
    hi = min(a + step * (f + 1), hi);
    a += step * f;
  }
  const long long q = a + 1 + lane;
  m = __ballot_sync(kFull, q >= hi || ids[q] > key);
  return a + __ffs(m);
}

// The number of SMs of device dev, queried once per process.
int sm_count(int dev, cudaError_t* err) {
  static int sms[kMaxDevices];
  if (sms[dev] == 0) {
    *err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev];
}

}  // namespace
