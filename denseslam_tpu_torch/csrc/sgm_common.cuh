// Device code shared by the two SGM kernels (csrc/sgm.cu, csrc/sgm_final.cu):
// the cost-dtype arithmetic (bf16 in packed pairs), the recurrence step, the
// order-preserving keys that let one `redux.sync` take a minimum over the
// warp, and the mbarrier / bulk-copy (TMA) primitives of the staged ring
// both kernels read through.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sgm {

constexpr unsigned kFull = 0xffffffffu;

// The cost dtype's value of a float, and its exact f32 widening.
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float from(float x) { return x; }
  static __device__ __forceinline__ float f32(float x) { return x; }
};

template <>
struct Arith<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 from(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float f32(__nv_bfloat16 x) { return __bfloat162float(x); }
};

template <typename T, int K>
struct alignas(sizeof(T) * K) Vec {
  T v[K];
};

template <typename T, int K>
__device__ __forceinline__ Vec<T, K> load(const void* p) {
  return *reinterpret_cast<const Vec<T, K>*>(p);
}

template <typename T, int K>
__device__ __forceinline__ void store(void* p, const Vec<T, K>& v) {
  *reinterpret_cast<Vec<T, K>*>(p) = v;
}

// A lane's K consecutive disparities as the recurrence holds them: N values
// of type E. bf16 goes in pairs (__nv_bfloat162, one 32-bit register and
// one packed instruction per two disparities; each half rounds as the
// scalar op does), so that the words loaded from and stored to memory need
// no unpacking; f32, and bf16 at K = 1, one value per register.
template <typename T, int K>
struct Lane {
  using E = T;
  static constexpr int N = K;
};

template <int K>
struct Lane<__nv_bfloat16, K> {
  using E = __nv_bfloat162;
  static constexpr int N = K / 2;
};

template <>
struct Lane<__nv_bfloat16, 1> {
  using E = __nv_bfloat16;
  static constexpr int N = 1;
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ __nv_bfloat16 add(__nv_bfloat16 a, __nv_bfloat16 b) { return __hadd(a, b); }
__device__ __forceinline__ __nv_bfloat16 sub(__nv_bfloat16 a, __nv_bfloat16 b) { return __hsub(a, b); }
__device__ __forceinline__ __nv_bfloat16 mn(__nv_bfloat16 a, __nv_bfloat16 b) { return __hmin(a, b); }
__device__ __forceinline__ __nv_bfloat162 add(__nv_bfloat162 a, __nv_bfloat162 b) { return __hadd2(a, b); }
__device__ __forceinline__ __nv_bfloat162 sub(__nv_bfloat162 a, __nv_bfloat162 b) { return __hsub2(a, b); }
__device__ __forceinline__ __nv_bfloat162 mn(__nv_bfloat162 a, __nv_bfloat162 b) { return __hmin2(a, b); }

// A register of the lane's type holding the cost-dtype value x (in both
// halves when packed).
template <typename E>
__device__ __forceinline__ E splat(float x);
template <>
__device__ __forceinline__ float splat<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 splat<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __nv_bfloat162 splat<__nv_bfloat162>(float x) {
  return __bfloat162bfloat162(__float2bfloat16(x));
}

// An unsigned key with the order of the float: a negative value has all its
// bits flipped, any other only its sign bit. (The raw bit pattern is no
// order: box-filtered costs can be slightly negative.) -0 keys just below
// +0; the two are equal as floats.
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) | 0x80000000u);
}

// The same order as a signed key, which is its own inverse: a negative
// value keeps its sign bit and flips the others.
__device__ __forceinline__ int32_t signed_key(uint32_t b) {
  return static_cast<int32_t>(b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) >> 1));
}

// The minimum over the warp: one redux.sync on the keys.
__device__ __forceinline__ float warp_min(float v) {
  const int32_t k = __reduce_min_sync(kFull, signed_key(__float_as_uint(v)));
  return __uint_as_float(static_cast<uint32_t>(signed_key(static_cast<uint32_t>(k))));
}

__device__ __forceinline__ __nv_bfloat16 warp_min(__nv_bfloat16 v) {
  const uint32_t b = static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16;
  const int32_t k = __reduce_min_sync(kFull, signed_key(b));
  return __ushort_as_bfloat16(
      static_cast<unsigned short>(static_cast<uint32_t>(signed_key(static_cast<uint32_t>(k))) >> 16));
}

// min L' over D: the lane's values as a tree (for pairs, then the two
// halves), then the warp by one redux.sync on keys.
template <typename E, int N>
__device__ __forceinline__ E lane_min(const E (&v)[N]) {
  E t[N];
#pragma unroll
  for (int k = 0; k < N; ++k) t[k] = v[k];
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
#pragma unroll
    for (int k = 0; k + s < N; k += 2 * s) t[k] = mn(t[k], t[k + s]);
  return t[0];
}

template <typename E, int N>
__device__ __forceinline__ E min_over_d(const E (&v)[N]) {
  return warp_min(lane_min<E, N>(v));
}

template <int N>
__device__ __forceinline__ __nv_bfloat16 pair_min_over_d(const __nv_bfloat162 (&v)[N]) {
  const __nv_bfloat162 t = lane_min<__nv_bfloat162, N>(v);
  return warp_min(__hmin(__low2bfloat16(t), __high2bfloat16(t)));
}

// One recurrence step of a scanline held by a warp, lane l holding
// disparities [l*K, l*K + K):
//   L = (C + min(L', L'(d-1) + P1, L'(d+1) + P1, min L' + P2)) - min L'
// edges clamped as the reference's `_step`; every op rounds in the cost
// dtype in the order the JAX expression is written. prev becomes L.
// One value per register (f32, or bf16 at K = 1):
template <typename E, int N>
__device__ __forceinline__ void step_values(E (&prev)[N], const E (&cur)[N], E p1, E p2,
                                            int lane) {
  E lo = __shfl_up_sync(kFull, prev[N - 1], 1);
  E hi = __shfl_down_sync(kFull, prev[0], 1);
  const E m = min_over_d<E, N>(prev);
  if (lane == 0) lo = prev[0];
  if (lane == 31) hi = prev[N - 1];
  const E mp2 = add(m, p2);
  E L[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const E sp = k > 0 ? prev[k - 1] : lo;
    const E sn = k < N - 1 ? prev[k + 1] : hi;
    const E best = mn(mn(prev[k], add(sp, p1)), mn(add(sn, p1), mp2));
    L[k] = sub(add(cur[k], best), m);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) prev[k] = L[k];
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 w) {
  return *reinterpret_cast<const uint32_t*>(&w);
}

__device__ __forceinline__ __nv_bfloat162 word(uint32_t b) {
  return *reinterpret_cast<const __nv_bfloat162*>(&b);
}

// bf16 pairs: word p holds disparities (2p, 2p+1) as (low, high) halves;
// the d-1 and d+1 neighbours are the word's halves shifted by one
// (__byte_perm), across lanes through one shuffle each.
template <int N>
__device__ __forceinline__ void step_pairs(__nv_bfloat162 (&prev)[N],
                                           const __nv_bfloat162 (&cur)[N],
                                           __nv_bfloat162 p1, __nv_bfloat162 p2, int lane) {
  const uint32_t first = bits(prev[0]);
  const uint32_t last = bits(prev[N - 1]);
  uint32_t wl = __shfl_up_sync(kFull, last, 1);    // high half: d - 1 of the first
  uint32_t wr = __shfl_down_sync(kFull, first, 1); // low half: d + 1 of the last
  const __nv_bfloat16 m = pair_min_over_d<N>(prev);
  if (lane == 0) wl = first << 16;
  if (lane == 31) wr = last >> 16;
  const __nv_bfloat162 m2 = __bfloat162bfloat162(m);
  const __nv_bfloat162 mp2 = add(m2, p2);
  __nv_bfloat162 L[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const __nv_bfloat162 sp = word(__byte_perm(k > 0 ? bits(prev[k - 1]) : wl, bits(prev[k]), 0x5432));
    const __nv_bfloat162 sn = word(__byte_perm(bits(prev[k]), k < N - 1 ? bits(prev[k + 1]) : wr, 0x5432));
    const __nv_bfloat162 best = mn(mn(prev[k], add(sp, p1)), mn(add(sn, p1), mp2));
    L[k] = sub(add(cur[k], best), m2);
  }
#pragma unroll
  for (int k = 0; k < N; ++k) prev[k] = L[k];
}

template <typename E, int N>
__device__ __forceinline__ void step(E (&prev)[N], const E (&cur)[N], E p1, E p2,
                                     int lane) {
  if constexpr (std::is_same<E, __nv_bfloat162>::value)
    step_pairs<N>(prev, cur, p1, p2, lane);
  else
    step_values<E, N>(prev, cur, p1, p2, lane);
}

// ---- mbarriers and 1-D bulk copies (TMA) -----------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A wait
// that outlasts 2^30 polls (far beyond any launch) traps, so that a broken
// pipeline fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory into shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Order this thread's generic-proxy shared-memory accesses before later
// async-proxy (bulk copy) writes to the same buffer.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace sgm
