// Kernel 4: the last SGM direction fused with the winner-take-all tail.
//
// Replaces the JAX package's fused SGM tail probes, which are one function
// written two ways for the TPU compiler: scripts/probes/exp_fused_sgm.py
// `make_kernel` (the column loop unrolled, launched at :169) and
// scripts/probes/exp_fused_loop.py `make_kernel` (a fori_loop body, :118).
// Both are the tail of denseslam_tpu/ops/stereo.py `compute_depth`: the
// horizontal right-to-left path of `sgm_aggregate`, the sum with the other
// three directions, and the per-pixel maps `disparity_from_cost` derives
// from the summed volume, without writing that volume.
//
// Per image row, walking x = W-1 down to 0 from a zero carry:
//   L     = (C + min(L', L'(d-1) + P1, L'(d+1) + P1, min L' + P2)) - min L'
//   final = acc + L                  ("pallas": acc = (tb + bt) + lr)
//   final = extra + (acc + L)        ("xla":    acc = lr, extra = tb + bt)
// in the cost dtype, rounding after every add (as csrc/sgm.cu does), then
// per pixel (y, x):
//   best   first d of the minimum of final        (jnp.argmin)
//   cmin   that minimum, as f32
//   c0/c2  final at best -+ 1 as f32, 0 where that index is outside [0, D)
//   best_r argmin over d of final(x_r + d, d) for right pixel x_r = x:
//          the smallest d among equal minima, 0 when no candidate is below
//          BIG (1e4 in the cost dtype: 9984 in bf16), as the reference's
//          running strict-< argmin over D column shifts gives
//   c_at   raw C at best, as f32                    (only when c_at != null)
//   second min over |d - best| > 2 of raw C, BIG-filled, as f32
//
// The right-view argmin needs final(x_r + d, d) for d = 0 .. D-1, which the
// right-to-left walk produces at columns x_r + D - 1 down to x_r, in
// decreasing d. A rolling buffer of D (value, index) slots per row holds
// them: slot d at column x belongs to x_r = x - d, so moving one column
// left shifts the buffer down by one slot (one shuffle per buffer), a fresh
// (BIG, 0) enters slot D-1, column x's D candidates update slots 0..D-1
// with `<=` (the later, smaller d wins a tie) guarded by `< BIG`, and
// slot 0 is complete: it is x_r = x's answer. Nothing of the volume is
// written.
//
// Layout, as csrc/sgm.cu: one warp per row; lane l holds disparities
// [l*K, l*K + K) with K = D / 32, so d-1 / d+1 neighbours cross lanes by
// one shuffle and every min / argmin over D is a 5-step shuffle reduction.
// Lane 0 writes the row's maps.
//
// Bound on the H100: bytes. The function reads cost and acc (and extra for
// "xla") once and writes 5-7 (H, W) maps of 4 bytes: at 370x1226x128 bf16
// 232-348 MB, 0.069-0.104 ms at 3.35 TB/s; about 60 operations per
// element stay far under the ALU rate. This first version is latency
// bound instead: the recurrence is serial along the row, so only 370 warps
// run, and each column's step chains about 27 shuffles (min L', the two
// neighbours, cmin, best, c0, c2, c_at, second and the two buffer shifts).
// The one-column prefetch of cost / acc / extra is what it does about it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float from(float x) { return x; }
  static __device__ __forceinline__ float f32(float x) { return x; }
};

template <>
struct Arith<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T add(T a, T b) { return __hadd(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub(a, b); }
  static __device__ __forceinline__ T mn(T a, T b) { return __hmin(a, b); }
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.0f); }
  static __device__ __forceinline__ T from(float x) { return __float2bfloat16(x); }
  static __device__ __forceinline__ float f32(T x) { return __bfloat162float(x); }
};

template <typename T, int K>
struct alignas(sizeof(T) * K) Vec {
  T v[K];
};

template <typename T, int K>
__device__ __forceinline__ Vec<T, K> load(const T* p) {
  return *reinterpret_cast<const Vec<T, K>*>(p);
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The f32 value at disparity `d` (held by lane d / K as element d % K) on
// every lane; 0 where d is outside [0, D).
template <int K>
__device__ __forceinline__ float value_at(const float (&v)[K], int d, int lane) {
  float mine = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (lane * K + k == d) mine = v[k];
  const int src = min(max(d, 0) / K, 31);
  const float got = __shfl_sync(kFull, mine, src);
  return (d >= 0 && d < 32 * K) ? got : 0.0f;
}

template <typename T, int K>
__global__ void __launch_bounds__(128)
sgm_final_kernel(const T* __restrict__ cost, const T* __restrict__ acc,
                 const T* __restrict__ extra, int h, int w, float p1f, float p2f,
                 int32_t* __restrict__ best_out, float* __restrict__ cmin_out,
                 float* __restrict__ c0_out, float* __restrict__ c2_out,
                 int32_t* __restrict__ best_r_out, float* __restrict__ c_at_out,
                 float* __restrict__ second_out) {
  using A = Arith<T>;
  constexpr int D = 32 * K;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= h) return;  // whole warps exit together
  const int lane = threadIdx.x & 31;
  const T p1 = A::from(p1f);
  const T p2 = A::from(p2f);
  const float big = A::f32(A::from(1e4f));  // the reference's _BIG in the cost dtype

  // element (row, x, d) at (row * w + x) * D + d
  long long off = ((long long)row * w + (w - 1)) * D + lane * K;
  const long long map0 = (long long)row * w;

  T prev[K];
  float rv[K];
  int ri[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    prev[k] = A::zero();
    rv[k] = big;
    ri[k] = 0;
  }
  Vec<T, K> cur = load<T, K>(cost + off);
  Vec<T, K> a = load<T, K>(acc + off);
  Vec<T, K> e = a;  // read only when extra is set
  if (extra != nullptr) e = load<T, K>(extra + off);

  for (int x = w - 1; x >= 0; --x) {
    Vec<T, K> cur_n = cur, a_n = a, e_n = e;
    if (x > 0) {
      cur_n = load<T, K>(cost + off - D);
      a_n = load<T, K>(acc + off - D);
      if (extra != nullptr) e_n = load<T, K>(extra + off - D);
    }

    // the recurrence step, as csrc/sgm.cu
    T m = prev[0];
#pragma unroll
    for (int k = 1; k < K; ++k) m = A::mn(m, prev[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = A::mn(m, __shfl_xor_sync(kFull, m, o));
    T lo = __shfl_up_sync(kFull, prev[K - 1], 1);
    T hi = __shfl_down_sync(kFull, prev[0], 1);
    if (lane == 0) lo = prev[0];
    if (lane == 31) hi = prev[K - 1];
    const T mp2 = A::add(m, p2);

    T L[K];
    float fin[K], raw[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T sp = k > 0 ? prev[k - 1] : lo;
      const T sn = k < K - 1 ? prev[k + 1] : hi;
      const T best = A::mn(A::mn(prev[k], A::add(sp, p1)), A::mn(A::add(sn, p1), mp2));
      L[k] = A::sub(A::add(cur.v[k], best), m);
      T f = A::add(L[k], a.v[k]);
      if (extra != nullptr) f = A::add(e.v[k], f);
      fin[k] = A::f32(f);
      raw[k] = A::f32(cur.v[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) prev[k] = L[k];

    // winner take all: min, first index of it, the parabola's taps
    float cmin = fin[0];
#pragma unroll
    for (int k = 1; k < K; ++k) cmin = fminf(cmin, fin[k]);
    cmin = warp_min(cmin);
    int bi = D;
#pragma unroll
    for (int k = K - 1; k >= 0; --k)
      if (fin[k] == cmin) bi = lane * K + k;
    bi = warp_min(bi);
    const float c0 = value_at<K>(fin, bi - 1, lane);
    const float c2 = value_at<K>(fin, bi + 1, lane);

    // right view: shift the rolling buffer down one slot, then offer this
    // column's candidates (slot d <-> x_r = x - d)
    const float rv_in = __shfl_down_sync(kFull, rv[0], 1);
    const int ri_in = __shfl_down_sync(kFull, ri[0], 1);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) {
      rv[k] = rv[k + 1];
      ri[k] = ri[k + 1];
    }
    rv[K - 1] = lane == 31 ? big : rv_in;
    ri[K - 1] = lane == 31 ? 0 : ri_in;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (fin[k] < big && fin[k] <= rv[k]) {
        rv[k] = fin[k];
        ri[k] = lane * K + k;
      }
    }

    // uniqueness-gate terms on the raw cost
    float c_at = 0.0f, second = 0.0f;
    if (c_at_out != nullptr) {
      c_at = value_at<K>(raw, bi, lane);
      float s = big;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (abs(lane * K + k - bi) > 2) s = fminf(s, raw[k]);
      second = warp_min(s);
    }

    if (lane == 0) {
      const long long p = map0 + x;
      best_out[p] = bi;
      cmin_out[p] = cmin;
      c0_out[p] = c0;
      c2_out[p] = c2;
      best_r_out[p] = ri[0];
      if (c_at_out != nullptr) {
        c_at_out[p] = c_at;
        second_out[p] = second;
      }
    }

    cur = cur_n;
    a = a_n;
    e = e_n;
    off -= D;
  }
}

template <typename T>
int launch_typed(const void* cost, const void* acc, const void* extra,
                 void* best, void* cmin, void* c0, void* c2, void* best_r,
                 void* c_at, void* second, int h, int w, int d, float p1,
                 float p2, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (h + threads / 32 - 1) / (threads / 32);
  const T* c = static_cast<const T*>(cost);
  const T* a = static_cast<const T*>(acc);
  const T* e = static_cast<const T*>(extra);
  int32_t* bo = static_cast<int32_t*>(best);
  float* mo = static_cast<float*>(cmin);
  float* c0o = static_cast<float*>(c0);
  float* c2o = static_cast<float*>(c2);
  int32_t* ro = static_cast<int32_t*>(best_r);
  float* ao = static_cast<float*>(c_at);
  float* so = static_cast<float*>(second);
#define SGM_FINAL_CASE(KK)                                                    \
  case KK:                                                                    \
    sgm_final_kernel<T, KK><<<blocks, threads, 0, stream>>>(                  \
        c, a, e, h, w, p1, p2, bo, mo, c0o, c2o, ro, ao, so);                 \
    break;
  switch (d / 32) {
    SGM_FINAL_CASE(1)
    SGM_FINAL_CASE(2)
    SGM_FINAL_CASE(4)
    SGM_FINAL_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SGM_FINAL_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch over an (h, w, d) volume, disparity contiguous. extra may be
// null ("pallas" order); c_at and second are both null or both set. The
// seven maps are (h, w): best and best_r int32, the others f32. d must be
// 32, 64, 128 or 256. is_bf16 selects __nv_bfloat16, else f32.
extern "C" int sgm_final_launch(const void* cost, const void* acc,
                                const void* extra, void* best, void* cmin,
                                void* c0, void* c2, void* best_r, void* c_at,
                                void* second, int h, int w, int d, float p1,
                                float p2, int is_bf16, void* stream) {
  if (d % 32 != 0 || (c_at == nullptr) != (second == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(cost, acc, extra, best, cmin, c0, c2,
                                       best_r, c_at, second, h, w, d, p1, p2, s);
  return launch_typed<float>(cost, acc, extra, best, cmin, c0, c2, best_r,
                             c_at, second, h, w, d, p1, p2, s);
}
