// Kernel 2: one SGM path direction over an (H, W, D) cost volume.
//
// Replaces the JAX package's Pallas SGM aggregation,
// denseslam_tpu/ops/sgm_pallas.py `_v_kernel` / `_h_kernel` (step `_step`,
// launched by `_direction_call`), and the same recurrence that the default
// "xla" backend runs as `lax.scan` (denseslam_tpu/ops/stereo.py
// `sgm_aggregate`). Along one path, from a zero carry:
//   L = (C + min(L', L'(d-1) + P1, L'(d+1) + P1, min L' + P2)) - min L'
// with the edges clamped as in `_step` (shift_p[0] = L'[0],
// shift_n[D-1] = L'[D-1]). Arithmetic runs in the cost dtype and rounds
// after every operation in the order the JAX expression is written; for
// bf16 that is __nv_bfloat16 arithmetic.
//
// The direction sum is chosen by the caller through two optional inputs:
//   out = (extra + (L + acc))   with acc / extra skipped when null,
// which gives ((v_fwd + v_bwd) + h_fwd) + h_bwd for the "pallas" backend
// (acc = out, accumulating in place) and (tb + bt) + (lr + rl) for "xla"
// (the last launch adds the vertical pair as `extra`).
//
// Layout: one warp per scanline (a row for the horizontal paths, a column
// for the vertical ones); lane l holds disparities [l*K, l*K + K) with
// K = D / 32, so the d-1 / d+1 neighbours cross lanes by one shuffle and
// min L' is a 5-step shuffle reduction: the step needs no __syncthreads.
// (A 128-thread block per scanline, one thread per disparity exchanging
// neighbours through shared memory, would need two block barriers per
// step; the warp needs none.) The path is walked sequentially inside the
// warp, prefetching the next step's costs.
//
// Bound on the H100: bytes. The function reads the volume once and
// writes the sum once: 232 MB for the 370x1226x128 bf16 volume, 0.069 ms
// at 3.35 TB/s (about 35 ops per element are far below the ALU rate).
// This design moves more: the four launches read the cost volume 4 times,
// read the running sum 3 times and write it 4 times, 11 volume passes,
// 1.28 GB, 0.38 ms. The D axis is contiguous, so every step of both
// orientations reads 32*K consecutive elements (coalesced). The
// recurrence is serial along each path, so parallelism is only 370
// (horizontal) or 1226 (vertical) warps, and step latency, not bytes,
// sets the time; the one-step prefetch is what this first version does
// about it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
struct Arith;

template <>
struct Arith<float> {
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ float mn(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ float zero() { return 0.0f; }
  static __device__ __forceinline__ float from(float x) { return x; }
};

template <>
struct Arith<__nv_bfloat16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T add(T a, T b) { return __hadd(a, b); }
  static __device__ __forceinline__ T sub(T a, T b) { return __hsub(a, b); }
  static __device__ __forceinline__ T mn(T a, T b) { return __hmin(a, b); }
  static __device__ __forceinline__ T zero() { return __float2bfloat16(0.0f); }
  static __device__ __forceinline__ T from(float x) { return __float2bfloat16(x); }
};

template <typename T, int K>
struct alignas(sizeof(T) * K) Vec {
  T v[K];
};

template <typename T, int K>
__device__ __forceinline__ Vec<T, K> load(const T* p) {
  return *reinterpret_cast<const Vec<T, K>*>(p);
}

template <typename T, int K>
__global__ void __launch_bounds__(128)
sgm_path_kernel(const T* __restrict__ cost, const T* acc, const T* extra, T* out,
                int lines, int steps, long long line_stride, long long step_stride,
                int reverse, float p1f, float p2f) {
  using A = Arith<T>;
  const int line = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (line >= lines) return;  // whole warps exit together
  const int lane = threadIdx.x & 31;
  const T p1 = A::from(p1f);
  const T p2 = A::from(p2f);
  const long long base = (long long)line * line_stride + lane * K;
  const long long dstep = reverse ? -step_stride : step_stride;
  long long off = base + (reverse ? (long long)(steps - 1) * step_stride : 0);

  T prev[K];
#pragma unroll
  for (int k = 0; k < K; ++k) prev[k] = A::zero();
  Vec<T, K> cur = load<T, K>(cost + off);

  for (int n = 0; n < steps; ++n) {
    Vec<T, K> nxt = cur;
    if (n + 1 < steps) nxt = load<T, K>(cost + off + dstep);

    T m = prev[0];
#pragma unroll
    for (int k = 1; k < K; ++k) m = A::mn(m, prev[k]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = A::mn(m, __shfl_xor_sync(0xffffffffu, m, o));
    T lo = __shfl_up_sync(0xffffffffu, prev[K - 1], 1);
    T hi = __shfl_down_sync(0xffffffffu, prev[0], 1);
    if (lane == 0) lo = prev[0];
    if (lane == 31) hi = prev[K - 1];
    const T mp2 = A::add(m, p2);

    T L[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const T sp = k > 0 ? prev[k - 1] : lo;
      const T sn = k < K - 1 ? prev[k + 1] : hi;
      const T best = A::mn(A::mn(prev[k], A::add(sp, p1)), A::mn(A::add(sn, p1), mp2));
      L[k] = A::sub(A::add(cur.v[k], best), m);
    }

    Vec<T, K> res;
    if (acc != nullptr) {
      const Vec<T, K> a = load<T, K>(acc + off);
#pragma unroll
      for (int k = 0; k < K; ++k) res.v[k] = A::add(L[k], a.v[k]);
    } else {
#pragma unroll
      for (int k = 0; k < K; ++k) res.v[k] = L[k];
    }
    if (extra != nullptr) {
      const Vec<T, K> e = load<T, K>(extra + off);
#pragma unroll
      for (int k = 0; k < K; ++k) res.v[k] = A::add(e.v[k], res.v[k]);
    }
    *reinterpret_cast<Vec<T, K>*>(out + off) = res;

#pragma unroll
    for (int k = 0; k < K; ++k) prev[k] = L[k];
    cur = nxt;
    off += dstep;
  }
}

template <typename T>
int launch_typed(const void* cost, const void* acc, const void* extra, void* out,
                 int lines, int steps, int line_stride, int step_stride,
                 int reverse, int d, float p1, float p2, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (lines + threads / 32 - 1) / (threads / 32);
  const T* c = static_cast<const T*>(cost);
  const T* a = static_cast<const T*>(acc);
  const T* e = static_cast<const T*>(extra);
  T* o = static_cast<T*>(out);
  switch (d / 32) {
    case 1:
      sgm_path_kernel<T, 1><<<blocks, threads, 0, stream>>>(
          c, a, e, o, lines, steps, line_stride, step_stride, reverse, p1, p2);
      break;
    case 2:
      sgm_path_kernel<T, 2><<<blocks, threads, 0, stream>>>(
          c, a, e, o, lines, steps, line_stride, step_stride, reverse, p1, p2);
      break;
    case 4:
      sgm_path_kernel<T, 4><<<blocks, threads, 0, stream>>>(
          c, a, e, o, lines, steps, line_stride, step_stride, reverse, p1, p2);
      break;
    case 8:
      sgm_path_kernel<T, 8><<<blocks, threads, 0, stream>>>(
          c, a, e, o, lines, steps, line_stride, step_stride, reverse, p1, p2);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One path direction. The volume is addressed as
// element(line, step, d) = line * line_stride + step * step_stride + d;
// D must be 32, 64, 128 or 256. is_bf16 selects __nv_bfloat16, else f32.
extern "C" int sgm_path_launch(const void* cost, const void* acc,
                               const void* extra, void* out, int lines,
                               int steps, int line_stride, int step_stride,
                               int reverse, int d, float p1, float p2,
                               int is_bf16, void* stream) {
  if (d % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (lines <= 0 || steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(cost, acc, extra, out, lines, steps,
                                       line_stride, step_stride, reverse, d,
                                       p1, p2, s);
  return launch_typed<float>(cost, acc, extra, out, lines, steps, line_stride,
                             step_stride, reverse, d, p1, p2, s);
}
