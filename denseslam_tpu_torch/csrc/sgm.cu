// Kernel 2: one SGM path direction over an (H, W, D) cost volume.
//
// Replaces the JAX package's Pallas SGM aggregation,
// denseslam_tpu/ops/sgm_pallas.py `_v_kernel` / `_h_kernel` (step `_step`,
// launched by `_direction_call`), and the same recurrence that the default
// "xla" backend runs as `lax.scan` (denseslam_tpu/ops/stereo.py
// `sgm_aggregate`). Along one path, from a zero carry:
//   L = (C + min(L', L'(d-1) + P1, L'(d+1) + P1, min L' + P2)) - min L'
// (csrc/sgm_common.cuh `step`), each op rounded in the cost dtype in the
// order the JAX expression is written; for bf16 that is __nv_bfloat16
// arithmetic.
//
// The direction sum is chosen by the caller through two optional inputs:
//   out = (extra + (L + acc))   with acc / extra skipped when null,
// which gives ((v_fwd + v_bwd) + h_fwd) + h_bwd for the "pallas" backend
// (acc = out, accumulating in place) and (tb + bt) + (lr + rl) for "xla"
// (the last launch adds the vertical pair as `extra`).
//
// Bound on the H100: bytes. One launch reads the cost volume (and acc,
// extra) once and writes its output once: 232 MB for a 370x1226x128 bf16
// launch without acc, 348 MB with it, 0.069 / 0.104 ms at 3.35 TB/s (about
// 9 ops per element are far below the ALU rate).
//
// Design. The recurrence is serial along each scanline, so each scanline
// is one warp (lane l holds disparities [l*K, l*K + K), K = D / 32) and the
// time per step is a latency chain; the first version also waited on device
// memory inside that chain (a one-step prefetch; for acc = out the acc read
// could not be hoisted at all). Here a CTA takes G adjacent scanlines
// (G = 4 for the vertical paths, whose adjacent columns are contiguous: each
// staged row is one run of G*D elements; G = 1 for the horizontal paths,
// whose whole chunk of steps is one run) plus one producer warp. One
// elected producer thread keeps a ring of kStages chunks of about 8 KB per
// input in flight with 1-D bulk copies (cp.async.bulk, completion counted
// on a `full` mbarrier; the recurrence warps release a stage on its `empty`
// mbarrier). With acc = out a stage is loaded before any element of it is
// written, so the in-place launch stays exact. The recurrence warps then
// touch device memory only to store: they load the inputs of a few steps
// from shared memory at once, walk pointers instead of recomputing 64-bit
// offsets, and hold bf16 in packed pairs (sgm_common.cuh `Lane`), so that a
// step is about 45 instructions. min L' is the lane's values as a tree and
// then one `redux.sync` over an order-preserving key, in place of the first
// version's 5 xor-shuffle rounds: on an H100 shuffles took lr 0.147 ->
// 0.218 ms and bt 0.143 -> 0.155 ms, though tb 0.101 -> 0.093 ms (PERF.md).
//
// Measured on an H100 at 370x1226x128 bf16 (PERF.md): a horizontal step
// takes about 120 ns, so the horizontal launch, with 370 scanlines, stays
// latency bound at about half of its bytes bound; the vertical launches,
// with 1226, run at about 70% of theirs.

#include "sgm_common.cuh"

namespace {

using namespace sgm;

constexpr int kStages = 4;
constexpr int kStageBytes = 8192;   // per input and stage, about
constexpr int kGroup = 4;           // scanlines a CTA when they are adjacent
constexpr int kBarBytes = 128;      // the mbarriers, ahead of the stages

template <typename T, int K>
__global__ void __launch_bounds__(32 * (1 + kGroup))
sgm_path_kernel(const T* cost, const T* acc, const T* extra, T* out, int lines,
                int steps, long long line_stride, long long step_stride,
                int reverse, int group, int chunk, float p1f, float p2f) {
  constexpr int D = 32 * K;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  T* buf = reinterpret_cast<T*>(smem + kBarBytes);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int line0 = blockIdx.x * group;
  const int nlines = min(group, lines - line0);
  const int ntens = 1 + (acc != nullptr) + (extra != nullptr);
  const int pitch = group * D;                    // one step in a stage
  const int tens_elems = chunk * pitch;           // one input in a stage
  const int nchunks = (steps + chunk - 1) / chunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], nlines * 32);
    }
    fence_mbar_init();
  }
  __syncthreads();

  // chunk i covers steps [lo, lo + n), walked forward or from the top
  auto range = [&](int i, int& lo, int& n) {
    if (reverse) {
      const int hi = steps - i * chunk;
      lo = max(0, hi - chunk);
      n = hi - lo;
    } else {
      lo = i * chunk;
      n = min(chunk, steps - lo);
    }
  };

  if (warp == 0) {  // producer
    if (lane != 0) return;
    const T* src[3] = {cost, acc != nullptr ? acc : extra, extra};
    const uint32_t run = nlines * D * sizeof(T);
    const bool one_copy = step_stride == (long long)nlines * D && nlines == group;
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      int lo, n;
      range(i, lo, n);
      mbar_expect_tx(&full[s], run * n * ntens);
      for (int t = 0; t < ntens; ++t) {
        const T* g = src[t] + (long long)line0 * line_stride + (long long)lo * step_stride;
        T* dst = buf + (s * ntens + t) * tens_elems;
        if (one_copy) {
          bulk_load(dst, g, run * n, &full[s]);
        } else {
          for (int j = 0; j < n; ++j)
            bulk_load(dst + j * pitch, g + (long long)j * step_stride, run, &full[s]);
        }
      }
    }
    return;
  }

  const int gi = warp - 1;  // this warp's scanline in the group
  if (gi >= nlines) return;
  using E = typename Lane<T, K>::E;
  constexpr int N = Lane<T, K>::N;
  constexpr int U = N >= 8 ? 1 : (N >= 4 ? 2 : 4);  // steps whose inputs load together
  using V = Vec<E, N>;
  const E p1 = splat<E>(p1f);
  const E p2 = splat<E>(p2f);
  T* o_line = out + (long long)(line0 + gi) * line_stride + lane * K;
  const bool has_acc = acc != nullptr;
  const bool has_extra = extra != nullptr;
  const int a_off = has_acc ? tens_elems : 0;   // acc and extra in the stage
  const int e_off = a_off + tens_elems;

  E prev[N];
#pragma unroll
  for (int k = 0; k < N; ++k) prev[k] = splat<E>(0.0f);
  // one step: the recurrence, the direction sum, the store
  auto one = [&](const V& c, const V& a, const V& e, T* o) {
    step<E, N>(prev, c.v, p1, p2, lane);
    V res;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      res.v[k] = has_acc ? add(prev[k], a.v[k]) : prev[k];
      if (has_extra) res.v[k] = add(e.v[k], res.v[k]);
    }
    store<E, N>(o, res);
  };

  for (int i = 0; i < nchunks; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    int lo, n;
    range(i, lo, n);
    const int j0 = reverse ? n - 1 : 0;
    const int ps = reverse ? -pitch : pitch;                        // a step in the stage
    const long long os = reverse ? -step_stride : step_stride;     // and in the output
    const T* pc = buf + s * ntens * tens_elems + j0 * pitch + gi * D + lane * K;
    T* po = o_line + (long long)(lo + j0) * step_stride;
    int t = 0;
    for (; t + U <= n; t += U) {
      // the inputs of U steps, loaded before any of their steps
      V c[U], a[U], e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        c[u] = load<E, N>(pc + u * ps);
        if (has_acc) a[u] = load<E, N>(pc + a_off + u * ps);
        if (has_extra) e[u] = load<E, N>(pc + e_off + u * ps);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) one(c[u], a[u], e[u], po + u * os);
      pc += U * ps;
      po += U * os;
    }
    for (; t < n; ++t) {   // the rest of a short last chunk
      V c = load<E, N>(pc), a = c, e = c;
      if (has_acc) a = load<E, N>(pc + a_off);
      if (has_extra) e = load<E, N>(pc + e_off);
      one(c, a, e, po);
      pc += ps;
      po += os;
    }
    mbar_arrive(&empty[s]);
  }
}

template <typename T, int K>
int launch_k(const void* cost, const void* acc, const void* extra, void* out,
             int lines, int steps, int line_stride, int step_stride, int reverse,
             float p1, float p2, cudaStream_t stream) {
  constexpr int D = 32 * K;
  // adjacent scanlines (the vertical paths) are grouped so that each staged
  // step is one contiguous run
  const int group = line_stride == D ? kGroup : 1;
  const int chunk = max(1, kStageBytes / (group * D * (int)sizeof(T)));
  const int ntens = 1 + (acc != nullptr) + (extra != nullptr);
  const size_t smem =
      kBarBytes + (size_t)kStages * ntens * chunk * group * D * sizeof(T);
  auto kern = sgm_path_kernel<T, K>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int blocks = (lines + group - 1) / group;
  kern<<<blocks, 32 * (1 + group), smem, stream>>>(
      static_cast<const T*>(cost), static_cast<const T*>(acc),
      static_cast<const T*>(extra), static_cast<T*>(out), lines, steps,
      line_stride, step_stride, reverse, group, chunk, p1, p2);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* cost, const void* acc, const void* extra, void* out,
                 int lines, int steps, int line_stride, int step_stride,
                 int reverse, int d, float p1, float p2, cudaStream_t s) {
  switch (d / 32) {
    case 1:
      return launch_k<T, 1>(cost, acc, extra, out, lines, steps, line_stride,
                            step_stride, reverse, p1, p2, s);
    case 2:
      return launch_k<T, 2>(cost, acc, extra, out, lines, steps, line_stride,
                            step_stride, reverse, p1, p2, s);
    case 4:
      return launch_k<T, 4>(cost, acc, extra, out, lines, steps, line_stride,
                            step_stride, reverse, p1, p2, s);
    case 8:
      return launch_k<T, 8>(cost, acc, extra, out, lines, steps, line_stride,
                            step_stride, reverse, p1, p2, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One path direction. The volume is addressed as
// element(line, step, d) = line * line_stride + step * step_stride + d;
// D must be 32, 64, 128 or 256 and every pointer 16-byte aligned. is_bf16
// selects __nv_bfloat16, else f32.
extern "C" int sgm_path_launch(const void* cost, const void* acc,
                               const void* extra, void* out, int lines,
                               int steps, int line_stride, int step_stride,
                               int reverse, int d, float p1, float p2,
                               int is_bf16, void* stream) {
  if (d % 32 != 0 || !aligned16(cost) || !aligned16(acc) || !aligned16(extra) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lines <= 0 || steps <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(cost, acc, extra, out, lines, steps,
                                       line_stride, step_stride, reverse, d,
                                       p1, p2, s);
  return launch_typed<float>(cost, acc, extra, out, lines, steps, line_stride,
                             step_stride, reverse, d, p1, p2, s);
}
