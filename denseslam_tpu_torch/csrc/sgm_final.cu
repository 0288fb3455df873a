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
// Bound on the H100: bytes. The function reads cost and acc (and extra for
// "xla") once and writes 5-7 (H, W) maps of 4 bytes: at 370x1226x128 bf16
// 245-361 MB, 0.073-0.108 ms at 3.35 TB/s; about 16 operations per element
// stay far under the ALU rate.
//
// Design. One CTA per row (370 CTAs over the 132 SMs), three roles:
//  * warp 0, one elected thread: the producer. It keeps a ring of kStages
//    chunks of `chunk` columns (about 4 KB per input: 16 columns of bf16 at
//    D = 128) of cost, acc and extra in flight with 1-D bulk copies
//    (cp.async.bulk; a row's (x, d) slab is contiguous, so a chunk of one
//    input is one copy), counted on the stage's `full` mbarrier.
//  * warp 1: the recurrence. It walks the columns from shared memory, the
//    inputs of a few columns loaded at once, holds bf16 in packed pairs as
//    csrc/sgm.cu does, and writes `final` in the cost dtype over acc in the
//    stage (lossless: the maps convert to f32 only after the sum is
//    rounded), then arrives on the stage's `done` barrier. Its per-column
//    chain is min L' (the lane's values, then one redux.sync over an
//    order-preserving key, sgm_common.cuh), the two neighbour shuffles and
//    the step's adds; nothing of the WTA.
//  * warps 2-7: the winner take all, a finished chunk's columns in turn,
//    lane l holding d = k*32 + l. best, cmin, second are redux.sync
//    reductions; c0, c2, c_at are shared-memory reads at best -+ 1 and
//    best. The right-view argmin is a commutative min: each column x offers
//    final(x, d) to right pixel x - d as the key (order_key(final), d),
//    with atomicMin on a ring of kSlots slots in shared memory; a slot
//    starts at (key(BIG), 0), so the smallest d among equal minima wins and
//    a pixel with no candidate below BIG keeps d = 0. Pixel x_r is complete
//    once columns x_r .. x_r + D - 1 are, i.e. when its own chunk is. (A
//    diagonal read of a ring of D + 2*chunk finished columns gives the same
//    answer, but at f32 and D = 256 that ring alone is 288 KB, over the
//    227 KB a CTA can have; the slots take 4 KB at any D.) After a
//    named barrier over the WTA warps, they write the chunk's seven maps
//    coalesced from a double-buffered staging area, reset the chunk's
//    slots and release the stage on its `empty` barrier.
// Shared memory at bf16, D = 128, "xla": 5 stages x 3 inputs x 4 KB + 2 KB
// of slots + 1 KB, 63 KB: three CTAs an SM, all 370 rows in one wave. Six
// WTA warps: with fewer the recurrence waits for stages they have not yet
// released; 8 stages, or 8 KB chunks, leave room for only two CTAs an SM
// and two waves (a sweep on an H100; PERF.md).

#include "sgm_common.cuh"

namespace {

using namespace sgm;

constexpr int kStages = 5;
constexpr int kStageBytes = 4096;   // per input and stage, about
constexpr int kWtaWarps = 6;
constexpr int kThreads = 32 * (2 + kWtaWarps);
constexpr int kSlots = 512;         // >= D + 2 * chunk, a power of two
constexpr int kMaps = 6;            // staged maps: best, cmin, c0, c2, c_at, second

// A right-view candidate (value, d), ordered by value, then by d.
template <typename T>
struct Slot;

template <>
struct Slot<__nv_bfloat16> {   // a bf16 value's key is the top 16 bits
  using type = unsigned int;
  static __device__ __forceinline__ type pack(float v, int d) {
    return (order_key(v) & 0xffff0000u) | static_cast<unsigned>(d);
  }
  static __device__ __forceinline__ int index(type s) { return static_cast<int>(s & 0xffffu); }
};

template <>
struct Slot<float> {
  using type = unsigned long long;
  static __device__ __forceinline__ type pack(float v, int d) {
    return (static_cast<type>(order_key(v)) << 32) | static_cast<unsigned>(d);
  }
  static __device__ __forceinline__ int index(type s) { return static_cast<int>(s & 0xffffffffu); }
};

__device__ __forceinline__ void wta_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kWtaWarps) : "memory");
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
sgm_final_kernel(const T* cost, const T* acc, const T* extra, int w, int chunk,
                 float p1f, float p2f, int32_t* best_out, float* cmin_out,
                 float* c0_out, float* c2_out, int32_t* best_r_out,
                 float* c_at_out, float* second_out) {
  using A = Arith<T>;
  using S = Slot<T>;
  using SlotT = typename S::type;
  constexpr int D = 32 * K;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* done = full + kStages;
  uint64_t* empty = done + kStages;
  SlotT* slots = reinterpret_cast<SlotT*>(smem + 256);
  float* staged = reinterpret_cast<float*>(slots + kSlots);    // [2][kMaps][chunk]
  T* buf = reinterpret_cast<T*>(staged + 2 * kMaps * chunk);   // [stage][input][chunk][D]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x;
  const bool unique = c_at_out != nullptr;
  const int ntens = extra != nullptr ? 3 : 2;
  const int tens_elems = chunk * D;
  const int nchunks = (w + chunk - 1) / chunk;
  const float big = A::f32(A::from(1e4f));   // the reference's _BIG in the cost dtype
  const SlotT slot0 = S::pack(big, 0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], 32);
      mbar_init(&empty[s], 32 * kWtaWarps);
    }
    fence_mbar_init();
  }
  for (int i = threadIdx.x; i < kSlots; i += kThreads) slots[i] = slot0;
  __syncthreads();

  // chunk i covers columns [lo, lo + n), from the right
  auto range = [&](int i, int& lo, int& n) {
    const int hi = w - i * chunk;
    lo = max(0, hi - chunk);
    n = hi - lo;
  };
  auto stage = [&](int s, int t) { return buf + (s * ntens + t) * tens_elems; };

  if (warp == 0) {  // producer
    if (lane != 0) return;
    const T* src[3] = {cost, acc, extra};
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % kStages;
      if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
      int lo, n;
      range(i, lo, n);
      const uint32_t bytes = n * D * sizeof(T);
      mbar_expect_tx(&full[s], bytes * ntens);
      for (int t = 0; t < ntens; ++t)
        bulk_load(stage(s, t), src[t] + ((long long)row * w + lo) * D, bytes, &full[s]);
    }
    return;
  }

  if (warp == 1) {  // the recurrence
    using E = typename Lane<T, K>::E;
    constexpr int N = Lane<T, K>::N;
    constexpr int U = N >= 8 ? 1 : (N >= 4 ? 2 : 4);  // columns whose inputs load together
    using V = Vec<E, N>;
    const E p1 = splat<E>(p1f);
    const E p2 = splat<E>(p2f);
    const bool has_extra = extra != nullptr;
    E prev[N];
#pragma unroll
    for (int k = 0; k < N; ++k) prev[k] = splat<E>(0.0f);
    // one column: the recurrence, then final over acc in the stage
    auto one = [&](const V& c, const V& a, const V& e, T* pa) {
      step<E, N>(prev, c.v, p1, p2, lane);
      V fin;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        fin.v[k] = add(prev[k], a.v[k]);
        if (has_extra) fin.v[k] = add(e.v[k], fin.v[k]);
      }
      store<E, N>(pa, fin);
    };
    for (int i = 0; i < nchunks; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      int lo, n;
      range(i, lo, n);
      // the chunk's columns from the right; acc (overwritten by final) and
      // extra lie one and two inputs further on in the stage
      T* pc = stage(s, 0) + (n - 1) * D + lane * K;
      int t = 0;
      for (; t + U <= n; t += U) {
        V c[U], a[U], e[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          c[u] = load<E, N>(pc - u * D);
          a[u] = load<E, N>(pc + tens_elems - u * D);
          if (has_extra) e[u] = load<E, N>(pc + 2 * tens_elems - u * D);
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          one(c[u], a[u], e[u], pc + tens_elems - u * D);
        pc -= U * D;
      }
      for (; t < n; ++t) {   // the rest of a short last chunk
        V c = load<E, N>(pc), a = load<E, N>(pc + tens_elems), e = c;
        if (has_extra) e = load<E, N>(pc + 2 * tens_elems);
        one(c, a, e, pc + tens_elems);
        pc -= D;
      }
      fence_proxy_async();   // before the stage is loaded again
      mbar_arrive(&done[s]);
    }
    return;
  }

  // winner take all: warps 2 .. 2 + kWtaWarps - 1
  const int wi = warp - 2;
  const int tid = threadIdx.x - 64;
  float* out_f[kMaps] = {reinterpret_cast<float*>(best_out), cmin_out, c0_out,
                         c2_out, c_at_out, second_out};
  const int nmaps = unique ? kMaps : 4;
  const long long row0 = (long long)row * w;
  for (int i = 0; i < nchunks; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    mbar_wait(&done[s], (i / kStages) & 1);
    int lo, n;
    range(i, lo, n);
    float* st = staged + (i & 1) * kMaps * chunk;
    for (int j = wi; j < n; j += kWtaWarps) {
      const int x = lo + j;
      const T* fc = stage(s, 1) + j * D;
      const T* rc = stage(s, 0) + j * D;
      float f[K];
#pragma unroll
      for (int k = 0; k < K; ++k) f[k] = A::f32(fc[k * 32 + lane]);
      float m = f[0];
#pragma unroll
      for (int k = 1; k < K; ++k) m = fminf(m, f[k]);
      const float cmin = warp_min(m);
      unsigned bi = D;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if (f[k] == cmin) bi = k * 32 + lane;
      const int best = static_cast<int>(__reduce_min_sync(kFull, bi));
      // right view: offer final(x, d) to pixel x - d
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int d = k * 32 + lane;
        if (d <= x) atomicMin(&slots[(x - d) & (kSlots - 1)], S::pack(f[k], d));
      }
      if (unique) {
        float sm = big;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int d = k * 32 + lane;
          if (abs(d - best) > 2) sm = fminf(sm, A::f32(rc[d]));
        }
        const float second = warp_min(sm);
        if (lane == 0) {
          st[4 * chunk + j] = A::f32(rc[best]);
          st[5 * chunk + j] = second;
        }
      }
      if (lane == 0) {
        st[j] = __int_as_float(best);
        st[chunk + j] = cmin;
        st[2 * chunk + j] = best > 0 ? A::f32(fc[best - 1]) : 0.0f;
        st[3 * chunk + j] = best < D - 1 ? A::f32(fc[best + 1]) : 0.0f;
      }
    }
    wta_barrier();   // the chunk's columns, and every column right of it, done
    for (int t = tid; t < nmaps * n; t += 32 * kWtaWarps) {
      const int mp = t / n;
      const int j = t - mp * n;
      out_f[mp][row0 + lo + j] = st[mp * chunk + j];
    }
    for (int t = tid; t < n; t += 32 * kWtaWarps) {
      SlotT* sl = &slots[(lo + t) & (kSlots - 1)];
      best_r_out[row0 + lo + t] = S::index(*sl);
      *sl = slot0;
    }
    mbar_arrive(&empty[s]);
  }
}

template <typename T, int K>
int launch_k(const void* cost, const void* acc, const void* extra, void* best,
             void* cmin, void* c0, void* c2, void* best_r, void* c_at,
             void* second, int h, int w, float p1, float p2, cudaStream_t stream) {
  constexpr int D = 32 * K;
  const int chunk = min(64, max(4, kStageBytes / (D * (int)sizeof(T))));
  const int ntens = extra != nullptr ? 3 : 2;
  using SlotT = typename Slot<T>::type;
  const size_t smem = 256 + kSlots * sizeof(SlotT) + 2 * kMaps * chunk * sizeof(float) +
                      (size_t)kStages * ntens * chunk * D * sizeof(T);
  auto kern = sgm_final_kernel<T, K>;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kern<<<h, kThreads, smem, stream>>>(
      static_cast<const T*>(cost), static_cast<const T*>(acc),
      static_cast<const T*>(extra), w, chunk, p1, p2,
      static_cast<int32_t*>(best), static_cast<float*>(cmin),
      static_cast<float*>(c0), static_cast<float*>(c2),
      static_cast<int32_t*>(best_r), static_cast<float*>(c_at),
      static_cast<float*>(second));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_typed(const void* cost, const void* acc, const void* extra,
                 void* best, void* cmin, void* c0, void* c2, void* best_r,
                 void* c_at, void* second, int h, int w, int d, float p1,
                 float p2, cudaStream_t s) {
#define SGM_FINAL_CASE(KK)                                                     \
  case KK:                                                                     \
    return launch_k<T, KK>(cost, acc, extra, best, cmin, c0, c2, best_r, c_at, \
                           second, h, w, p1, p2, s);
  switch (d / 32) {
    SGM_FINAL_CASE(1)
    SGM_FINAL_CASE(2)
    SGM_FINAL_CASE(4)
    SGM_FINAL_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SGM_FINAL_CASE
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// One launch over an (h, w, d) volume, disparity contiguous. extra may be
// null ("pallas" order); c_at and second are both null or both set. The
// seven maps are (h, w): best and best_r int32, the others f32. d must be
// 32, 64, 128 or 256, the volumes 16-byte aligned. is_bf16 selects
// __nv_bfloat16, else f32.
extern "C" int sgm_final_launch(const void* cost, const void* acc,
                                const void* extra, void* best, void* cmin,
                                void* c0, void* c2, void* best_r, void* c_at,
                                void* second, int h, int w, int d, float p1,
                                float p2, int is_bf16, void* stream) {
  if (d % 32 != 0 || (c_at == nullptr) != (second == nullptr) ||
      !aligned16(cost) || !aligned16(acc) || !aligned16(extra))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h <= 0 || w <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(cost, acc, extra, best, cmin, c0, c2,
                                       best_r, c_at, second, h, w, d, p1, p2, s);
  return launch_typed<float>(cost, acc, extra, best, cmin, c0, c2, best_r, c_at,
                             second, h, w, d, p1, p2, s);
}
