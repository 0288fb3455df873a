// Kernel CV: the stereo cost volume in jitted XLA:CPU's rounding.
//
// It replaces no Pallas kernel. The JAX package computes the volume with
// jitted XLA (denseslam_tpu/ops/stereo.py `cost_volume`, `_box_along`); the
// port's plain version (ops/stereo.py `cost_volume_plain`) reproduces that
// program's rounding bit for bit, and this kernel computes the same
// function in one launch sequence, so the card's volume equals the CPU's
// on every element. Per disparity d, pixel (y, x):
//   * lm = fma(-box(left), rcp, left), rm likewise (XLA turns `/ area`
//     into `* rcp`, rcp = float32(1 / area), and contracts the subtraction
//     into one FMA: __fmaf_rn here);
//   * ad = |lm - shift_d(rm)|, the shifted image zero where x < d;
//   * c = box(ad) * rcp, then BIG where x < d, written once in the cost
//     dtype (f32, or bf16 rounded to nearest even) in (H, W, D) layout.
// box() is the separable (2r+1)^2 window sum of the JAX version: a
// cumulative sum along the row, then upper - lower with its edge and zero
// pads (`_box_along`), then the same along the column. Each cumulative
// sum adds in the order of XLA:CPU's reduce-window rewrite of cumsum
// (ops/stereo.py `scan16`): blocks of 16 summed left to right, the block
// totals scanned the same way (recursively), each block's exclusive carry
// added last.
//
// Four launches: (1) the row pass of both images, one thread a row;
// (2) their column pass and the FMA, one thread a column; (3) the row
// pass of the volume into an f32 (H, W, D) scratch, one thread per
// (y, d), consecutive threads on consecutive d, so the shifted right row
// is read and the scratch written coalesced; (4) its column pass into the
// output, one thread per (x, d). A thread keeps its line's block totals
// (lines up to 4096 long) and a ring of the last 2r + 2 cumulative sums
// (r up to 31) in local memory, and reads its line twice: once for the
// totals, once for the prefix and the window.
//
// Bound on the H100: bytes. The volume is written once, 116 MB in bf16
// and 232 MB in f32 at 370x1226x128 (about 0.035 ms and 0.069 ms at
// 3.35 TB/s). This simple design also writes the f32 scratch once and
// reads it twice (about 0.7 GB more); keeping the row pass's output on
// chip is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBase = 16;
constexpr int kMaxTotals = 256;   // lines up to kBase * kMaxTotals = 4096
constexpr int kMaxRing = 64;      // 2r + 2 for r up to 31
constexpr float kBig = 1e4f;      // the invalid-cost marker of ops/stereo.py

// The box sum of width 2r+1 along a line of n values: load(i) gives value
// i, emit(x, v) takes the window sum at x. The cumulative sum C adds in
// scan16's order; the window is C[min(x + r, n - 1)] - C[x - r - 1], the
// second term 0 where x - r - 1 < 0.
template <class Load, class Emit>
__device__ __forceinline__ void box_line(int n, int r, Load load, Emit emit) {
  float t1[kMaxTotals];
  const int m1 = (n + kBase - 1) / kBase;
  for (int b = 0; b < m1; ++b) {
    float s = 0.f;
    const int end = min(n, (b + 1) * kBase);
    for (int i = b * kBase; i < end; ++i) s += load(i);
    t1[b] = s;
  }
  // the inclusive scan of the block totals in the same order
  if (m1 <= kBase) {
    float acc = 0.f;
    for (int b = 0; b < m1; ++b) {
      acc += t1[b];
      t1[b] = acc;
    }
  } else {
    float t2[kBase];
    const int m2 = (m1 + kBase - 1) / kBase;
    for (int j = 0; j < m2; ++j) {
      float s = 0.f;
      const int end = min(m1, (j + 1) * kBase);
      for (int b = j * kBase; b < end; ++b) s += t1[b];
      t2[j] = s;
    }
    float acc = 0.f;
    for (int j = 0; j < m2; ++j) {
      acc += t2[j];
      t2[j] = acc;
    }
    for (int j = 0; j < m2; ++j) {
      const float c = j ? t2[j - 1] : 0.f;
      float s = 0.f;
      const int end = min(m1, (j + 1) * kBase);
      for (int b = j * kBase; b < end; ++b) {
        s += t1[b];
        t1[b] = s + c;
      }
    }
  }
  float ring[kMaxRing];
  const int len = 2 * r + 2;
  int head = 0;                   // ring slot of C[i]
  float last = 0.f;
  for (int b = 0; b < m1; ++b) {
    const float c = b ? t1[b - 1] : 0.f;
    float s = 0.f;
    const int end = min(n, (b + 1) * kBase);
    for (int i = b * kBase; i < end; ++i) {
      s += load(i);
      last = s + c;
      ring[head] = last;
      const int x = i - r;
      if (x >= 0) {
        int lo = head - (2 * r + 1);      // slot of C[x - r - 1]
        if (lo < 0) lo += len;
        emit(x, x - r - 1 >= 0 ? last - ring[lo] : last - 0.f);
      }
      head = head + 1 == len ? 0 : head + 1;
    }
  }
  // the last r windows read C[n - 1] as their upper end (the edge pad);
  // C[k] sits n - k slots behind `head`, at most 2r + 1
  for (int x = max(n - r, 0); x < n; ++x) {
    const int k = x - r - 1;
    if (k >= 0) {
      int slot = head - (n - k);
      if (slot < 0) slot += len;
      emit(x, last - ring[slot]);
    } else {
      emit(x, last - 0.f);
    }
  }
}

// (1) rows of both images: hb[img] = the row box sums
__global__ void cv_image_rows(const float* __restrict__ left,
                              const float* __restrict__ right,
                              float* __restrict__ hb, int h, int w, int r) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * h) return;
  const float* src = (t < h ? left : right) + (size_t)(t % h) * w;
  float* dst = hb + (size_t)t * w;
  box_line(w, r, [&](int i) { return src[i]; },
           [&](int x, float v) { dst[x] = v; });
}

// (2) columns of both images, then lm / rm = fma(-box, rcp, image)
__global__ void cv_image_cols(const float* __restrict__ left,
                              const float* __restrict__ right,
                              const float* __restrict__ hb,
                              float* __restrict__ lmrm, int h, int w, int r,
                              float rcp) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= 2 * w) return;
  const int img = t / w, x = t % w;
  const float* src = img ? right : left;
  const float* col = hb + (size_t)img * h * w + x;
  float* dst = lmrm + (size_t)img * h * w + x;
  box_line(h, r, [&](int i) { return col[(size_t)i * w]; },
           [&](int y, float v) {
             dst[(size_t)y * w] = __fmaf_rn(-v, rcp, src[(size_t)y * w + x]);
           });
}

// (3) rows of the volume: tmp[y, x, d] = the row box sums of
// |lm - shift_d(rm)|
__global__ void cv_volume_rows(const float* __restrict__ lm,
                               const float* __restrict__ rm,
                               float* __restrict__ tmp, int h, int w, int nd,
                               int r) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)h * nd) return;
  const int d = (int)(t % nd), y = (int)(t / nd);
  const float* lrow = lm + (size_t)y * w;
  const float* rrow = rm + (size_t)y * w;
  float* dst = tmp + (size_t)y * w * nd + d;
  box_line(w, r,
           [&](int i) { return fabsf(lrow[i] - (i >= d ? rrow[i - d] : 0.f)); },
           [&](int x, float v) { dst[(size_t)x * nd] = v; });
}

// (4) columns of the volume: out[y, x, d] = box * rcp, BIG where x < d
template <typename T>
__device__ __forceinline__ T to_cost(float v);
template <>
__device__ __forceinline__ float to_cost<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_cost<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void cv_volume_cols(const float* __restrict__ tmp,
                               T* __restrict__ out, int h, int w, int nd,
                               int r, float rcp) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)w * nd) return;
  const int d = (int)(t % nd), x = (int)(t / nd);
  const size_t stride = (size_t)w * nd;
  const float* col = tmp + (size_t)x * nd + d;
  T* dst = out + (size_t)x * nd + d;
  const bool invalid = x < d;
  box_line(h, r, [&](int i) { return col[i * stride]; },
           [&](int y, float v) {
             dst[y * stride] = to_cost<T>(invalid ? kBig : v * rcp);
           });
}

int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

// left, right f32 (h, w); hb, lmrm f32 (2, h, w) scratch; tmp f32
// (h, w, nd) scratch; out (h, w, nd) f32 (out_bf16 = 0) or bf16.
extern "C" int cost_volume_launch(const void* left, const void* right,
                                  void* hb, void* lmrm, void* tmp, void* out,
                                  int h, int w, int nd, int r, float rcp,
                                  int out_bf16, void* stream) {
  if (h <= 0 || w <= 0 || nd <= 0) return 0;
  if (h > kBase * kMaxTotals || w > kBase * kMaxTotals || r < 0 ||
      2 * r + 2 > kMaxRing)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(left);
  const float* rt = static_cast<const float*>(right);
  float* hbf = static_cast<float*>(hb);
  float* lr = static_cast<float*>(lmrm);
  float* tf = static_cast<float*>(tmp);
  cv_image_rows<<<blocks_for(2LL * h), kThreads, 0, s>>>(l, rt, hbf, h, w, r);
  cv_image_cols<<<blocks_for(2LL * w), kThreads, 0, s>>>(l, rt, hbf, lr, h, w,
                                                         r, rcp);
  cv_volume_rows<<<blocks_for((long long)h * nd), kThreads, 0, s>>>(
      lr, lr + (size_t)h * w, tf, h, w, nd, r);
  if (out_bf16)
    cv_volume_cols<__nv_bfloat16><<<blocks_for((long long)w * nd), kThreads,
                                    0, s>>>(
        tf, static_cast<__nv_bfloat16*>(out), h, w, nd, r, rcp);
  else
    cv_volume_cols<float><<<blocks_for((long long)w * nd), kThreads, 0, s>>>(
        tf, static_cast<float*>(out), h, w, nd, r, rcp);
  return static_cast<int>(cudaGetLastError());
}
