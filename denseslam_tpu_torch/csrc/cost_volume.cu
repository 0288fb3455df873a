// Kernel CV: the stereo cost volume in jitted XLA:CPU's rounding.
//
// It replaces no Pallas kernel. The JAX package computes the volume with
// jitted XLA (denseslam_tpu/ops/stereo.py:61 `cost_volume`, `_box_along`);
// the port's plain version (ops/stereo.py `cost_volume_plain`) reproduces
// that program's rounding bit for bit, and this kernel computes the same
// function, so the card's volume equals the CPU's on every element. Per
// disparity d, pixel (y, x):
//   * lm = fma(-box(left), rcp, left), rm likewise (XLA turns `/ area`
//     into `* rcp`, rcp = float32(1 / area), and contracts the subtraction
//     into one FMA: __fmaf_rn here);
//   * ad = |lm - shift_d(rm)|, the shifted image zero where x < d;
//   * c = box(ad) * rcp, then BIG where x < d, written once in the cost
//     dtype (f32, or bf16 rounded to nearest even) in (H, W, D) layout.
// box() is the separable (2r+1)^2 window sum of the JAX version: a
// cumulative sum C along the row, then C[min(x + r, n - 1)] - C[x - r - 1]
// (- 0 below the line), then the same along the column. C adds in the
// order of XLA:CPU's reduce-window rewrite of cumsum (ops/stereo.py
// `scan16`): blocks of 16 summed left to right from 0; the block totals
// summed the same way within groups of 16 blocks, the group totals left to
// right (two levels cover lines up to 4096); each block's carry (the
// inclusive sum of the blocks before it, in that order) added last.
//
// That order is causal: C[i] needs nothing past i, and block b's part of
// it is the in-block sum plus one carry. Two passes use that:
//   (1) cv_carries: every row's block carries, (H, ceil(W / 16), D) f32
//       for the volume (14.6 MB at 370x1226x128, L2-resident): one thread
//       per (y, d, block) sums its block of 16, then short scans over the
//       blocks of a group and over the groups, from the two rows staged
//       in shared memory;
//   (2) cv_fused, the volume: one CTA per x-strip of 32 columns and 16
//       disparities, each thread two disparities of one column, walks y
//       from top to bottom, 8 rows a step. It stages those rows of its
//       strip, the halo blocks that hold x - r - 1 and x + r, and their
//       carries (cp.async; the next rows are in flight while the current
//       ones are emitted); forms the rows' cumulative sums over that span
//       in shared memory (one (row, block, pair) chain of at most 16 adds
//       from 0, the carry added last); then each thread takes its rows'
//       windows and advances its columns' causal state (the running block
//       sum, group sum, group carry, block carry) in registers, and its
//       ring of the last 2r + 2 sums (in registers for the main path's
//       r = 3, where the ring is one step's 8 rows; in shared memory for
//       other radii), and writes out[y - r]; after the last row it emits
//       the last r rows from C[h - 1].
// The images have 2 x W columns, too few to walk 370 rows each, so their
// box takes one axis at a time with carries on both: cv_carries along the
// rows, cv_lines (a tile of 32 rows x 64 columns: in-block sums in place,
// the windows, written transposed into a small (2, W, H) scratch), then
// the same along the columns of that scratch, whose cv_lines writes lm
// and rm. Six launches in all.
//
// Bound on the H100: bytes. The volume is written once, 116 MB in bf16
// and 232 MB in f32 at 370x1226x128, with the two 1.8 MB images read once:
// 0.0357 ms and 0.0704 ms at 3.35 TB/s. What limited this kernel's first
// design, and what this one does about it:
//   * one thread per line in a 1226-long dependent chain, about 11 warps
//     an SM: here a chain is at most 16 adds (a block) in a row pass and
//     one add a row in the volume's column pass, over 78k threads (two
//     columns each), all resident at once;
//   * each line read twice (block totals, then the windows) and the
//     per-thread totals and ring in local memory (1.3 KB of stack): the
//     carries come from pass (1), so the fused pass reads each row of lm
//     and rm once per strip (plus the halo), and the ring is in registers
//     or shared memory;
//   * an f32 (H, W, D) scratch of the row pass, 232 MB written once and
//     read twice: the row pass stays in shared memory; DRAM traffic is the
//     output plus the carries.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBase = 16;
constexpr int kMaxBlocks = 256;   // lines up to kBase * kMaxBlocks = 4096
constexpr int kMaxRadius = 31;
constexpr float kBig = 1e4f;      // the invalid-cost marker of ops/stereo.py

// the volume's fused pass: x-strip, disparity chunk, rows a step
constexpr int kVolXs = 32, kVolDc = 16;
constexpr int kRows = 8;
// the carries pass: disparities (channels) a CTA
constexpr int kVolCarryDc = 32, kImgCarryDc = 2;
constexpr int kCarryThreads = 256;

template <typename T>
__device__ __forceinline__ T to_cost(float v);
template <>
__device__ __forceinline__ float to_cost<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_cost<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// (1) car[(y * m1 + b) * nd + d]: the carry of block b of row y,
// disparity d of the volume (a = lm, b = rm) or channel d of the images
// (a = left, b = right, nd = 2). Grid (h, ceil(nd / DC)). The volume's
// row of b is staged shifted by `off` columns, zeros in front, so that
// b[p - d] is read without a test; a thread takes two disparities of a
// block, which share a's loads and all but one of b's.
template <bool kVolume, int DC>
__global__ void __launch_bounds__(kCarryThreads)
    cv_carries(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ car, int h, int w, int nd) {
  static_assert(!kVolume || DC % 2 == 0, "disparity pairs");
  extern __shared__ __align__(16) float sm[];
  const int y = blockIdx.x, d0 = blockIdx.y * DC;
  const int m1 = (w + kBase - 1) / kBase, ng = (m1 + kBase - 1) / kBase;
  const int off = kVolume ? d0 + DC - 1 : 0;
  float* ra = sm;                  // row y of a
  float* rb = sm + w;              // row y of b: rb[j] = b[j - off]
  float* tot = rb + w + off;       // (m1, DC): totals, then group prefixes
  float* grp = tot + m1 * DC;      // (ng, DC): group totals, then prefixes
  for (int i = threadIdx.x; i < w; i += blockDim.x)
    ra[i] = a[(size_t)y * w + i];
  for (int j = threadIdx.x; j < w + off; j += blockDim.x)
    rb[j] = j >= off ? b[(size_t)y * w + j - off] : 0.f;
  __syncthreads();
  if (kVolume) {
    constexpr int kPairs = DC / 2;
    for (int t = threadIdx.x; t < m1 * kPairs; t += blockDim.x) {
      const int blk = t / kPairs, dg = d0 + 2 * (t % kPairs);
      const int p0 = blk * kBase, end = min(w, p0 + kBase);
      const float* rbd = rb + off - dg;          // rbd[p] = b[p - dg]
      float s0 = 0.f, s1 = 0.f, prev = rbd[p0 - 1];
      for (int p = p0; p < end; ++p) {
        const float av = ra[p], cur = rbd[p];
        s0 += fabsf(av - cur);                   // disparity dg
        s1 += fabsf(av - prev);                  // dg + 1: b[p - dg - 1]
        prev = cur;
      }
      tot[blk * DC + 2 * (t % kPairs)] = s0;
      tot[blk * DC + 2 * (t % kPairs) + 1] = s1;
    }
  } else {
    for (int t = threadIdx.x; t < m1 * DC; t += blockDim.x) {
      const int blk = t / DC, c = t % DC;
      const float* src = c ? rb : ra;
      const int end = min(w, (blk + 1) * kBase);
      float s = 0.f;
      for (int p = blk * kBase; p < end; ++p) s += src[p];
      tot[t] = s;
    }
  }
  __syncthreads();
  // the inclusive sums of the totals within each group of 16 blocks
  for (int t = threadIdx.x; t < ng * DC; t += blockDim.x) {
    const int g = t / DC, dl = t % DC;
    const int end = min(m1, (g + 1) * kBase);
    float s = 0.f;
    for (int blk = g * kBase; blk < end; ++blk) {
      s += tot[blk * DC + dl];
      tot[blk * DC + dl] = s;
    }
    grp[t] = s;
  }
  __syncthreads();
  // the inclusive sums of the group totals
  for (int dl = threadIdx.x; dl < DC; dl += blockDim.x) {
    float s = 0.f;
    for (int g = 0; g < ng; ++g) {
      s += grp[g * DC + dl];
      grp[g * DC + dl] = s;
    }
  }
  __syncthreads();
  // block b's carry: the inclusive sum through block b - 1, its group's
  // prefix plus the carry of the groups before it (0 for the first)
  for (int t = threadIdx.x; t < m1 * DC; t += blockDim.x) {
    const int blk = t / DC, dl = t % DC, dg = d0 + dl;
    if (dg >= nd) continue;
    float c = 0.f;
    if (blk > 0) {
      const int g = (blk - 1) / kBase;
      c = tot[(blk - 1) * DC + dl] + (g ? grp[(g - 1) * DC + dl] : 0.f);
    }
    car[((size_t)y * m1 + blk) * nd + dg] = c;
  }
}

// (2a) The images' box, one axis at a time, transposed on the way out.
// src0, src1: channels 0 and 1, (L, n) row-major (L lines of n); car:
// their carries (cv_carries<false, 2> with h = L, w = n). A CTA takes 32
// lines x kSeg elements of one channel (blockIdx.z): it stages them with
// the halo blocks, turns them into cumulative sums in place (one thread a
// (line, block) chain), takes the windows into a tile, and writes the
// tile transposed: dst (2, n, L). kFinal: the second (column) pass; dst is
// lm / rm, fma(-box, rcp, img) with img (n, L).
constexpr int kLines = 32, kSeg = 64, kLineThreads = 256;

template <bool kFinal>
__global__ void __launch_bounds__(kLineThreads)
    cv_lines(const float* __restrict__ src0, const float* __restrict__ src1,
             const float* __restrict__ car, float* __restrict__ dst,
             const float* __restrict__ img0, const float* __restrict__ img1,
             int L, int n, int r, float rcp) {
  extern __shared__ __align__(16) float sm[];
  const int c = blockIdx.z;
  const float* src = c ? src1 : src0;
  const int l0 = blockIdx.x * kLines, e0 = blockIdx.y * kSeg;
  const int m1 = (n + kBase - 1) / kBase;
  const int lb = (r + kBase) / kBase;
  const int nb = kSeg / kBase + lb + (r + kBase - 1) / kBase;
  const int blo = max(e0 / kBase - lb, 0), base = blo * kBase;
  const int hi = min(e0 + kSeg - 1 + r, n - 1);
  const int stride = nb * kBase + 1;               // a line's span, padded
  float* cs = sm;                                  // (kLines, stride)
  float* tile = sm + kLines * stride;              // (kSeg, kLines + 1)
  const int tid = threadIdx.x;
  for (int i = tid; i < kLines * nb * kBase; i += kLineThreads) {
    const int line = i / (nb * kBase), j = i % (nb * kBase);
    const int l = l0 + line, p = base + j;
    cs[line * stride + j] = l < L && p <= hi ? src[(size_t)l * n + p] : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < kLines * nb; i += kLineThreads) {
    const int line = i % kLines, k = i / kLines, l = l0 + line;
    const int p0 = (blo + k) * kBase;
    if (l >= L || p0 > hi) continue;
    const float cy = car[((size_t)l * m1 + blo + k) * 2 + c];
    float* row = cs + line * stride - base;
    const int end = min(p0 + kBase, hi + 1);
    float acc = 0.f;
    for (int p = p0; p < end; ++p) {
      acc += row[p];
      row[p] = acc + cy;
    }
  }
  __syncthreads();
  for (int i = tid; i < kSeg * kLines; i += kLineThreads) {
    const int line = i % kLines, el = i / kLines, e = e0 + el;
    if (e >= n) break;
    const float* row = cs + line * stride - base;
    const float cu = row[min(e + r, n - 1)];
    tile[el * (kLines + 1) + line] =
        e - r - 1 >= 0 ? cu - row[e - r - 1] : cu - 0.f;
  }
  __syncthreads();
  for (int i = tid; i < kSeg * kLines; i += kLineThreads) {
    const int line = i % kLines, el = i / kLines, e = e0 + el;
    const int l = l0 + line;
    if (e >= n) break;
    if (l >= L) continue;
    const float v = tile[el * (kLines + 1) + line];
    const size_t o = ((size_t)c * n + e) * L + l;
    if (kFinal) {
      const float* img = c ? img1 : img0;
      dst[o] = __fmaf_rn(-v, rcp, img[(size_t)e * L + l]);
    } else {
      dst[o] = v;
    }
  }
}

// Shared-memory layout of the volume's fused pass (floats), from the
// radius. A thread owns two neighbouring disparities of one column.
template <int XS, int DC>
struct FusedLayout {
  static constexpr int kPairs = DC / 2;
  // one block of 16 positions x DC in the row sums, padded so that the
  // float2 accesses of a half-warp (two blocks) take distinct banks
  static constexpr int kBlockStride = kBase * DC + 16;
  int lb, nb, span, bspan, rows_a, rows_b, cst, cbuf, ring, ring_len, total;
  // smem_ring: the columns' rings in shared memory (else in registers)
  __host__ __device__ FusedLayout(int r, bool smem_ring) {
    lb = (r + kBase) / kBase;                  // blocks left of the strip
    nb = XS / kBase + lb + (r + kBase - 1) / kBase;
    span = nb * kBase;
    bspan = span + DC;                         // b shifted by up to DC - 1
    ring_len = 2;                              // a power of 2 >= 2r + 2
    while (ring_len < 2 * r + 2) ring_len *= 2;
    rows_a = 0;
    rows_b = rows_a + kRows * span;
    cst = rows_b + kRows * bspan;
    cbuf = cst + kRows * nb * DC;
    cbuf += cbuf & 1;                          // float2 alignment
    ring = cbuf + kRows * nb * kBlockStride;
    total = ring + (smem_ring ? ring_len * XS * kPairs * 2 : 0);
  }
};

template <typename T>
struct CostPair;
template <>
struct CostPair<float> {
  static __device__ __forceinline__ void store(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};
template <>
struct CostPair<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float a,
                                               float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

// (2b) The volume's fused pass. Grid (ceil(w / XS), ceil(nd / DC)),
// XS * DC / 2 threads; a = lm, b = rm, out (h, w, nd) in T. R >= 0: the
// radius, known here, whose ring of 2R + 2 sums is one step's rows and
// lives in registers (a row's slot is its place in the step); R < 0: the
// radius r_in, the ring in shared memory.
template <typename T, int XS, int DC, int R>
__global__ void __launch_bounds__(XS * DC / 2, 3)
    cv_fused(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ car, T* __restrict__ out, int h,
             int w, int nd, int r_in, float rcp) {
  static_assert(R < 0 || 2 * R + 2 == kRows, "a register ring is a step");
  constexpr bool kRegRing = R >= 0;
  const int r = kRegRing ? R : r_in;
  using Layout = FusedLayout<XS, DC>;
  constexpr int kPairs = Layout::kPairs;
  constexpr int kThreads = XS * kPairs;
  constexpr int kLanes = kThreads / kRows;       // threads a staged row
  constexpr int kBS = Layout::kBlockStride;
  static_assert(kThreads % kRows == 0 && kLanes % kPairs == 0, "tiles");
  extern __shared__ __align__(16) float sm[];
  const Layout L(r, !kRegRing);
  const int m1 = (w + kBase - 1) / kBase;
  const int x0 = blockIdx.x * XS, d0 = blockIdx.y * DC;
  const int blo = max(x0 / kBase - L.lb, 0);
  const int base = blo * kBase;                  // column of span slot 0
  const int hi = min(x0 + XS - 1 + r, w - 1);    // last column needed
  const int bo = base - d0 - (DC - 1);           // column of b's slot 0
  const int tid = threadIdx.x;
  const int srow = tid / kLanes, lane = tid % kLanes;
  float* sa = sm + L.rows_a + srow * L.span;
  float* sb = sm + L.rows_b + srow * L.bspan;
  float* cst = sm + L.cst + srow * L.nb * DC;
  float2* cbuf = reinterpret_cast<float2*>(sm + L.cbuf);
  float2* ring = reinterpret_cast<float2*>(sm + L.ring);

  // this thread's row of the next kRows rows: a and b over the span (b
  // shifted, 0 off the line, so that b[p - d] needs no test), and the
  // span's carries
  auto stage = [&](int y0) {
    const int y = y0 + srow;
    const bool in = y < h;
    const float* ar = a + (size_t)y * w;
    const float* br = b + (size_t)y * w;
    for (int j = lane; j < L.span; j += kLanes) {
      const int p = base + j;
      if (in && p < w) cp_async4(sa + j, ar + p);
      else sa[j] = 0.f;
    }
    for (int j = lane; j < L.bspan; j += kLanes) {
      const int p = bo + j;
      if (in && p >= 0 && p < w) cp_async4(sb + j, br + p);
      else sb[j] = 0.f;
    }
    for (int j = lane; j < L.nb * DC; j += kLanes) {
      const int blk = blo + j / DC, dg = d0 + j % DC;
      if (in && blk < m1 && dg < nd)
        cp_async4(cst + j, car + ((size_t)y * m1 + blk) * nd + dg);
      else
        cst[j] = 0.f;
    }
  };

  // this thread's column x and disparities dg, dg + 1
  const int xl = tid / kPairs, pr = tid % kPairs;
  const int x = x0 + xl, dg = d0 + 2 * pr;
  const bool active = x < w && dg < nd;
  const bool pair_store = dg + 1 < nd && (nd & 1) == 0;
  const int up = min(x + r, w - 1) - base;      // span slot of the upper end
  const int lo = x - r - 1 - base;              // of the lower end (< 0: 0)
  const int up_i = (up >> 4) * (kBS / 2) + (up & 15) * kPairs + pr;
  const int lo_i = (lo >> 4) * (kBS / 2) + (lo & 15) * kPairs + pr;
  const int mask = L.ring_len - 1;
  const bool inv0 = x < dg, inv1 = x < dg + 1;
  float2 s = make_float2(0.f, 0.f), gsum = s, gcar = s, carry = s, last = s;
  float2* my_ring = ring + tid;
  float2 rring[kRegRing ? kRows : 1];
  // C[y] into the ring, and C[k] out of it; `slot`, the place in the step
  // of the row that holds it, indexes the register ring statically
  auto ring_put = [&](int y, int slot, float2 v) {
    if constexpr (kRegRing) rring[slot] = v;
    else my_ring[(y & mask) * kThreads] = v;
  };
  auto ring_get = [&](int k, int slot) -> float2 {
    if constexpr (kRegRing) return rring[slot];
    else return my_ring[(k & mask) * kThreads];
  };

  T* const obase = out + (size_t)x * nd + dg;
  const size_t ostep = (size_t)w * nd;
  auto emit = [&](int yo, float2 v) {
    T* o = obase + (size_t)yo * ostep;
    const float c0 = inv0 ? kBig : v.x * rcp;
    const float c1 = inv1 ? kBig : v.y * rcp;
    if (pair_store) {
      CostPair<T>::store(o, c0, c1);
    } else {
      o[0] = to_cost<T>(c0);
      if (dg + 1 < nd) o[1] = to_cost<T>(c1);
    }
  };
  // one row of the column (row `row` of the step): its window from the
  // row sums, the cumulative sum in scan16's order, the ring, and
  // out[y - r] once y >= r
  auto advance = [&](int y, int row, const float2* crow, bool emits,
                     bool has_low) {
    const float2 cu = crow[up_i];
    float2 v;
    if (lo >= 0) {
      const float2 cl = crow[lo_i];
      v = make_float2(cu.x - cl.x, cu.y - cl.y);
    } else {
      v = make_float2(cu.x - 0.f, cu.y - 0.f);
    }
    s.x += v.x;
    s.y += v.y;
    last = make_float2(s.x + carry.x, s.y + carry.y);
    ring_put(y, row, last);
    if (emits) {
      if (has_low) {
        const float2 cl =
            ring_get(y - 2 * r - 1, (row + kRows - 2 * R - 1) % kRows);
        emit(y - r, make_float2(last.x - cl.x, last.y - cl.y));
      } else {
        emit(y - r, make_float2(last.x - 0.f, last.y - 0.f));
      }
    }
  };
  // row y ends a block of 16 rows: its total joins the group's sum, the
  // next block's carry is the group's sum plus the groups' carry
  auto end_block = [&](int y) {
    gsum.x += s.x;
    gsum.y += s.y;
    carry = make_float2(gsum.x + gcar.x, gsum.y + gcar.y);
    s = make_float2(0.f, 0.f);
    if (((y >> 4) & (kBase - 1)) == kBase - 1) {   // a group ends
      gcar = make_float2(gsum.x + gcar.x, gsum.y + gcar.y);
      gsum = make_float2(0.f, 0.f);
    }
  };

  const int steps = (h + kRows - 1) / kRows;
  stage(0);
  for (int it = 0; it < steps; ++it) {
    const int y0 = it * kRows;
    cp_async_wait_all();
    __syncthreads();
    // the rows' cumulative sums over the span: per (row, block, pair) a
    // chain of at most 16 adds from 0, the block's carry added last; the
    // pair shares a's loads and all but one of b's
    if (y0 + srow < h) {
      const float* ra = sa - base;
      for (int j = lane; j < L.nb * kPairs; j += kLanes) {
        const int k = j / kPairs, q = j % kPairs;
        const int p0 = (blo + k) * kBase, e = d0 + 2 * q;
        if (p0 > hi || e >= nd) continue;
        const float* rbe = sb - bo - e;            // rbe[p] = b[p - e]
        const float c0 = cst[k * DC + 2 * q], c1 = cst[k * DC + 2 * q + 1];
        float2* dst = cbuf + (srow * L.nb + k) * (kBS / 2) + q;
        const int n = min(kBase, hi + 1 - p0);
        float av[kBase];                           // a block of a: 4 loads
#pragma unroll
        for (int i = 0; i < kBase; i += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(ra + p0 + i);
          av[i] = q4.x, av[i + 1] = q4.y, av[i + 2] = q4.z, av[i + 3] = q4.w;
        }
        float acc0 = 0.f, acc1 = 0.f, prev = rbe[p0 - 1];
#pragma unroll
        for (int i = 0; i < kBase; ++i) {
          if (i < n) {
            const float cur = rbe[p0 + i];
            acc0 += fabsf(av[i] - cur);
            acc1 += fabsf(av[i] - prev);
            prev = cur;
            dst[i * kPairs] = make_float2(acc0 + c0, acc1 + c1);
          }
        }
      }
    }
    __syncthreads();
    if (it + 1 < steps) stage(y0 + kRows);
    if (!active) continue;
    const float2* crow = cbuf;
    const int crow_step = L.nb * (kBS / 2);
    if (y0 >= 2 * r + 1 && y0 + kRows <= h) {
      // every row of the step emits, and only its last can end a block
#pragma unroll
      for (int row = 0; row < kRows; ++row, crow += crow_step)
        advance(y0 + row, row, crow, true, true);
      if ((y0 & (kBase - 1)) == kBase - kRows) end_block(y0 + kRows - 1);
    } else {
#pragma unroll
      for (int row = 0; row < kRows; ++row, crow += crow_step) {
        const int y = y0 + row;
        if (y < h) {
          advance(y, row, crow, y >= r, y - 2 * r - 1 >= 0);
          if ((y & (kBase - 1)) == kBase - 1) end_block(y);
        }
      }
    }
  }
  if (!active) return;
  // the last r rows read C[h - 1] as their upper end (the edge pad)
  for (int yo = max(h - r, 0); yo < h; ++yo) {
    const int k = yo - r - 1;
    if (k >= 0) {
      float2 cl = rring[0];
      if constexpr (kRegRing) {
        // the step slot of C[k] (steps start at multiples of kRows)
#pragma unroll
        for (int slot = 1; slot < kRows; ++slot)
          if ((k & (kRows - 1)) == slot) cl = rring[slot];
      } else {
        cl = my_ring[(k & mask) * kThreads];
      }
      emit(yo, make_float2(last.x - cl.x, last.y - cl.y));
    } else {
      emit(yo, make_float2(last.x - 0.f, last.y - 0.f));
    }
  }
}

template <bool kVolume, int DC>
cudaError_t launch_carries(const float* a, const float* b, float* car, int h,
                           int w, int nd, cudaStream_t s) {
  const int m1 = (w + kBase - 1) / kBase;
  const int off = kVolume ? ((nd + DC - 1) / DC) * DC - 1 : 0;   // the most
  const size_t smem = sizeof(float) *
      (2 * w + off + (size_t)m1 * DC +
       (size_t)((m1 + kBase - 1) / kBase) * DC);
  auto kern = cv_carries<kVolume, DC>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(h, (nd + DC - 1) / DC);
  kern<<<grid, kCarryThreads, smem, s>>>(a, b, car, h, w, nd);
  return cudaGetLastError();
}

template <bool kFinal>
cudaError_t launch_lines(const float* src0, const float* src1,
                         const float* car, float* dst, const float* img0,
                         const float* img1, int L, int n, int r, float rcp,
                         cudaStream_t s) {
  const int nb = kSeg / kBase + (r + kBase) / kBase + (r + kBase - 1) / kBase;
  const size_t smem = sizeof(float) *
      ((size_t)kLines * (nb * kBase + 1) + (size_t)kSeg * (kLines + 1));
  auto kern = cv_lines<kFinal>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((L + kLines - 1) / kLines, (n + kSeg - 1) / kSeg, 2);
  kern<<<grid, kLineThreads, smem, s>>>(src0, src1, car, dst, img0, img1, L,
                                        n, r, rcp);
  return cudaGetLastError();
}

template <typename T, int XS, int DC, int R>
cudaError_t launch_fused(const float* a, const float* b, const float* car,
                         T* out, int h, int w, int nd, int r, float rcp,
                         cudaStream_t s) {
  const size_t smem = sizeof(float) * FusedLayout<XS, DC>(r, R < 0).total;
  auto kern = cv_fused<T, XS, DC, R>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + XS - 1) / XS, (nd + DC - 1) / DC);
  kern<<<grid, XS * DC / 2, smem, s>>>(a, b, car, out, h, w, nd, r, rcp);
  return cudaGetLastError();
}

}  // namespace

// left, right f32 (h, w); lmrm f32 (2, h, w), rowbox f32 (2, w, h),
// icar f32 (max(h * ceil(w / 16), w * ceil(h / 16)), 2) and vcar f32 (h,
// ceil(w / 16), nd) scratch; out (h, w, nd) f32 (out_bf16 = 0) or bf16.
// Six launches: the images' row carries, row windows (into rowbox,
// transposed), column carries and column windows (into lmrm), then the
// volume's carries and fused pass.
extern "C" int cost_volume_launch(const void* left, const void* right,
                                  void* lmrm, void* rowbox, void* icar,
                                  void* vcar, void* out, int h, int w, int nd,
                                  int r, float rcp, int out_bf16,
                                  void* stream) {
  if (h <= 0 || w <= 0 || nd <= 0) return 0;
  if (h > kBase * kMaxBlocks || w > kBase * kMaxBlocks || r < 0 ||
      r > kMaxRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(left);
  const float* rt = static_cast<const float*>(right);
  float* lr = static_cast<float*>(lmrm);
  float* hb = static_cast<float*>(rowbox);
  float* ic = static_cast<float*>(icar);
  float* vc = static_cast<float*>(vcar);
  const float* hb1 = hb + (size_t)w * h;
  cudaError_t e = launch_carries<false, kImgCarryDc>(l, rt, ic, h, w, 2, s);
  if (e == cudaSuccess)
    e = launch_lines<false>(l, rt, ic, hb, nullptr, nullptr, h, w, r, rcp, s);
  if (e == cudaSuccess)
    e = launch_carries<false, kImgCarryDc>(hb, hb1, ic, w, h, 2, s);
  if (e == cudaSuccess)
    e = launch_lines<true>(hb, hb1, ic, lr, l, rt, w, h, r, rcp, s);
  const float* lm = lr;
  const float* rm = lr + (size_t)h * w;
  if (e == cudaSuccess)
    e = launch_carries<true, kVolCarryDc>(lm, rm, vc, h, w, nd, s);
  // the main path's radius keeps its ring in registers
  constexpr int kRegR = kRows / 2 - 1;
  using Bf = __nv_bfloat16;
  Bf* ob = static_cast<Bf*>(out);
  float* of = static_cast<float*>(out);
  if (e == cudaSuccess) {
    if (out_bf16 && r == kRegR)
      e = launch_fused<Bf, kVolXs, kVolDc, kRegR>(lm, rm, vc, ob, h, w, nd,
                                                   r, rcp, s);
    else if (out_bf16)
      e = launch_fused<Bf, kVolXs, kVolDc, -1>(lm, rm, vc, ob, h, w, nd, r,
                                               rcp, s);
    else if (r == kRegR)
      e = launch_fused<float, kVolXs, kVolDc, kRegR>(lm, rm, vc, of, h, w,
                                                      nd, r, rcp, s);
    else
      e = launch_fused<float, kVolXs, kVolDc, -1>(lm, rm, vc, of, h, w, nd,
                                                  r, rcp, s);
  }
  return static_cast<int>(e);
}
