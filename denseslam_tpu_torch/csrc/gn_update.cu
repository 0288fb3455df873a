// Kernel GU: the rest of the stereo VO's Gauss-Newton step after kernel GN.
// From S = [A | b] and the pose T of every system of a batch it damps A,
// solves A' x = b, clips xi = -x and applies exp(xi) to T:
//   T_new = exp(clip(-solve(A + (1e-6 tr A + 1e-9) I, b))) T,
// each op as its plain version rounds it (denseslam_tpu_torch/ops/ransac.py
// `gn_update_plain`, over ops/smallsolve.py `solve_spd6` and utils/lie.py
// `se3_exp_apply`), which is jitted XLA:CPU's order on the host that made
// the JAX golden (tests/test_torch_gn_normal.py, tests/test_torch_vo_order.py):
//   * tr A summed left to right from 0; the damping one FMA (`__fmaf_rn`,
//     the plain version's `numerics.fma`);
//   * the Cholesky solve with each `s - l l'` one FMA, the roots correctly
//     rounded, the column scaled by the root's reciprocal, and the last
//     unknown s5 / max(m, 1e-20);
//   * sin and cos those of glibc's sinf / cosf (utils/numerics.py
//     `sincosf`: the reduction and polynomial in double, each double
//     multiply and add rounded on its own, rounded once to float32);
//   * every small product a chain of FMAs from 0 (`numerics.fma_dot_exact`),
//     `eye + a W + b W2` two FMAs (`numerics.fma`), and the product with T
//     so, or, for one pose shared by the batch (`shared`, the hypotheses'
//     first step), the four products rounded and added (p0 + p1) + (p2 + p3).
// With --fmad=false every other multiply and add is rounded on its own, as
// the plain version's separate launches round them.
//
// It replaces no Pallas kernel. On the card the plain version is about 420
// small launches a step (20 steps a frame); this is one, one thread a
// system. Bound on the H100: operations per thread are a few hundred
// dependent scalar ops; the batch (256 systems at most) fills under 2 of
// the 132 SMs, so the time is the dependent chain's latency.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// glibc's sinf tables, two of them (utils/numerics.py `_SINCOSF`):
// sign[4], hpi_inv, hpi, c0, c1, s1, c2, s2, c3, s3, c4
__constant__ double kSinCos[2][14] = {
    {1.0, -1.0, -1.0, 1.0, 0x1.45f306dc9c883p+23, 0x1.921fb54442d18p+0, 1.0,
     -0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3, 0x1.55553e1068f19p-5,
     0x1.1107605230bc4p-7, -0x1.6c087e89a359dp-10, -0x1.994eb3774cf24p-13,
     0x1.99343027bf8c3p-16},
    {1.0, -1.0, -1.0, 1.0, 0x1.45f306dc9c883p+23, 0x1.921fb54442d18p+0,
     -1.0, 0x1.ffffffd0c621cp-2, -0x1.555545995a603p-3,
     -0x1.55553e1068f19p-5, 0x1.1107605230bc4p-7, 0x1.6c087e89a359dp-10,
     -0x1.994eb3774cf24p-13, -0x1.99343027bf8c3p-16},
};

__device__ __forceinline__ double dmul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double dadd(double a, double b) {
  return __dadd_rn(a, b);
}

// glibc's sinf_poly (numerics._sincosf_poly), table t
__device__ double sincos_poly(double x, double x2, int t, bool odd) {
  const double* p = kSinCos[t];
  const double c0 = p[6], c1 = p[7], s1 = p[8], c2 = p[9], s2 = p[10],
               c3 = p[11], s3 = p[12], c4 = p[13];
  if (!odd) {
    const double x3 = dmul(x2, x);
    const double s = dadd(dmul(x3, s1), x);
    return dadd(dmul(dadd(dmul(x2, s3), s2), dmul(x3, x2)), s);
  }
  const double x4 = dmul(x2, x2);
  return dadd(dmul(dadd(dmul(x2, c4), c3), dmul(x2, x4)),
              dadd(dmul(x4, c2), dadd(dmul(x2, c1), c0)));
}

// numerics.sincosf: glibc's sinf and cosf of y
__device__ void sincosf_glibc(float y, float* sn, float* cs) {
  const double x = (double)y;
  const int top = (int)((__float_as_uint(y) >> 20) & 0x7FF);
  if (top <= 0x3F3) {                   // |y| < pi / 4: about 0, table 0
    if (top <= 0x397) {
      *sn = y;
      *cs = 1.f;
      return;
    }
    const double x2 = dmul(x, x);
    *sn = __double2float_rn(sincos_poly(x, x2, 0, false));
    *cs = __double2float_rn(sincos_poly(x, x2, 0, true));
    return;
  }
  const int n = (__double2int_rz(dmul(x, kSinCos[0][4])) + 0x800000) >> 24;
  const double r = dadd(x, -dmul((double)n, kSinCos[0][5]));
  const int t = (n & 2) ? 1 : 0;
  const double sign = kSinCos[0][n & 3];
  const double r2 = dmul(r, r);
  for (int c = 0; c < 2; ++c) {
    const bool odd = ((n & 1) != 0) != (c == 1);
    const double v = sincos_poly(odd ? r : dmul(r, sign), r2, t, odd);
    if (c == 0) *sn = __double2float_rn(v);
    else *cs = __double2float_rn(v);
  }
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  if (v != v) return v;                 // torch.clamp keeps a NaN
  return fminf(fmaxf(v, lo), hi);
}

__global__ void gn_update_kernel(const float* __restrict__ S,
                                 const float* __restrict__ T,
                                 float* __restrict__ out, int batch,
                                 int shared) {
  const int sys = blockIdx.x * blockDim.x + threadIdx.x;
  if (sys >= batch) return;
  const float* s = S + (size_t)sys * 42;
  const float* tp = T + (shared ? 0 : (size_t)sys * 16);

  // damping: tr A left to right from 0, then one FMA
  float tr = 0.f;
  for (int i = 0; i < 6; ++i) tr = __fadd_rn(tr, s[i * 7 + i]);
  const float damp = __fmaf_rn(tr, 1e-6f, 1e-9f);
  float a[6][6];
  for (int i = 0; i < 6; ++i)
    for (int j = 0; j < 6; ++j)
      a[i][j] = __fadd_rn(s[i * 7 + j], __fmul_rn(damp, i == j ? 1.f : 0.f));

  // Cholesky, column by column (smallsolve.solve_spd6)
  float L[6][6], diag[6], m = 0.f;
  for (int j = 0; j < 6; ++j) {
    float v[6];
    for (int i = j; i < 6; ++i) {
      v[i] = a[i][j];
      for (int k = 0; k < j; ++k) v[i] = __fmaf_rn(-L[i][k], L[j][k], v[i]);
    }
    m = v[j] != v[j] ? v[j] : fmaxf(v[j], 1e-20f);
    const float d = __fsqrt_rn(m);
    diag[j] = d;
    const float inv = __fdiv_rn(1.f, d);
    for (int i = j + 1; i < 6; ++i) L[i][j] = __fmul_rn(v[i], inv);
  }
  // forward L y = b for y0..y4; the last row stays a sum
  float y[6], rest[6];
  for (int i = 0; i < 6; ++i) rest[i] = s[i * 7 + 6];
  for (int k = 0; k < 5; ++k) {
    y[k] = __fdiv_rn(rest[k], diag[k]);
    for (int i = k + 1; i < 6; ++i)
      rest[i] = __fmaf_rn(-L[i][k], y[k], rest[i]);
  }
  float x[6];
  x[5] = __fdiv_rn(rest[5], m);
  for (int i = 4; i >= 0; --i) {
    float acc = y[i];
    for (int k = i + 1; k < 6; ++k) acc = __fmaf_rn(-L[k][i], x[k], acc);
    x[i] = __fdiv_rn(acc, diag[i]);
  }
  float xi[6];
  for (int i = 0; i < 6; ++i) xi[i] = clampf(-x[i], -0.5f, 0.5f);

  // exp(xi) (lie.se3_exp_apply)
  const float* v = xi;
  const float* w = xi + 3;
  float theta2 = __fmaf_rn(w[0], w[0], 0.f);
  theta2 = __fmaf_rn(w[1], w[1], theta2);
  theta2 = __fmaf_rn(w[2], w[2], theta2);
  const float theta = __fsqrt_rn(theta2 != theta2 ? theta2
                                                    : fmaxf(theta2, 1e-16f));
  const float W[3][3] = {{0.f, -w[2], w[1]},
                         {w[2], 0.f, -w[0]},
                         {-w[1], w[0], 0.f}};
  float W2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float acc = __fmaf_rn(W[i][0], W[0][j], 0.f);
      acc = __fmaf_rn(W[i][1], W[1][j], acc);
      W2[i][j] = __fmaf_rn(W[i][2], W[2][j], acc);
    }
  const bool small = theta2 < 1e-4f;
  float sn, cs;
  sincosf_glibc(theta, &sn, &cs);
  const float ca = small ? __fsub_rn(1.f, __fdiv_rn(theta2, 6.f))
                         : __fdiv_rn(sn, theta);
  const float cb = small ? __fsub_rn(0.5f, __fdiv_rn(theta2, 24.f))
                         : __fdiv_rn(__fsub_rn(1.f, cs), theta2);
  const float cc = small ? __fsub_rn(1.f / 6.f, __fdiv_rn(theta2, 120.f))
                         : __fdiv_rn(__fsub_rn(theta, sn),
                                     __fmul_rn(theta2, theta));
  float E[4][4];
  float V[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = i == j ? 1.f : 0.f;
      E[i][j] = __fmaf_rn(cb, W2[i][j], __fmaf_rn(ca, W[i][j], e));
      V[i][j] = __fmaf_rn(cc, W2[i][j], __fmaf_rn(cb, W[i][j], e));
    }
  for (int i = 0; i < 3; ++i) {
    float acc = __fmaf_rn(V[i][0], v[0], 0.f);
    acc = __fmaf_rn(V[i][1], v[1], acc);
    E[i][3] = __fmaf_rn(V[i][2], v[2], acc);
  }
  E[3][0] = E[3][1] = E[3][2] = 0.f;
  E[3][3] = 1.f;

  // exp(xi) T
  float* o = out + (size_t)sys * 16;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) {
      float r;
      if (shared) {
        const float p0 = __fmul_rn(E[i][0], tp[0 * 4 + j]);
        const float p1 = __fmul_rn(E[i][1], tp[1 * 4 + j]);
        const float p2 = __fmul_rn(E[i][2], tp[2 * 4 + j]);
        const float p3 = __fmul_rn(E[i][3], tp[3 * 4 + j]);
        r = __fadd_rn(__fadd_rn(p0, p1), __fadd_rn(p2, p3));
      } else {
        r = __fmaf_rn(E[i][0], tp[0 * 4 + j], 0.f);
        for (int k = 1; k < 4; ++k) r = __fmaf_rn(E[i][k], tp[k * 4 + j], r);
      }
      o[i * 4 + j] = r;
    }
}

}  // namespace

extern "C" int gn_update_launch(const float* S, const float* T, float* out,
                                int batch, int shared, cudaStream_t stream) {
  if (batch <= 0) return 0;
  const int threads = 64;
  gn_update_kernel<<<(batch + threads - 1) / threads, threads, 0, stream>>>(
      S, T, out, batch, shared);
  return (int)cudaGetLastError();
}
