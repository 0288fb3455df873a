// Kernel GN: the normal equations of the stereo VO's Gauss-Newton step,
// S = [A | b] with A = (J w)^T J and b = (J w)^T r, for every system of a
// batch, in the order jitted XLA:CPU sums them on the host that made the
// JAX golden (denseslam_tpu_torch/utils/numerics.py `gn_normal`, its plain
// version, states the order and how it was read).
//
// It replaces no Pallas kernel. The JAX package writes the two sums as
// einsums (denseslam_tpu/ops/ransac.py `_gn_refine`), which XLA:CPU runs
// as FMA chains in lanes and panels of its own; the port summed them
// exactly in float64 and rounded once, which parted from the JAX golden's
// poses by up to 6.7e-5 m over 64 frames. This kernel sums in XLA:CPU's
// order, so the card, the CPU and jitted JAX agree bit for bit:
//   * x_q = J_q w_(q/4), one rounded multiply a term (row q of the 4N);
//   * A_ij: panels of 4096 terms, four lanes a panel (term q of a panel in
//     lane q % 4), each lane a chain of FMAs from 0; a panel's lanes added
//     (l0 + l1) + (l2 + l3), the panels in order;
//   * b_i, GEMV order (`fused` 0: a batch, or 4N >= 4096): eight lanes over
//     the first 8 floor(4N / 8) terms (lane q % 8), halved l + 4, l + 2,
//     l + 1, plus a chain from 0 over the rest;
//   * b_i, fused order (`fused` 1: one system with 4N < 4096): one chain of
//     FMAs from 0 over the 4N terms.
// With --fmad=false every FMA is an explicit __fmaf_rn and every other
// multiply and add is rounded on its own.
//
// Layout: one CUDA block a system; each thread runs whole chains (a
// chain's terms are dependent), the chains' sums land in shared memory,
// then 42 threads combine them. Shapes on the main path: the hypotheses,
// 256 systems of N = 3 (4N = 12), and the refit, one system of N = 2048
// (4N = 8192: 2 panels, 342 chains of 1024 FMAs).
//
// Bound on the H100: bytes. The refit reads J (4N x 6 floats), r and w
// once (237 KB) and does 42 x 4N FMAs (0.7 MFLOP): 0.07 us of HBM
// bandwidth against 0.01 us of float32 rate. A chain is a dependent
// sequence, so the refit's 1024-step chains take at least 1024 FMA
// latencies whatever the bandwidth; the design keeps each chain in one
// register and unrolls its loads ahead of it, and is not tuned further.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPanel = 4096;
constexpr int kALanes = 4;
constexpr int kBLanes = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float term(const float* Jb, const float* wb,
                                      int q, int i) {
  return __fmul_rn(Jb[q * 6 + i], wb[q >> 2]);
}

__global__ void __launch_bounds__(kThreads)
gn_normal_kernel(const float* __restrict__ J, const float* __restrict__ r,
                 const float* __restrict__ w, float* __restrict__ S, int n,
                 int fused) {
  extern __shared__ float chain[];
  const int k = 4 * n;
  const int plen = min(k, kPanel);
  const int panels = (k + plen - 1) / plen;
  const int nA = panels * kALanes * 36;
  const int nB = fused ? 6 : kBLanes * 6 + 6;
  const int k8 = k - k % kBLanes;
  const size_t sys = blockIdx.x;
  const float* Jb = J + sys * (size_t)n * 24;
  const float* rb = r + sys * (size_t)n * 4;
  const float* wb = w + sys * (size_t)n;

  for (int c = threadIdx.x; c < nA + nB; c += blockDim.x) {
    float acc = 0.f;
    if (c < nA) {
      const int p = c / (kALanes * 36), lane = (c / 36) % kALanes;
      const int i = (c % 36) / 6, j = c % 6;
      const int q1 = min((p + 1) * plen, k);
#pragma unroll 8
      for (int q = p * plen + lane; q < q1; q += kALanes)
        acc = __fmaf_rn(term(Jb, wb, q, i), Jb[q * 6 + j], acc);
    } else if (fused) {
      const int i = c - nA;
#pragma unroll 8
      for (int q = 0; q < k; ++q)
        acc = __fmaf_rn(term(Jb, wb, q, i), rb[q], acc);
    } else if (c - nA < kBLanes * 6) {
      const int lane = (c - nA) / 6, i = (c - nA) % 6;
#pragma unroll 8
      for (int q = lane; q < k8; q += kBLanes)
        acc = __fmaf_rn(term(Jb, wb, q, i), rb[q], acc);
    } else {
      const int i = c - nA - kBLanes * 6;
      for (int q = k8; q < k; ++q)
        acc = __fmaf_rn(term(Jb, wb, q, i), rb[q], acc);
    }
    chain[c] = acc;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < 42; o += blockDim.x) {
    const int i = o / 7, j = o % 7;
    float v;
    if (j < 6) {
      const int e = i * 6 + j;
      v = 0.f;
      for (int p = 0; p < panels; ++p) {
        const float* l = chain + p * kALanes * 36 + e;
        const float s = __fadd_rn(__fadd_rn(l[0], l[36]),
                                  __fadd_rn(l[72], l[108]));
        v = p == 0 ? s : __fadd_rn(v, s);
      }
    } else if (fused) {
      v = chain[nA + i];
    } else {
      float l[kBLanes];
      for (int a = 0; a < kBLanes; ++a) l[a] = chain[nA + a * 6 + i];
      for (int a = 0; a < 4; ++a) l[a] = __fadd_rn(l[a], l[a + 4]);
      for (int a = 0; a < 2; ++a) l[a] = __fadd_rn(l[a], l[a + 2]);
      v = __fadd_rn(__fadd_rn(l[0], l[1]), chain[nA + kBLanes * 6 + i]);
    }
    S[sys * 42 + o] = v;
  }
}

}  // namespace

extern "C" int gn_normal_launch(const float* J, const float* r,
                                const float* w, float* S, int batch, int n,
                                int fused, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int k = 4 * n;
  const int plen = k < kPanel ? k : kPanel;
  const int panels = (k + plen - 1) / plen;
  const int chains = panels * kALanes * 36 + (fused ? 6 : kBLanes * 6 + 6);
  const size_t shmem = (size_t)chains * sizeof(float);
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gn_normal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  gn_normal_kernel<<<batch, kThreads, shmem, stream>>>(J, r, w, S, n, fused);
  return (int)cudaGetLastError();
}
