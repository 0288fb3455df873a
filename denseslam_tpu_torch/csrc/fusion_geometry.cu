// Kernel PJ: the fusion's voxel projection. For each visible 8^3 block
// (one CUDA block, 512 threads, one voxel a thread) and the camera
// (R, t) = T_cw, it writes the voxel's pixel coordinates u, v and its
// camera depth z, in the order jitted XLA:CPU computes them in the JAX
// package's fused `process_sequence` scan (denseslam_tpu/ops/tsdf.py
// `_fusion_geometry`, :283-301; the order is stated by its plain version,
// denseslam_tpu_torch/ops/tsdf.py `fusion_geometry_plain`, and was read
// from `tests/_torch_golden.py --dump`):
//   * the block key unpacked to (bx, by, bz), the voxel's centre
//     h = float(8 b + o) + 0.5 (exact);
//   * a_ij = R_ij * vsz, rounded (XLA folds the voxel size into R);
//   * p_i = fma(hz, a_i2, fma(hx, a_i0, hy * a_i1)) + t_i;
//   * zc = pz where |pz| > 1e-9, else 1e-9; u = fma(px / zc, fx, cx) and
//     v = fma(py / zc, fy, cy).
// With --fmad=false every FMA is an explicit __fmaf_rn and every other
// multiply, add and divide is rounded on its own.
//
// It replaces no Pallas kernel: the port rounded every op of the
// projection where jitted XLA contracts it, and a voxel whose projection
// lies within those last bits of a pixel edge then sampled another pixel
// (the JAX golden's replay was within tolerance on 99.491% of blocks).
// One fused launch takes the place of about a hundred elementwise ones.
//
// Bound on the H100: bytes. Per voxel it writes u, v, z (12 B); each
// block reads one key and the camera. At KITTI scale (8192 visible
// blocks) that is 50 MB, about 15 us at 3.35 TB/s; the stores are
// coalesced (consecutive threads, consecutive voxels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVox = 512;
constexpr int kPackBits = 10;
constexpr int kPackMask = (1 << kPackBits) - 1;
constexpr int kPackHalf = 1 << (kPackBits - 1);

__global__ void __launch_bounds__(kVox)
fusion_geometry_kernel(const int32_t* __restrict__ keys,
                       const float* __restrict__ R,
                       const float* __restrict__ t, float* __restrict__ u,
                       float* __restrict__ v, float* __restrict__ z,
                       float vsz, float fx, float fy, float cx, float cy) {
  const int row = blockIdx.x;
  const int vox = threadIdx.x;
  const int key = keys[row];
  const int b[3] = {(key & kPackMask) - kPackHalf,
                    ((key >> kPackBits) & kPackMask) - kPackHalf,
                    ((key >> (2 * kPackBits)) & kPackMask) - kPackHalf};
  const int o[3] = {vox & 7, (vox >> 3) & 7, vox >> 6};
  float h[3];
  for (int a = 0; a < 3; ++a)
    h[a] = __fadd_rn(__int2float_rn(b[a] * 8 + o[a]), 0.5f);
  float p[3];
  for (int i = 0; i < 3; ++i) {
    const float a0 = __fmul_rn(R[i * 3 + 0], vsz);
    const float a1 = __fmul_rn(R[i * 3 + 1], vsz);
    const float a2 = __fmul_rn(R[i * 3 + 2], vsz);
    p[i] = __fadd_rn(__fmaf_rn(h[2], a2, __fmaf_rn(h[0], a0,
                                                   __fmul_rn(h[1], a1))),
                     t[i]);
  }
  const float zc = fabsf(p[2]) > 1e-9f ? p[2] : 1e-9f;
  const size_t at = (size_t)row * kVox + vox;
  u[at] = __fmaf_rn(__fdiv_rn(p[0], zc), fx, cx);
  v[at] = __fmaf_rn(__fdiv_rn(p[1], zc), fy, cy);
  z[at] = p[2];
}

}  // namespace

extern "C" int fusion_geometry_launch(const int32_t* keys, const float* R,
                                      const float* t, float* u, float* v,
                                      float* z, int n, float vsz, float fx,
                                      float fy, float cx, float cy,
                                      cudaStream_t stream) {
  if (n <= 0) return 0;
  fusion_geometry_kernel<<<n, kVox, 0, stream>>>(keys, R, t, u, v, z, vsz,
                                                 fx, fy, cx, cy);
  return (int)cudaGetLastError();
}
