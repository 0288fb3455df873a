// Kernels 1 and B2: the fusion image samplers.
//
// Kernel 1 replaces the JAX package's Pallas tile sampler,
// denseslam_tpu/ops/sampling.py `_kernel` / `_sample_subbatch` (launched by
// `_tile_sample_call`); kernel B2 replaces its true-RGB variant
// `_kernel_rgb` / `_sample_subbatch_rgb` (launched by
// `_tile_sample_rgb_call`). Both fold in the per-block tiling pass
// `_tiling`. For each visible 8^3 map block (one CUDA block, 512 threads,
// one voxel per thread) they compute:
//   * ui, vi = round-half-even(u, v); in_bounds = inside the image and
//     z > 1e-3;
//   * the block's tile origin, snapped down to (8, 128) and clipped to the
//     padded image exactly as `_tiling` does, and the block's `overflow`
//     flag (footprint wider than 256 or taller than 64 px past the origin);
//   * flags: bit 0 = inside the tile, bit 1 = in bounds;
//   * kernel 1: the voxel's pixel of the packed image (d_mm << 8 | gray)
//     where in bounds, else 0;
//   * kernel B2: from img1 = d_mm | r << 16 and img2 = g | b << 8, the
//     samples out1 = d_mm << 8 | r and out2 = g << 8 | b where in bounds,
//     else 0.
// The cap rule of the JAX fallback (first `pallas_overflow_cap` overflow
// blocks keep their out-of-tile voxels; B2's rescued blocks take their
// colour from the ungated colour image) is applied after the launch, in
// ops/sampling.py.
//
// Bound on the H100: bytes. Per voxel kernel 1 reads u, v, z (12 B) and
// writes the sample and flags (5 B); B2 writes two samples and the flags
// (9 B). At KITTI scale (V = 8192 blocks) that is 71 MB and 88 MB, about
// 21 us and 26 us at 3.35 TB/s. The TPU kernels staged each block's tile
// in VMEM because its element gathers were slow; here the packed images
// (1.8 MB each at 1226x370) stay in the 50 MB L2, so each voxel reads its
// pixels directly and nothing is staged. Loads and stores of u/v/z and the
// outputs are coalesced (consecutive threads, consecutive voxels).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVox = 512;
constexpr int kWarps = kVox / 32;
constexpr int kTileH = 64;
constexpr int kTileW = 256;
constexpr int kAlignV = 8;
constexpr int kAlignU = 128;
constexpr int kBig = 1 << 28;

__device__ __forceinline__ int warp_min(int x) {
  for (int o = 16; o > 0; o >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
  for (int o = 16; o > 0; o >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Voxel {
  size_t i;      // flat voxel index
  int pix;       // row-major pixel index, valid where inb
  bool inb;
  uint8_t flag;  // bit 0 in tile, bit 1 in bounds
};

// The shared tiling of both kernels: the voxel's pixel and bounds, the
// block's tile origin (a block-wide min/max, so every thread of the block
// must call it) and, from thread 0, the block's overflow flag.
__device__ __forceinline__ Voxel tile_voxel(int h, int w, int hp, int wp,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            const float* __restrict__ z,
                                            bool* __restrict__ overflow) {
  __shared__ int part[4][kWarps];
  const int t = threadIdx.x;
  Voxel vx;
  vx.i = (size_t)blockIdx.x * kVox + t;
  const float fz = z[vx.i];
  // round half to even (jnp.round); saturates out of range, where the
  // voxel is out of bounds anyway
  const int ui = __float2int_rn(u[vx.i]);
  const int vi = __float2int_rn(v[vx.i]);
  vx.inb = ui >= 0 && ui < w && vi >= 0 && vi < h && fz > 1e-3f;

  int umin = warp_min(vx.inb ? ui : kBig);
  int vmin = warp_min(vx.inb ? vi : kBig);
  int umax = warp_max(vx.inb ? ui : -kBig);
  int vmax = warp_max(vx.inb ? vi : -kBig);
  const int lane = t & 31, warp = t >> 5;
  if (lane == 0) {
    part[0][warp] = umin;
    part[1][warp] = vmin;
    part[2][warp] = umax;
    part[3][warp] = vmax;
  }
  __syncthreads();
  umin = part[0][0];
  vmin = part[1][0];
  umax = part[2][0];
  vmax = part[3][0];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    umin = min(umin, part[0][k]);
    vmin = min(vmin, part[1][k]);
    umax = max(umax, part[2][k]);
    vmax = max(vmax, part[3][k]);
  }
  const bool any_in = umin <= umax;
  const int u0 = min(max((any_in ? umin : 0) & ~(kAlignU - 1), 0), wp - kTileW);
  const int v0 = min(max((any_in ? vmin : 0) & ~(kAlignV - 1), 0), hp - kTileH);
  if (t == 0) {
    overflow[blockIdx.x] =
        any_in && ((umax - u0) >= kTileW || (vmax - v0) >= kTileH);
  }
  vx.pix = 0;
  vx.flag = 0;
  if (vx.inb) {
    vx.pix = vi * w + ui;
    const int tu = ui - u0, tv = vi - v0;
    vx.flag = 2 | ((tu >= 0 && tu < kTileW && tv >= 0 && tv < kTileH) ? 1 : 0);
  }
  return vx;
}

__global__ void __launch_bounds__(kVox)
tile_sample_kernel(const int32_t* __restrict__ img, int h, int w, int hp, int wp,
                   const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ z, int32_t* __restrict__ sample,
                   uint8_t* __restrict__ flags, bool* __restrict__ overflow) {
  const Voxel vx = tile_voxel(h, w, hp, wp, u, v, z, overflow);
  sample[vx.i] = vx.inb ? img[vx.pix] : 0;
  flags[vx.i] = vx.flag;
}

__global__ void __launch_bounds__(kVox)
tile_sample_rgb_kernel(const int32_t* __restrict__ img1,
                       const int32_t* __restrict__ img2, int h, int w, int hp,
                       int wp, const float* __restrict__ u,
                       const float* __restrict__ v, const float* __restrict__ z,
                       int32_t* __restrict__ out1, int32_t* __restrict__ out2,
                       uint8_t* __restrict__ flags, bool* __restrict__ overflow) {
  const Voxel vx = tile_voxel(h, w, hp, wp, u, v, z, overflow);
  int32_t o1 = 0, o2 = 0;
  if (vx.inb) {
    const int32_t a = img1[vx.pix];   // d_mm | r << 16
    const int32_t b = img2[vx.pix];   // g | b << 8
    o1 = ((a & 0xFFFF) << 8) | ((a >> 16) & 0xFF);
    o2 = ((b & 0xFF) << 8) | ((b >> 8) & 0xFF);
  }
  out1[vx.i] = o1;
  out2[vx.i] = o2;
  flags[vx.i] = vx.flag;
}

}  // namespace

extern "C" int tile_sample_launch(const void* img, int h, int w, int hp, int wp,
                                  const void* u, const void* v, const void* z,
                                  int nblk, void* sample, void* flags,
                                  void* overflow, void* stream) {
  if (nblk <= 0) return 0;
  tile_sample_kernel<<<nblk, kVox, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(img), h, w, hp, wp,
      static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(z), static_cast<int32_t*>(sample),
      static_cast<uint8_t*>(flags), static_cast<bool*>(overflow));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tile_sample_rgb_launch(const void* img1, const void* img2, int h,
                                      int w, int hp, int wp, const void* u,
                                      const void* v, const void* z, int nblk,
                                      void* out1, void* out2, void* flags,
                                      void* overflow, void* stream) {
  if (nblk <= 0) return 0;
  tile_sample_rgb_kernel<<<nblk, kVox, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(img1), static_cast<const int32_t*>(img2), h, w,
      hp, wp, static_cast<const float*>(u), static_cast<const float*>(v),
      static_cast<const float*>(z), static_cast<int32_t*>(out1),
      static_cast<int32_t*>(out2), static_cast<uint8_t*>(flags),
      static_cast<bool*>(overflow));
  return static_cast<int>(cudaGetLastError());
}
