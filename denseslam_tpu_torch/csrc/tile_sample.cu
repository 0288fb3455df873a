// Kernel 1: fusion image sampler.
//
// Replaces the JAX package's Pallas tile sampler,
// denseslam_tpu/ops/sampling.py `_kernel` / `_sample_subbatch` (launched by
// `_tile_sample_call`), and folds in the per-block tiling pass `_tiling`.
// For each visible 8^3 map block (one CUDA block, 512 threads, one voxel
// per thread) it computes:
//   * ui, vi = round-half-even(u, v); in_bounds = inside the image and
//     z > 1e-3;
//   * the block's tile origin, snapped down to (8, 128) and clipped to the
//     padded image exactly as `_tiling` does, and the block's `overflow`
//     flag (footprint wider than 256 or taller than 64 px past the origin);
//   * the voxel's pixel of the packed image (d_mm << 8 | gray) where in
//     bounds, else 0, and flags: bit 0 = inside the tile, bit 1 = in bounds.
// The cap rule of the JAX fallback (first `pallas_overflow_cap` overflow
// blocks keep their out-of-tile voxels) is applied after the launch, in
// ops/sampling.py `apply_overflow_cap`.
//
// Bound on the H100: bytes. Per voxel it reads u, v, z (12 B) and writes
// the sample and flags (5 B); at KITTI scale (V = 8192 blocks) that is
// 71 MB, about 21 us at 3.35 TB/s. The TPU kernel staged each block's
// tile in VMEM because its element gathers were slow; here the packed
// image (1.8 MB at 1226x370) stays in the 50 MB L2, so each voxel reads
// its pixel directly and nothing is staged. Loads and stores of u/v/z and
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

__global__ void __launch_bounds__(kVox)
tile_sample_kernel(const int32_t* __restrict__ img, int h, int w, int hp, int wp,
                   const float* __restrict__ u, const float* __restrict__ v,
                   const float* __restrict__ z, int32_t* __restrict__ sample,
                   uint8_t* __restrict__ flags, bool* __restrict__ overflow) {
  __shared__ int part[4][kWarps];
  const int t = threadIdx.x;
  const size_t i = (size_t)blockIdx.x * kVox + t;
  const float fz = z[i];
  // round half to even (jnp.round); saturates out of range, where the
  // voxel is out of bounds anyway
  const int ui = __float2int_rn(u[i]);
  const int vi = __float2int_rn(v[i]);
  const bool inb = ui >= 0 && ui < w && vi >= 0 && vi < h && fz > 1e-3f;

  int umin = warp_min(inb ? ui : kBig);
  int vmin = warp_min(inb ? vi : kBig);
  int umax = warp_max(inb ? ui : -kBig);
  int vmax = warp_max(inb ? vi : -kBig);
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

  int32_t s = 0;
  uint8_t f = 0;
  if (inb) {
    s = img[(size_t)vi * w + ui];
    const int tu = ui - u0, tv = vi - v0;
    f = 2 | ((tu >= 0 && tu < kTileW && tv >= 0 && tv < kTileH) ? 1 : 0);
  }
  sample[i] = s;
  flags[i] = f;
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
