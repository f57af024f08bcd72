// Hard z-priority rasterization of typed primitives (quads and triangles)
// over a given background: the renderer's untextured and wide-view
// primitive paths.
//
// Replaces the reference's TPU kernels ops/pallas_rasterize.py:
//   * _raster_kernel_prims_masked (the banded raster, B7): row-major-sorted
//     prims, and per (band, 8-primitive chunk) occupancy bits; a band
//     visits only its live chunks;
//   * _raster_kernel_prims (the unbanded raster, B8): the same with every
//     chunk live (null masks).
// Per camera and pixel (r, c) of a res x res view (any multiple of 16 with a
// band tiling, above 128 too), with pixel center (r + 0.5, c + 0.5):
//   * winner: prim_winner.cuh, shared with the fused render; each 16 x 16
//     tile tests only the primitives that can reach it (without masks, B8,
//     only the edge test culls);
//   * composite: covered iff winner < 127<<24, then
//     ((winner >> 16) & 255, (winner >> 8) & 255, winner & 255) times
//     float32(1/255) (round-to-nearest), else the background's value.
//
// Background: read through its strides (batch, channel, pixel), so the
// untextured renderer's one color per camera, expanded to (B, 3, res, res)
// with pixel stride 0, is never written out; on the wide view it is the
// sampled (B, 3, res, res) image, pixel stride 1.
//
// Bound: the untextured headline (256 cameras, 128 x 128) writes 50 MB of
// float32 channels and reads ~2 KB of operands per camera; a tile meets
// about one primitive, ~11-15 float32 operations per pixel, so the write
// bounds it. The wide view adds the background's read.
//
// Layout (prim_winner.cuh): one block of 8 warps per 8 tiles of one camera;
// the camera's table is staged in shared memory once per block; each warp
// finds its tile's winners, then reads the background and writes its 256
// pixels, two 64-byte tile rows per warp store.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_winner.cuh"

namespace {

using tds::kCoveredBelow;
using tds::kInv255;
using tds::kPrimThreads;
using tds::kTilePixels;

__global__ void __launch_bounds__(kPrimThreads)
prim_raster_kernel(const float* __restrict__ qcoef,   // (B, 2, qp, 3)
                   const int* __restrict__ qpk,       // (B, qp, 1)
                   const float* __restrict__ tcoef,   // (B, 3, tp, 3)
                   const int* __restrict__ tpk,       // (B, tp, 1)
                   const int* __restrict__ qmask,     // (B, J, 1, cq) or null
                   const int* __restrict__ tmask,     // (B, J, 1, ct) or null
                   const float* __restrict__ bg,      // strided (B, 3, res^2)
                   int res, int rpb, int qp, int tp, long long bg_sb,
                   long long bg_sc, long long bg_sp,
                   float* __restrict__ out) {         // (B, 3, res, res)
  const int cam = blockIdx.y;

  extern __shared__ float4 smem[];
  const tds::PrimTable prims(smem, cam, qp, tp, rpb, res / rpb, qcoef, qpk, tcoef,
                             tpk, qmask, tmask);
  __syncthreads();

  const int per_side = res / tds::kPrimTile;
  const int tile = blockIdx.x * tds::kTileWarps + threadIdx.x / 32;
  if (tile >= per_side * per_side) return;
  const int r0 = tile / per_side * tds::kPrimTile;
  const int c0 = tile % per_side * tds::kPrimTile;
  int best[kTilePixels];
  tds::tile_winners(prims, r0, c0, best);

  const size_t plane = (size_t)res * res;
  const float* bg_cam = bg + cam * bg_sb;
  float* out_cam = out + (size_t)cam * 3 * plane;
  const int lane = threadIdx.x & 31;
  const int c = c0 + (lane & 15);
#pragma unroll
  for (int i = 0; i < kTilePixels; ++i) {
    const size_t pix = (size_t)(r0 + (lane >> 4) + 2 * i) * res + c;
    if (best[i] < kCoveredBelow) {
      out_cam[pix] = __fmul_rn((float)((best[i] >> 16) & 255), kInv255);
      out_cam[plane + pix] = __fmul_rn((float)((best[i] >> 8) & 255), kInv255);
      out_cam[2 * plane + pix] = __fmul_rn((float)(best[i] & 255), kInv255);
    } else {
      const float* b = bg_cam + (long long)pix * bg_sp;
      out_cam[pix] = __ldg(b);
      out_cam[plane + pix] = __ldg(b + bg_sc);
      out_cam[2 * plane + pix] = __ldg(b + 2 * bg_sc);
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes: qmask and tmask null rasterize
// every chunk (B8). Launches on ``stream`` and returns cudaGetLastError() (0
// on success); it does not synchronize.
extern "C" int tds_prim_raster(const float* qcoef, const int* qpk,
                               const float* tcoef, const int* tpk,
                               const int* qmask, const int* tmask,
                               const float* bg, int batch, int res, int rpb,
                               int qp, int tp, long long bg_sb, long long bg_sc,
                               long long bg_sp, void* out, void* stream) {
  prim_raster_kernel<<<tds::prim_grid(res, batch), kPrimThreads,
                       tds::prim_table_bytes(qp, tp),
                       static_cast<cudaStream_t>(stream)>>>(
      qcoef, qpk, tcoef, tpk, qmask, tmask, bg, res, rpb, qp, tp, bg_sb, bg_sc,
      bg_sp, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The kernel's registers per thread, resident blocks per SM and spill bytes
// per thread at qp quads and tp triangles, into out[0..2].
extern "C" int tds_prim_raster_occupancy(int qp, int tp, int* out) {
  return tds::kernel_occupancy(prim_raster_kernel, tds::prim_table_bytes(qp, tp), out);
}
