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
//   * winner: prim_winner.cuh, shared with the fused render;
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
// float32 channels and reads ~2 KB of operands per camera; a band's live
// chunks hold a handful of prims, ~11-15 float32 operations each per pixel,
// so the write bounds it. The wide view adds the background's read.
//
// Layout: one block per (band, camera), as the fused render: the camera's
// operands and the band's mask bits are staged in shared memory; each
// thread walks the band's pixels with a block-wide stride, so neighbouring
// threads read and store neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_winner.cuh"

namespace {

using tds::kCoveredBelow;
using tds::kInv255;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
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
  const int band = blockIdx.x;
  const int cam = blockIdx.y;

  extern __shared__ float smem[];
  const tds::PrimTable prims(smem, cam, band, gridDim.x, qp, tp, qcoef, qpk,
                             tcoef, tpk, qmask, tmask);
  __syncthreads();

  const size_t plane = (size_t)res * res;
  const float* bg_cam = bg + cam * bg_sb;
  float* out_cam = out + (size_t)cam * 3 * plane;

  for (int idx = threadIdx.x; idx < rpb * res; idx += blockDim.x) {
    const int r = band * rpb + idx / res;
    const int c = idx % res;
    const int best = prims.winner((float)r + 0.5f, (float)c + 0.5f);
    const size_t pix = (size_t)r * res + c;
    if (best < kCoveredBelow) {
      out_cam[pix] = __fmul_rn((float)((best >> 16) & 255), kInv255);
      out_cam[plane + pix] = __fmul_rn((float)((best >> 8) & 255), kInv255);
      out_cam[2 * plane + pix] = __fmul_rn((float)(best & 255), kInv255);
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
  const int n_bands = res / rpb;
  dim3 grid(n_bands, batch);
  prim_raster_kernel<<<grid, kThreads, tds::prim_table_bytes(qp, tp),
                       static_cast<cudaStream_t>(stream)>>>(
      qcoef, qpk, tcoef, tpk, qmask, tmask, bg, res, rpb, qp, tp, bg_sb, bg_sc,
      bg_sp, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
