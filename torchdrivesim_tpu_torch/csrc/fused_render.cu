// Fused warp + primitive rasterization + composite: one bird's-eye-view
// frame per camera, written straight to the output, with no background
// image ever stored.
//
// Replaces the reference's TPU kernel ops/pallas_fused.py:_fused_kernel on
// its default 2D branch _fused_cameras_2d, together with the two functions
// it inlines from ops/pallas_warp.py: warp_view_packed (the nearest-texel
// affine warp) and start_window_dma (the texture-window copy).
//
// Per camera b and pixel (r, c) of a res x res view (res <= 128, a multiple
// of 16), with pixel center (px, py) = (r + 0.5, c + 0.5):
//   * winner: the minimum packed value zrank<<24 | R<<16 | G<<8 | B over the
//     quads with max(|e0|, |e1|) <= 0.5 and the triangles whose three edge
//     values are all >= 0, counting a primitive only where its 8-primitive
//     chunk's band occupancy bit is set (starts at the sentinel 0x7FFFFFFF);
//     each 16 x 16 tile tests only the primitives that can reach it
//     (prim_winner.cuh, shared with prim_raster.cu, where the cull's
//     exactness is argued);
//   * background: the texel the reference's two-pass warp picks -- row index
//     v rounded first, column index h evaluated at the INTEGER v -- computed
//     in one pass per pixel (warp_index.cuh, shared with warp_nearest.cu); on this card a gather from the L2-resident mip
//     level (under 1 MB at the headline) is cheap, so there is no window copy
//     and no transpose. Off-texture pixels take the packed background color;
//   * composite: covered iff winner < 127<<24; the primitive pack is
//     R-high, the texture pack 0x00BBGGRR is R-low.
//
// Arithmetic: every a*x + b*y + c is (a*x + b*y) + c with each operation
// rounded on its own, spelled with round-to-nearest intrinsics so that nvcc
// cannot contract it into fused multiply-adds (an FMA flips pixels that lie
// on an edge). The plain PyTorch version (ops/fused.py, ops/warp.py)
// computes the same operations, so the two agree bit for bit. Index
// rounding is floor(x + 0.5), not rintf.
//
// Bound: at the headline (256 cameras, 128 x 128, three float32 channels)
// the step writes 256*3*128*128*4 B = 50 MB, against ~2 KB of per-camera
// operands and < 1 MB of texture read from L2; a 16 x 16 tile meets about
// one primitive, so with the cull the kernel is bound by its output write.
// The design keeps the write the only large traffic (one coalesced store
// per channel per pixel: each warp store covers two 64-byte tile rows,
// nothing staged through device memory), and the packed output mode writes
// one int32 0x00BBGGRR per pixel instead, a third of the bytes.
//
// Layout (prim_winner.cuh): one block of 8 warps per 8 tiles of one camera,
// 2,048 blocks at the headline; the camera's table and warp coefficients
// are staged in shared memory once per block; each warp finds its tile's
// winners, then gathers the texels and writes its 256 pixels.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_winner.cuh"
#include "warp_index.cuh"

namespace {

using tds::kCoveredBelow;
using tds::kInv255;
using tds::kPrimThreads;
using tds::kTilePixels;

__global__ void __launch_bounds__(kPrimThreads)
fused_render_kernel(const float* __restrict__ fcoef,   // (B, 1, 14)
                    const int* __restrict__ icoef,     // (B, 1, 4)
                    const int* __restrict__ qmask,     // (B, J, 1, cq)
                    const int* __restrict__ tmask,     // (B, J, 1, ct)
                    const float* __restrict__ qcoef,   // (B, 2, qp, 3)
                    const int* __restrict__ qpk,       // (B, qp, 1)
                    const float* __restrict__ tcoef,   // (B, 3, tp, 3)
                    const int* __restrict__ tpk,       // (B, tp, 1)
                    const int* __restrict__ tex,       // (tex_h, tex_w)
                    int tex_h, int tex_w, int res, int rpb, int qp, int tp,
                    int packed, float* __restrict__ out_f,
                    int* __restrict__ out_i) {
  const int cam = blockIdx.y;

  extern __shared__ float4 smem[];
  const tds::PrimTable prims(smem, cam, qp, tp, rpb, res / rpb, qcoef, qpk, tcoef,
                             tpk, qmask, tmask);
  float* s_fcoef = reinterpret_cast<float*>(smem + 2 * qp + 3 * tp);   // 14
  int* s_icoef = reinterpret_cast<int*>(s_fcoef + 14);                // 4
  if (threadIdx.x < 14) s_fcoef[threadIdx.x] = fcoef[cam * 14 + threadIdx.x];
  if (threadIdx.x < 4) s_icoef[threadIdx.x] = icoef[cam * 4 + threadIdx.x];
  __syncthreads();

  const int per_side = res / tds::kPrimTile;
  const int tile = blockIdx.x * tds::kTileWarps + threadIdx.x / 32;
  if (tile >= per_side * per_side) return;
  const int r0 = tile / per_side * tds::kPrimTile;
  const int c0 = tile % per_side * tds::kPrimTile;
  int best[kTilePixels];
  tds::tile_winners(prims, r0, c0, best);

  const tds::NearestWarp warp(s_fcoef, s_icoef);
  const size_t plane = (size_t)res * res;
  const int lane = threadIdx.x & 31;
  const int c = c0 + (lane & 15);
#pragma unroll
  for (int i = 0; i < kTilePixels; ++i) {
    const int r = r0 + (lane >> 4) + 2 * i;
    // background: nearest texel by the two-pass index arithmetic
    const int bg = warp.texel(tex, tex_h, tex_w, r, c);
    const bool covered = best[i] < kCoveredBelow;
    const size_t pix = (size_t)r * res + c;
    if (packed) {
      const int b = best[i];
      const int prim = ((b >> 16) & 255) | (b & 0xFF00) | ((b & 255) << 16);
      out_i[(size_t)cam * plane + pix] = covered ? prim : bg;
    } else {
      const int red = covered ? (best[i] >> 16) & 255 : bg & 255;
      const int green = covered ? (best[i] >> 8) & 255 : (bg >> 8) & 255;
      const int blue = covered ? best[i] & 255 : (bg >> 16) & 255;
      float* o = out_f + (size_t)cam * 3 * plane + pix;
      o[0] = __fmul_rn((float)red, kInv255);
      o[plane] = __fmul_rn((float)green, kInv255);
      o[2 * plane] = __fmul_rn((float)blue, kInv255);
    }
  }
}

size_t fused_smem(int qp, int tp) {
  return tds::prim_table_bytes(qp, tp) + sizeof(float) * 14 + sizeof(int) * 4;
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); it does not synchronize.
extern "C" int tds_fused_render(const float* fcoef, const int* icoef,
                                const int* qmask, const int* tmask,
                                const float* qcoef, const int* qpk,
                                const float* tcoef, const int* tpk,
                                const int* tex, int tex_h, int tex_w,
                                int batch, int res, int rpb, int qp, int tp,
                                int packed, void* out, void* stream) {
  fused_render_kernel<<<tds::prim_grid(res, batch), kPrimThreads, fused_smem(qp, tp),
                        static_cast<cudaStream_t>(stream)>>>(
      fcoef, icoef, qmask, tmask, qcoef, qpk, tcoef, tpk, tex, tex_h, tex_w,
      res, rpb, qp, tp, packed, packed ? nullptr : static_cast<float*>(out),
      packed ? static_cast<int*>(out) : nullptr);
  return (int)cudaGetLastError();
}

// The kernel's registers per thread, resident blocks per SM and spill bytes
// per thread at qp quads and tp triangles, into out[0..2].
extern "C" int tds_fused_render_occupancy(int qp, int tp, int* out) {
  return tds::kernel_occupancy(fused_render_kernel, fused_smem(qp, tp), out);
}
