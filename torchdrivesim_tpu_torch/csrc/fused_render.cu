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
//     values are all >= 0, visiting only 8-primitive chunks whose band x
//     chunk occupancy bit is set (starts at the sentinel 0x7FFFFFFF); the
//     loop is prim_winner.cuh's, shared with prim_raster.cu;
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
// operands and < 1 MB of texture read from L2: the kernel is bound by its
// output write. The design keeps the write the only large traffic (one
// coalesced store per channel per pixel, nothing staged through device
// memory), and the packed output mode writes one int32 0x00BBGGRR per pixel
// instead, a third of the bytes.
//
// Layout: one block per (band, camera); the camera's coefficients, packs
// and the band's mask bits (prim_winner.cuh) and warp coefficients are
// staged in shared memory; each thread walks
// the band's pixels with a block-wide stride, so neighbouring threads store
// neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_winner.cuh"
#include "warp_index.cuh"

namespace {

using tds::kCoveredBelow;
using tds::kInv255;

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
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
  const int band = blockIdx.x;
  const int cam = blockIdx.y;

  extern __shared__ float smem[];
  const tds::PrimTable prims(smem, cam, band, gridDim.x, qp, tp, qcoef, qpk,
                             tcoef, tpk, qmask, tmask);
  float* s_fcoef = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem) + tds::prim_table_bytes(qp, tp));   // 14
  int* s_icoef = reinterpret_cast<int*>(s_fcoef + 14);                // 4
  if (threadIdx.x < 14) s_fcoef[threadIdx.x] = fcoef[cam * 14 + threadIdx.x];
  if (threadIdx.x < 4) s_icoef[threadIdx.x] = icoef[cam * 4 + threadIdx.x];
  __syncthreads();

  const tds::NearestWarp warp(s_fcoef, s_icoef);
  const size_t plane = (size_t)res * res;

  for (int idx = threadIdx.x; idx < rpb * res; idx += blockDim.x) {
    const int r = band * rpb + idx / res;
    const int c = idx % res;
    const int best = prims.winner((float)r + 0.5f, (float)c + 0.5f);

    // background: nearest texel by the two-pass index arithmetic
    const int bg = warp.texel(tex, tex_h, tex_w, r, c);

    const bool covered = best < kCoveredBelow;
    const size_t pix = (size_t)r * res + c;
    if (packed) {
      const int prim = ((best >> 16) & 255) | (best & 0xFF00) | ((best & 255) << 16);
      out_i[(size_t)cam * plane + pix] = covered ? prim : bg;
    } else {
      const int red = covered ? (best >> 16) & 255 : bg & 255;
      const int green = covered ? (best >> 8) & 255 : (bg >> 8) & 255;
      const int blue = covered ? best & 255 : (bg >> 16) & 255;
      float* o = out_f + (size_t)cam * 3 * plane + pix;
      o[0] = __fmul_rn((float)red, kInv255);
      o[plane] = __fmul_rn((float)green, kInv255);
      o[2 * plane] = __fmul_rn((float)blue, kInv255);
    }
  }
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
  const int n_bands = res / rpb;
  const size_t smem = tds::prim_table_bytes(qp, tp) + sizeof(float) * 14
                      + sizeof(int) * 4;
  dim3 grid(n_bands, batch);
  fused_render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fcoef, icoef, qmask, tmask, qcoef, qpk, tcoef, tpk, tex, tex_h, tex_w,
      res, rpb, qp, tp, packed, packed ? nullptr : static_cast<float*>(out),
      packed ? static_cast<int*>(out) : nullptr);
  return (int)cudaGetLastError();
}
