// Nearest-texel background warp: each camera's (3, res, res) float view of
// a packed mip level, channels in [0, 1].
//
// Replaces the reference's TPU kernel ops/pallas_warp.py:_warp_kernel with
// the function it runs per camera, warp_view_packed (the two-pass nearest
// warp of a 128 x 256 texel window), followed by the channel unpack.
//
// The texel each pixel reads is B1's (fused_render.cu): the index arithmetic
// lives in warp_index.cuh, shared by both kernels. The TPU kernel computes a
// full 128 x 128 view and crops it to res; here each thread computes one
// pixel of the res x res view directly. Channel k of texel 0x00BBGGRR is
// ((t >> 8k) & 255) * float32(1/255), a multiply by the constant as in the
// reference, so the kernel matches its plain version (ops/warp.py:
// warp_view_nearest_reference) bit for bit.
//
// Bound: per pixel 12 bytes written against a 4-byte texel gathered from
// the mip level (under 1 MB at the RL configuration, resident in L2) and
// ~20 float32 operations: the output write bounds it. One thread per pixel,
// consecutive threads on consecutive columns, so each channel's store is
// coalesced; the camera's 18 coefficients are read by every thread of the
// block from the same address (a broadcast).

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_index.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
warp_nearest_kernel(const float* __restrict__ fcoef,   // (B, 1, 14)
                    const int* __restrict__ icoef,     // (B, 1, 4)
                    const int* __restrict__ tex,       // (tex_h, tex_w)
                    int tex_h, int tex_w, int res,
                    float* __restrict__ out) {         // (B, 3, res, res)
  const int cam = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const int plane = res * res;
  if (pix >= plane) return;
  const tds::NearestWarp warp(fcoef + (size_t)cam * 14, icoef + (size_t)cam * 4);
  const int t = warp.texel(tex, tex_h, tex_w, pix / res, pix % res);
  float* o = out + (size_t)cam * 3 * plane + pix;
  o[0] = __fmul_rn((float)(t & 255), tds::kInv255);
  o[plane] = __fmul_rn((float)((t >> 8) & 255), tds::kInv255);
  o[2 * plane] = __fmul_rn((float)((t >> 16) & 255), tds::kInv255);
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); it does not synchronize.
extern "C" int tds_warp_nearest(const float* fcoef, const int* icoef,
                                const int* tex, int tex_h, int tex_w,
                                int batch, int res, void* out, void* stream) {
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  warp_nearest_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fcoef, icoef, tex, tex_h, tex_w, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
