// Bilinear background warp: each camera's float RGB view of the packed mip
// level, by the two-pass (Catmull-Smith) linear filter.
//
// Replaces the reference's TPU kernel ops/pallas_warp.py:_warp_bilinear_kernel
// (its per-camera body warp_view_bilinear), launched by
// warp_background_bilinear. It is the forward of the differentiable
// background (warp_background_diff); its backward has no kernel.
//
// Per camera and output pixel (r, c) of a res x res view (res <= 128), with
// the window origin (oy, ox), the affine coefficients fcoef[0:12] and the
// transpose flag of ops/warp.py:warp_coefficients:
//   * pass 2 position v = va*r + vb*c + vc, its taps k0 = clip(floor(v), 0,
//     K - 2) and k0 + 1, weight fv = clip(v - k0, 0, 1); K is 128 (window
//     rows) on the standard branch and 256 (window columns) on the
//     transposed one;
//   * for each tap k, pass 1 lerps along the other window axis at
//     h = ha*k + hb*c + hc: taps j0 = clip(floor(h), 0, J - 2) and j0 + 1,
//     weight fh = clip(h - j0, 0, 1), J being the other extent;
//   * the view is g0 + fv*(g1 - g0) of the two pass-1 values, per channel,
//     where the texel at window (row, col) is tex[oy + row, ox + col] and
//     the window row is k on the standard branch and j on the transposed;
//   * off-texture pixels (ty, tx outside the true texture) take the
//     background color icoef[3].
// The TPU kernel computes a 128 x 128 view and crops it; this one computes
// only the res x res pixels.
//
// Arithmetic: every product, sum and difference is spelled with a
// round-to-nearest intrinsic so that nvcc cannot contract it into a fused
// multiply-add; the plain PyTorch version (ops/warp.py:
// warp_view_bilinear_reference) performs the same operations in the same
// order, so the two agree bit for bit.
//
// Bound: at the IL configuration (16 cameras, 64 x 64) the kernel writes
// 16*3*64*64*4 B = 786 KB and reads under 1 MB of texture from L2: about
// 0.5 us of memory traffic, far below a launch. One thread per output pixel,
// four texel loads through the read-only cache, three coalesced stores; the
// launch latency dominates, which only fusing the launch away would change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWinRows = 128;
constexpr int kWindow = 256;
constexpr int kThreads = 256;
// float32(1 / 255), the reference's per-channel scale
constexpr float kInv255 = 0x1.010102p-8f;

__device__ __forceinline__ float affine(float a, float x, float b, float y,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float lerp(float g0, float g1, float fr) {
  return __fadd_rn(g0, __fmul_rn(fr, __fsub_rn(g1, g0)));
}

__device__ __forceinline__ float channel(int packed, int ch) {
  return __fmul_rn((float)((packed >> (8 * ch)) & 255), kInv255);
}

__global__ void __launch_bounds__(kThreads)
warp_bilinear_kernel(const float* __restrict__ fcoef,   // (B, 1, 14)
                     const int* __restrict__ icoef,     // (B, 1, 4)
                     const int* __restrict__ tex,       // (tex_h, tex_w)
                     int tex_h, int tex_w, int res,
                     float* __restrict__ out) {         // (B, 3, res, res)
  const int cam = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  const float* f = fcoef + (size_t)cam * 14;
  const int* ic = icoef + (size_t)cam * 4;
  const float va = __ldg(f + 0), vb = __ldg(f + 1), vc = __ldg(f + 2);
  const float ha = __ldg(f + 3), hb = __ldg(f + 4), hc = __ldg(f + 5);
  const float ty_a = __ldg(f + 6), ty_b = __ldg(f + 7), ty_c = __ldg(f + 8);
  const float tx_a = __ldg(f + 9), tx_b = __ldg(f + 10), tx_c = __ldg(f + 11);
  const float h_tex = __ldg(f + 12), w_tex = __ldg(f + 13);
  const int oy = __ldg(ic + 0), ox = __ldg(ic + 1);
  const bool flip = __ldg(ic + 2) == 1;
  const int bg_packed = __ldg(ic + 3);

  const int r = pix / res;
  const int c = pix % res;
  const float fr = (float)r;
  const float fc = (float)c;
  const float k_hi = flip ? (float)(kWindow - 2) : (float)(kWinRows - 2);
  const float j_hi = flip ? (float)(kWinRows - 2) : (float)(kWindow - 2);

  const float v = affine(va, fr, vb, fc, vc);
  const float k0 = clampf(floorf(v), 0.0f, k_hi);
  const float fv = clampf(__fsub_rn(v, k0), 0.0f, 1.0f);

  float pass1[2][3];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float k = __fadd_rn(k0, (float)t);
    const float h = affine(ha, k, hb, fc, hc);
    const float j0 = clampf(floorf(h), 0.0f, j_hi);
    const float fh = clampf(__fsub_rn(h, j0), 0.0f, 1.0f);
    const int ki = (int)k;
    const int ji = (int)j0;
    const int row0 = oy + (flip ? ji : ki);
    const int col0 = ox + (flip ? ki : ji);
    const int row1 = oy + (flip ? ji + 1 : ki);
    const int col1 = ox + (flip ? ki : ji + 1);
    // the window lies inside the padded level by construction; the clamps
    // only keep malformed coefficients from reading outside it
    const int t0 = __ldg(tex + (size_t)min(max(row0, 0), tex_h - 1) * tex_w
                         + min(max(col0, 0), tex_w - 1));
    const int t1 = __ldg(tex + (size_t)min(max(row1, 0), tex_h - 1) * tex_w
                         + min(max(col1, 0), tex_w - 1));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      pass1[t][ch] = lerp(channel(t0, ch), channel(t1, ch), fh);
  }

  const float ty = affine(ty_a, fr, ty_b, fc, ty_c);
  const float tx = affine(tx_a, fr, tx_b, fc, tx_c);
  const bool valid = ty >= 0.0f && ty < h_tex && tx >= 0.0f && tx < w_tex;
  const size_t plane = (size_t)res * res;
  float* o = out + (size_t)cam * 3 * plane + pix;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    o[ch * plane] = valid ? lerp(pass1[0][ch], pass1[1][ch], fv)
                          : channel(bg_packed, ch);
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); it does not synchronize.
extern "C" int tds_warp_bilinear(const float* fcoef, const int* icoef,
                                 const int* tex, int tex_h, int tex_w,
                                 int batch, int res, void* out, void* stream) {
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  warp_bilinear_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      fcoef, icoef, tex, tex_h, tex_w, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
