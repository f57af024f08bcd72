// One camera's bilinear-warp coefficients from its pose, on the card: the
// operations of ops/warp.py:warp_coefficients as PyTorch runs them on CUDA
// tensors, in the same order, so that the coefficients (and the view the
// two-pass body of warp_bilinear.cu draws from them) equal the plain
// version's bit for bit. Shared by the bilinear warp (B3) and its pose VJP,
// both in warp_bilinear.cu.
//
// The constants come from the host (ops/warp.py:_pose_constants), each a
// Python double rounded to float32 once, as PyTorch rounds a Python scalar
// that meets a float32 tensor: m = 1 / (ppm * cell), mh0 = m * h0 (the
// double product, then rounded), the level's origin and cell, lh = +-1 and
// the true texture bounds. On CUDA tensors PyTorch divides by a Python
// scalar as a product by its float32 reciprocal (so ``/ cell`` is
// x * (1 / cell) here, and ``/ 8.0``, ``/ 128.0`` products by exact powers
// of two); tensor by tensor divisions are __fdiv_rn. torch.round rounds
// half to even (rintf), ``.to(torch.int32)`` truncates. Every product and
// sum is a round-to-nearest intrinsic, so nvcc cannot contract them.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tds {

// Host-side float32 constants of one warp call.
struct WarpPose {
  float m, mh0, origin_x, origin_y, cell, lh, h_tex, w_tex;
};

// The coefficients of warp_coefficients: f = fcoef[b, 0] (v = f[0:3],
// h = f[3:6], ty = f[6:9], tx = f[9:12], h_tex, w_tex), and icoef[b, 0]
// as oy, ox, flip and the packed background.
struct WarpCoef {
  float f[14];
  int oy, ox, bg_packed;
  bool flip;
};

// The window origin along one axis: align * round((t - centre) / align),
// clamped to [0, hi]; ``inv_align`` is 1 / align (a power of two).
__device__ __forceinline__ int window_origin(float t, float centre, float inv_align,
                                             int align, int hi) {
  const int o = align * (int)rintf(__fmul_rn(__fsub_rn(t, centre), inv_align));
  return min(max(o, 0), hi);
}

// clamp(c * 255, 0, 255) truncated: one channel of the packed background.
__device__ __forceinline__ int background_byte(float c) {
  return (int)fminf(fmaxf(__fmul_rn(c, 255.0f), 0.0f), 255.0f);
}

// The affine map from output pixel (r, c) to texel coordinates (ty, tx)
// = (a_y*r + b_y*c + e_y, a_x*r + b_x*c + e_x), and the camera's texel
// position (cy, cx), of a camera at (x, y) heading (sn, cs) = (sin, cos):
// ops/warp.py:sample_positions and warp_coefficients spell them alike.
struct TexAffine {
  float a_y, b_y, e_y, a_x, b_x, e_x, cy, cx;
};

__device__ __forceinline__ TexAffine texture_affine(const WarpPose& p, float x,
                                                    float y, float sn, float cs) {
  TexAffine t;
  t.a_y = __fmul_rn(-sn, p.m);
  t.b_y = __fmul_rn(__fmul_rn(-p.lh, cs), p.m);
  t.a_x = __fmul_rn(-cs, p.m);
  t.b_x = __fmul_rn(__fmul_rn(p.lh, sn), p.m);
  const float inv_cell = __fdiv_rn(1.0f, p.cell);
  t.cy = __fmul_rn(__fsub_rn(y, p.origin_y), inv_cell);
  t.cx = __fmul_rn(__fsub_rn(x, p.origin_x), inv_cell);
  t.e_y = __fadd_rn(t.cy, __fmul_rn(p.mh0, __fadd_rn(sn, __fmul_rn(p.lh, cs))));
  t.e_x = __fadd_rn(t.cx, __fmul_rn(p.mh0, __fsub_rn(cs, __fmul_rn(p.lh, sn))));
  return t;
}

// All 14 + 4 coefficients of that camera over a padded level of h_pad x
// w_pad texels, background colour ``bg`` (3 floats in [0, 1]).
__device__ __forceinline__ WarpCoef warp_coefficients(
    const WarpPose& p, float x, float y, float sn, float cs, int h_pad,
    int w_pad, const float* __restrict__ bg) {
  constexpr int kWinRows = 128, kWindow = 256;
  WarpCoef k;
  const TexAffine t = texture_affine(p, x, y, sn, cs);
  const float a_y = t.a_y, b_y = t.b_y, e_y = t.e_y;
  const float a_x = t.a_x, b_x = t.b_x, e_x = t.e_x;

  // window origins: rows align to 8 around the (kWinRows - 1) / 2 = 63.5
  // centre, columns to 128 around 128
  k.oy = window_origin(t.cy, 63.5f, 0.125f, 8, max(h_pad - kWinRows, 0));
  k.ox = window_origin(t.cx, 128.0f, 0.0078125f, 128, max(w_pad - kWindow, 0));
  const float e1 = __fsub_rn(e_y, (float)k.oy);
  const float e2 = __fsub_rn(e_x, (float)k.ox);

  // the transposed branch (|a1| < |a2|) swaps the roles of the two passes
  k.flip = fabsf(a_y) < fabsf(a_x);
  const float pa1 = k.flip ? a_x : a_y, pb1 = k.flip ? b_x : b_y;
  const float pe1 = k.flip ? e2 : e1;
  const float pa2 = k.flip ? a_y : a_x, pb2 = k.flip ? b_y : b_x;
  const float pe2 = k.flip ? e1 : e2;
  const float safe = fabsf(pa1) < 1e-9f ? 1e-9f : pa1;
  k.f[0] = pa1; k.f[1] = pb1; k.f[2] = pe1;
  k.f[3] = __fdiv_rn(pa2, safe);
  k.f[4] = __fsub_rn(pb2, __fdiv_rn(__fmul_rn(pa2, pb1), safe));
  k.f[5] = __fsub_rn(pe2, __fdiv_rn(__fmul_rn(pa2, pe1), safe));
  k.f[6] = a_y; k.f[7] = b_y; k.f[8] = e_y;
  k.f[9] = a_x; k.f[10] = b_x; k.f[11] = e_x;
  k.f[12] = p.h_tex; k.f[13] = p.w_tex;
  k.bg_packed = background_byte(__ldg(bg)) | (background_byte(__ldg(bg + 1)) << 8)
                | (background_byte(__ldg(bg + 2)) << 16);
  return k;
}

}  // namespace tds
