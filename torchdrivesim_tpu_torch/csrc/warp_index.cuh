// The nearest-texel index arithmetic of the reference's two-pass warp
// (ops/pallas_warp.py:warp_view_packed), shared by the fused render
// (fused_render.cu) and the standalone nearest warp (warp_nearest.cu).
//
// Per camera, the coefficients of ops/warp.py:warp_coefficients:
//   fcoef (14): v = (va, vb, vc), h = (ha, hb, hc), ty = (ty_a, ty_b, ty_c),
//               tx = (tx_a, tx_b, tx_c), the true texture bounds h_tex, w_tex;
//   icoef (4):  window origin (oy, ox), transpose flag, packed background.
// Pixel (r, c) reads the texel the two passes pick: the row index v is
// rounded first, and the column index h is evaluated at the INTEGER v; on
// the transposed branch the roles of window rows and columns swap. A pixel
// whose texture coordinates (ty, tx) fall outside the true bounds takes the
// packed background color. Texels are 0x00BBGGRR (R in the low byte).
//
// Arithmetic: every a*x + b*y + c is (a*x + b*y) + c with each operation
// rounded on its own, spelled with round-to-nearest intrinsics so that nvcc
// cannot contract it into fused multiply-adds; index rounding is
// floor(x + 0.5). The plain PyTorch version (ops/warp.py:
// warp_view_packed_reference) computes the same operations, bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tds {

constexpr int kWinRows = 128;   // texture window rows (origins align to 8)
constexpr int kWindow = 256;    // texture window columns (origins align to 128)
// float32(1 / 255), the reference's per-channel scale
constexpr float kInv255 = 0x1.010102p-8f;

__device__ __forceinline__ float affine(float a, float x, float b, float y,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

// One camera's warp coefficients, read once into registers.
struct NearestWarp {
  float va, vb, vc, ha, hb, hc, ty_a, ty_b, ty_c, tx_a, tx_b, tx_c;
  float h_tex, w_tex, v_hi, h_hi;
  int oy, ox, bg_packed;
  bool flip;

  __device__ __forceinline__ NearestWarp(const float* f, const int* i) {
    va = f[0]; vb = f[1]; vc = f[2];
    ha = f[3]; hb = f[4]; hc = f[5];
    ty_a = f[6]; ty_b = f[7]; ty_c = f[8];
    tx_a = f[9]; tx_b = f[10]; tx_c = f[11];
    h_tex = f[12]; w_tex = f[13];
    oy = i[0]; ox = i[1];
    flip = i[2] == 1;
    bg_packed = i[3];
    v_hi = flip ? (float)(kWindow - 1) : (float)(kWinRows - 1);
    h_hi = flip ? (float)(kWinRows - 1) : (float)(kWindow - 1);
  }

  // The packed 0x00BBGGRR background of output pixel (r, c).
  __device__ __forceinline__ int texel(const int* __restrict__ tex, int tex_h,
                                       int tex_w, int r, int c) const {
    const float fr = (float)r;
    const float fc = (float)c;
    const float v = clampf(floorf(__fadd_rn(affine(va, fr, vb, fc, vc), 0.5f)), v_hi);
    const float h = clampf(floorf(__fadd_rn(affine(ha, v, hb, fc, hc), 0.5f)), h_hi);
    const int vi = (int)v;
    const int hi = (int)h;
    const int ty_i = min(max(oy + (flip ? hi : vi), 0), tex_h - 1);
    const int tx_i = min(max(ox + (flip ? vi : hi), 0), tex_w - 1);
    const float ty = affine(ty_a, fr, ty_b, fc, ty_c);
    const float tx = affine(tx_a, fr, tx_b, fc, tx_c);
    const bool valid = ty >= 0.0f && ty < h_tex && tx >= 0.0f && tx < w_tex;
    return valid ? __ldg(tex + (size_t)ty_i * tex_w + tx_i) : bg_packed;
  }
};

}  // namespace tds
