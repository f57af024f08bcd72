// The per-face arithmetic of the soft raster, shared by the single-group
// kernels (soft_raster.cu: B4a, B4b) and the grouped accumulator kernels
// (soft_accum.cu: B5a, B5b): the face's edge values, logistics and soft
// coverage at one pixel (the reference's ops/pallas_soft.py:_accumulate_face),
// the staging of a run of faces in shared memory, and the 13 gradient terms
// of one face at one pixel (the bodies of _soft_bwd_kernel and
// _accum_bwd_kernel after their dl/dalpha).
//
// A staged face is 13 floats: its edge coefficients coef[9] ([edge][A, B, C],
// t_e = A*px + B*py + C), its z weight and its color.
//
// Arithmetic: products and sums use round-to-nearest intrinsics, so nvcc
// cannot contract them into fused multiply-adds, and the logistic is
// __frcp_rn(1 + expf(-t)) with the accurate expf; the plain PyTorch versions
// (ops/soft.py) perform the same operations in the same order.
#pragma once

#include <cuda_runtime.h>

namespace tds {

constexpr int kFaceFloats = 13;   // coef[9], zw, color[3]

__device__ __forceinline__ float affine(float a, float x, float b, float y,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// the per-face quantities of ops/pallas_soft.py:_accumulate_face
struct FaceTerms {
  float t[3];
  float s[3];
  float big_s;
  float tmin;
  float alpha;
};

__device__ __forceinline__ FaceTerms face_terms(const float* fc, float px,
                                                float py) {
  FaceTerms ft;
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    ft.t[e] = affine(fc[3 * e], px, fc[3 * e + 1], py, fc[3 * e + 2]);
    ft.s[e] = __frcp_rn(__fadd_rn(1.0f, expf(-clampf(ft.t[e], -30.0f, 30.0f))));
  }
  ft.big_s = __fmul_rn(__fmul_rn(ft.s[0], ft.s[1]), ft.s[2]);
  ft.tmin = fminf(fminf(ft.t[0], ft.t[1]), ft.t[2]);
  const float window = clampf(__fadd_rn(ft.tmin, 4.0f), 0.0f, 1.0f);
  ft.alpha = __fmul_rn(ft.big_s, window);
  return ft;
}

// stage faces [first, first + n) of the flat coef (faces, 9), zw (faces)
// and color (faces, 3) arrays as n rows of kFaceFloats
__device__ __forceinline__ void load_faces(const float* coef, const float* zw,
                                           const float* color, size_t first,
                                           int n, float* s_face) {
  for (int i = threadIdx.x; i < n * 9; i += blockDim.x)
    s_face[(i / 9) * kFaceFloats + i % 9] = coef[first * 9 + i];
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    s_face[i * kFaceFloats + 9] = zw[first + i];
  for (int i = threadIdx.x; i < n * 3; i += blockDim.x)
    s_face[(i / 3) * kFaceFloats + 10 + i % 3] = color[first * 3 + i];
}

// The 13 gradient terms of one face at one pixel, [gA gB gC] per edge, gzw,
// gcolor[3], from the face's terms ft, its alpha, dl/dalpha, dl/dw and the
// per-channel cotangent chan of its weighted color (the window ramp's
// derivative flows only to the minimum edge, where -4 < tmin < -3).
__device__ __forceinline__ void face_grad_terms(const FaceTerms& ft,
                                                float alpha, float dl_dalpha,
                                                float dl_dw,
                                                const float chan[3], float zw,
                                                float px, float py,
                                                float vals[kFaceFloats]) {
  const float wmask = (ft.tmin > -4.0f && ft.tmin < -3.0f) ? 1.0f : 0.0f;
  const float sw = __fmul_rn(__fmul_rn(dl_dalpha, ft.big_s), wmask);
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const float tie = ft.t[e] == ft.tmin ? 1.0f : 0.0f;
    const float gt = __fadd_rn(
        __fmul_rn(dl_dalpha, __fmul_rn(alpha, __fsub_rn(1.0f, ft.s[e]))),
        __fmul_rn(sw, tie));
    vals[3 * e + 0] = __fmul_rn(gt, px);
    vals[3 * e + 1] = __fmul_rn(gt, py);
    vals[3 * e + 2] = gt;
  }
  vals[9] = __fmul_rn(dl_dw, alpha);
  const float w = __fmul_rn(alpha, zw);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) vals[10 + ch] = __fmul_rn(chan[ch], w);
}

// the sum over a warp's lanes, a fixed-order shuffle tree (lane 0 holds it)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace tds
