// The per-face arithmetic of the soft raster, shared by the single-group
// kernels (soft_raster.cu: B4a, B4b) and the grouped accumulator kernels
// (soft_accum.cu: B5a, B5b): the face's edge values, logistics and soft
// coverage at one pixel (the reference's ops/pallas_soft.py:_accumulate_face),
// the staging of a run of faces in shared memory, the 13 gradient terms
// of one face at one pixel (the bodies of _soft_bwd_kernel and
// _accum_bwd_kernel after their dl/dalpha), and the per-tile face cull all
// four kernels run first.
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

// --- the per-tile face cull of B4a, B4b, B5a and B5b ----------------------
//
// Their blocks each cover one 16 x 16 pixel tile (row-major over
// ceil(R / 16)^2 tiles) of one camera, one thread per pixel (px, py) =
// (row + 0.5, col + 0.5), the threads of a ragged last tile masked, and
// first list the faces that can reach the tile.
//
// Why skipping is exact. Per face and pixel, face_terms takes window =
// clamp(tmin + 4, 0, 1) and alpha = big_s * window. Where tmin <= -4 the
// window is exactly +0, so:
// - forward: alpha = +0, w = alpha * zw = +0 for every finite zw, so
//   n[ch] + w * color and d + w are unchanged bit for bit and t * (1 - 0)
//   equals t;
// - backward: the window's gradient mask (tmin > -4 && tmin < -3) is 0, so
//   all 13 gradient terms are products with alpha or with sw = 0, hence
//   +-0, and the prefix and suffix products see a factor of exactly 1;
// - grouped (B5a, B5b): a group with no surviving face in a tile gives
//   n_g = 0, d_g = 0, t_g = 1, so num + n_g, den + d_g, transp * t_g, S_g
//   and P_g are unchanged.
// So a block may skip any face one of whose edges has t_e <= -4 at every
// pixel of its tile, and no other face. t_e is affine, so its largest value
// over the tile is at one of the four extreme pixel centres. A face is
// skipped iff, for some edge e, in float64,
//   max over the corners of t_e <= -4 - delta_e,
//   delta_e = 2^-20 (|A_e| x_max + |B_e| y_max + |C_e|),
// with x_max, y_max the tile's largest pixel centres. delta covers the
// float32 rounding of affine() (two products and two sums, a few ulp of its
// largest term), so the float32 t_e is <= -4 at every pixel of a skipped
// tile, and then so is tmin, and __fadd_rn(tmin, 4) <= 0 (rounding is
// monotone). Conservative: a kept face may still add 0, a skipped one never
// adds anything. Zw is finite on every path (z >= 2 gives at most e^36);
// padding faces (zw 0, C = -1e9) are always skipped. The float64 arithmetic
// is spelled with round-to-nearest intrinsics, so the plain version
// (ops/soft.py: soft_tile_lists_reference) computes the same bits.

constexpr int kTile = 16;                       // pixels per side of a block
constexpr int kTileThreads = kTile * kTile;     // one thread per pixel
constexpr int kTileWarps = kTileThreads / 32;
constexpr double kSlack = 0x1p-20;              // delta_e per unit of |terms|

// the block's 16 x 16 pixel tile and this thread's pixel
struct Tile {
  int row, col;
  bool live;
  float px, py;
  double x_lo, x_hi, y_lo, y_hi;   // the tile's extreme pixel centres
};

__device__ __forceinline__ Tile block_tile(int res) {
  const int per_side = (res + kTile - 1) / kTile;
  const int row0 = (blockIdx.x / per_side) * kTile;
  const int col0 = (blockIdx.x % per_side) * kTile;
  Tile t;
  t.row = row0 + threadIdx.x / kTile;
  t.col = col0 + threadIdx.x % kTile;
  t.live = t.row < res && t.col < res;
  t.px = (float)t.row + 0.5f;
  t.py = (float)t.col + 0.5f;
  t.x_lo = (double)row0 + 0.5;
  t.x_hi = (double)min(row0 + kTile, res) - 0.5;
  t.y_lo = (double)col0 + 0.5;
  t.y_hi = (double)min(col0 + kTile, res) - 0.5;
  return t;
}

// false iff one edge of the face (coef[9]) is at most -4 - delta_e at every
// pixel centre of the tile (see above)
__device__ __forceinline__ bool face_reaches_tile(const float* c, const Tile& t) {
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const double a = c[3 * e], b = c[3 * e + 1], k = c[3 * e + 2];
    const double top = __dadd_rn(
        __dadd_rn(fmax(__dmul_rn(a, t.x_lo), __dmul_rn(a, t.x_hi)),
                  fmax(__dmul_rn(b, t.y_lo), __dmul_rn(b, t.y_hi))), k);
    const double delta = __dmul_rn(
        __dadd_rn(__dadd_rn(__dmul_rn(fabs(a), t.x_hi), __dmul_rn(fabs(b), t.y_hi)),
                  fabs(k)), kSlack);
    if (top <= __dsub_rn(-4.0, delta)) return false;
  }
  return true;
}

// The cull: the camera's faces that reach the tile, ascending, into list
// (global or shared memory), their count into *count_out unless it is null.
// Every thread of the block calls it, one face per thread per round of
// kTileThreads (ballot and prefix count, no atomics). Returns the count
// (the same in every thread); the list is visible to the whole block on
// return.
__device__ inline int list_tile_faces(const float* coef, size_t cam_first,
                                      int n_faces, const Tile& t, int* list,
                                      int* count_out, int* s_warp) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int count = 0;
  for (int base = 0; base < n_faces; base += kTileThreads) {
    const int f = base + threadIdx.x;
    const bool keep = f < n_faces && face_reaches_tile(coef + (cam_first + f) * 9, t);
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int at = count;
#pragma unroll
    for (int w = 0; w < kTileWarps; ++w) {
      if (w < warp) at += s_warp[w];
      count += s_warp[w];
    }
    if (keep) list[at + __popc(ballot & ((1u << lane) - 1u))] = f;
    __syncthreads();   // s_warp is rewritten by the next chunk
  }
  if (threadIdx.x == 0 && count_out != nullptr) *count_out = count;
  return count;
}

// the sum over a warp's lanes, a fixed-order shuffle tree (lane 0 holds it)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

}  // namespace tds
