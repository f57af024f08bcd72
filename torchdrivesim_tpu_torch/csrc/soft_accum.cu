// The grouped soft raster's accumulators over any number of faces: the
// forward (B5a) and its recompute backward (B5b), each ONE launch per render
// covering every face group.
//
// Replaces the reference's TPU kernels ops/pallas_soft.py:_accum_fwd_kernel
// (launched by _pallas_accum_fwd) and _accum_bwd_kernel (launched by
// _pallas_accum_bwd), which rasterize_softmax_pallas calls once per
// 128-face group behind a custom VJP, combining the groups in XLA
// (num = num + n_g, den = den + d_g, transp = transp * t_g for g = 0, 1, ...).
// Here one launch loops over the groups inside each block and combines them
// in that order, so the totals equal the reference's group-by-group sums.
// Operands: the faces padded to whole groups (padding rows have coefficients
// 0 except C = -1e9, zw 0, color 0, so their alpha is exactly 0):
// coef (B, F, 3, 3), zw (B, 1, F), color (B, F, 3), F a multiple of the
// group size (at most 128).
//
// Forward, per camera and pixel (px, py) = (row + 0.5, col + 0.5): each
// group's partials start from num 0, den 0, transp 1 and take its faces in
// ascending order (soft_face.cuh: face_terms); the totals combine as above.
// Outputs num (B, 3, R, R), den (B, R, R), transp (B, R, R).
//
// Backward, for the cotangents gnum, gden, gtransp of the three totals:
// every group receives gnum and gden, and the cotangent of its t_g,
//   gtr_g = P_g * S_g,  P_g = t_0 * ... * t_{g-1} (the forward's running
//   transp before g), S_{G-1} = gtransp, S_g = S_{g+1} * t_{g+1},
// the order in which the reference's autodiff of transp = transp * t_g
// forms it. Pass 1 recomputes every t_g of the block's pixels into a
// wrapper-allocated scratch (B, G, R*R), then walks it downwards replacing
// t_g by S_g. Pass 2 takes the groups in order: the group's exclusive prefix
// products in ascending order into shared memory (never by division: a face
// that covers a pixel fully has 1 - alpha == 0), then its faces in
// descending order with a running suffix product, forming the 13 gradient
// terms per face of _accum_bwd_kernel with dl/dalpha = zw * dl/dw -
// gtr_g * prod_{f' != f} (1 - alpha_f').
//
// Reduction: the blocks of one camera run in parallel, so each block writes
// deterministic partial sums, (B, tiles, F, 13): a fixed-order warp shuffle
// tree, then the warps' partials added in warp order. The wrapper finishes
// with one sum over tiles. No atomics, so gradients repeat bit for bit.
//
// Bound: per (pixel, face) the forward evaluates 3 exp and 3 reciprocals on
// the special-function units and ~40 float32 operations; the backward
// evaluates the face terms three times (pass 1, prefix, suffix). Every
// block tests every face: at the Town02 road mesh (~17,000 faces, 133
// groups) most faces are far outside the view, where tmin <= -4 makes
// their contribution exactly 0; skipping those per pixel tile is the next
// speed step. One thread per pixel; the group's face table (13 floats a
// face) in shared memory; the prefix products in shared memory columns
// [face][thread], so neighbouring threads hit neighbouring banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_face.cuh"

namespace {

using namespace tds;

constexpr int kMaxGroup = 128;
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;
constexpr int kBwdWarps = kBwdThreads / 32;

__global__ void __launch_bounds__(kFwdThreads)
accum_fwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                 const float* __restrict__ color, int n_faces, int group,
                 int res, float* __restrict__ num, float* __restrict__ den,
                 float* __restrict__ transp) {
  __shared__ float s_face[kMaxGroup * kFaceFloats];
  const int cam = blockIdx.y;
  const int npix = res * res;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = pix < npix;
  const int pix_c = live ? pix : 0;
  const float px = (float)(pix_c / res) + 0.5f;
  const float py = (float)(pix_c % res) + 0.5f;

  float tot_num[3] = {0.0f, 0.0f, 0.0f};
  float tot_den = 0.0f;
  float tot_transp = 1.0f;
  for (int first = 0; first < n_faces; first += group) {
    __syncthreads();   // every thread is done with the previous group
    load_faces(coef, zw, color, (size_t)cam * n_faces + first, group, s_face);
    __syncthreads();
    float n[3] = {0.0f, 0.0f, 0.0f};
    float d = 0.0f;
    float t = 1.0f;
    for (int f = 0; f < group; ++f) {
      const float* fc = s_face + f * kFaceFloats;
      const FaceTerms ft = face_terms(fc, px, py);
      const float w = __fmul_rn(ft.alpha, fc[9]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        n[ch] = __fadd_rn(n[ch], __fmul_rn(w, fc[10 + ch]));
      d = __fadd_rn(d, w);
      t = __fmul_rn(t, __fsub_rn(1.0f, ft.alpha));
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) tot_num[ch] = __fadd_rn(tot_num[ch], n[ch]);
    tot_den = __fadd_rn(tot_den, d);
    tot_transp = __fmul_rn(tot_transp, t);
  }
  if (!live) return;
  const size_t plane = (size_t)npix;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    num[((size_t)cam * 3 + ch) * plane + pix] = tot_num[ch];
  den[(size_t)cam * plane + pix] = tot_den;
  transp[(size_t)cam * plane + pix] = tot_transp;
}

__global__ void __launch_bounds__(kBwdThreads)
accum_bwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                 const float* __restrict__ color,
                 const float* __restrict__ gnum,     // (B, 3, R, R)
                 const float* __restrict__ gden,     // (B, R, R)
                 const float* __restrict__ gtransp,  // (B, R, R)
                 int n_faces, int group, int res,
                 float* __restrict__ scratch,        // (B, G, R, R)
                 float* __restrict__ partial) {      // (B, tiles, F, 13)
  extern __shared__ float smem[];
  float* s_face = smem;                                  // group * 13
  float* s_prefix = s_face + group * kFaceFloats;        // group * kBwdThreads
  float* s_red = s_prefix + group * kBwdThreads;         // kBwdWarps * group * 13
  const int cam = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_groups = n_faces / group;
  const int npix = res * res;
  const int pix = tile * blockDim.x + tid;
  const bool live = pix < npix;
  const int pix_c = live ? pix : 0;
  const float px = (float)(pix_c / res) + 0.5f;
  const float py = (float)(pix_c % res) + 0.5f;
  const size_t plane = (size_t)npix;
  // this pixel's slot of group 0; group g is g * plane further
  float* slot = scratch + (size_t)cam * n_groups * plane + pix_c;

  // pass 1: every group's transparency t_g at this pixel
  for (int g = 0; g < n_groups; ++g) {
    __syncthreads();
    load_faces(coef, zw, color, (size_t)cam * n_faces + (size_t)g * group,
               group, s_face);
    __syncthreads();
    float t = 1.0f;
    for (int f = 0; f < group; ++f) {
      const FaceTerms ft = face_terms(s_face + f * kFaceFloats, px, py);
      t = __fmul_rn(t, __fsub_rn(1.0f, ft.alpha));
    }
    if (live) slot[(size_t)g * plane] = t;
  }

  float gch[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    gch[ch] = live ? gnum[((size_t)cam * 3 + ch) * plane + pix] : 0.0f;
  const float gd = live ? gden[(size_t)cam * plane + pix] : 0.0f;
  // the cotangent carried down the product chain: slot g takes S_g
  if (live) {
    float carried = gtransp[(size_t)cam * plane + pix];
    for (int g = n_groups - 1; g >= 0; --g) {
      const float t = slot[(size_t)g * plane];
      slot[(size_t)g * plane] = carried;
      carried = __fmul_rn(carried, t);
    }
  }

  // pass 2: per group, prefix products, then descending faces
  float running = 1.0f;   // P_g
  for (int g = 0; g < n_groups; ++g) {
    __syncthreads();   // s_face and s_red of the previous group are read
    load_faces(coef, zw, color, (size_t)cam * n_faces + (size_t)g * group,
               group, s_face);
    __syncthreads();
    const float gtr = live ? __fmul_rn(running, slot[(size_t)g * plane]) : 0.0f;
    float t = 1.0f;
    for (int f = 0; f < group; ++f) {
      const FaceTerms ft = face_terms(s_face + f * kFaceFloats, px, py);
      s_prefix[f * kBwdThreads + tid] = t;
      t = __fmul_rn(t, __fsub_rn(1.0f, ft.alpha));
    }
    float suffix = 1.0f;
    for (int f = group - 1; f >= 0; --f) {
      const float* fc = s_face + f * kFaceFloats;
      const FaceTerms ft = face_terms(fc, px, py);
      const float except_f = __fmul_rn(s_prefix[f * kBwdThreads + tid], suffix);
      suffix = __fmul_rn(suffix, __fsub_rn(1.0f, ft.alpha));
      const float dl_dw = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(gch[0], fc[10]), __fmul_rn(gch[1], fc[11])),
                    __fmul_rn(gch[2], fc[12])), gd);
      // d transp_g / d alpha_f = -prod_{f' != f} (1 - alpha_f')
      const float dl_dalpha = __fsub_rn(__fmul_rn(fc[9], dl_dw),
                                        __fmul_rn(gtr, except_f));
      float vals[kFaceFloats];
      face_grad_terms(ft, ft.alpha, dl_dalpha, dl_dw, gch, fc[9], px, py, vals);
#pragma unroll
      for (int k = 0; k < kFaceFloats; ++k) {
        const float v = warp_sum(live ? vals[k] : 0.0f);
        if (lane == 0) s_red[(warp * group + f) * kFaceFloats + k] = v;
      }
    }
    __syncthreads();
    const int per_warp = group * kFaceFloats;
    float* out = partial + ((size_t)cam * gridDim.x + tile) * n_faces * kFaceFloats
        + (size_t)g * per_warp;
    for (int i = tid; i < per_warp; i += blockDim.x) {
      float acc = s_red[i];
#pragma unroll
      for (int wi = 1; wi < kBwdWarps; ++wi)
        acc = __fadd_rn(acc, s_red[wi * per_warp + i]);
      out[i] = acc;
    }
    running = __fmul_rn(running, t);
  }
}

size_t bwd_smem_bytes(int group) {
  return sizeof(float) * ((size_t)group * kFaceFloats
                          + (size_t)group * kBwdThreads
                          + (size_t)kBwdWarps * group * kFaceFloats);
}

bool bad_shape(int batch, int n_faces, int group, int res) {
  return group < 1 || group > kMaxGroup || n_faces < group
      || n_faces % group != 0 || res < 1 || batch < 1 || batch > 65535;
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// group size outside 1..128 or a face count that is not a whole number of
// groups; neither synchronizes. The backward needs scratch (B, F / group,
// R, R) and partial (B, ceil(R * R / 256), F, 13) float32 buffers.
extern "C" int tds_soft_accum_fwd(const float* coef, const float* zw,
                                  const float* color, int batch, int n_faces,
                                  int group, int res, void* num, void* den,
                                  void* transp, void* stream) {
  if (bad_shape(batch, n_faces, group, res)) return (int)cudaErrorInvalidValue;
  dim3 grid((res * res + kFwdThreads - 1) / kFwdThreads, batch);
  accum_fwd_kernel<<<grid, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, n_faces, group, res, static_cast<float*>(num),
      static_cast<float*>(den), static_cast<float*>(transp));
  return (int)cudaGetLastError();
}

extern "C" int tds_soft_accum_bwd(const float* coef, const float* zw,
                                  const float* color, const float* gnum,
                                  const float* gden, const float* gtransp,
                                  int batch, int n_faces, int group, int res,
                                  void* scratch, void* partial, void* stream) {
  if (bad_shape(batch, n_faces, group, res)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(group);
  cudaError_t err = cudaFuncSetAttribute(
      accum_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((res * res + kBwdThreads - 1) / kBwdThreads, batch);
  accum_bwd_kernel<<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, gnum, gden, gtransp, n_faces, group, res,
      static_cast<float*>(scratch), static_cast<float*>(partial));
  return (int)cudaGetLastError();
}
