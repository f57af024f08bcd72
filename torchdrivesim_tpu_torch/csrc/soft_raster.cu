// Differentiable (softmax-blend) soft rasterization of up to 128 faces per
// camera over a background: the forward kernel and its recompute backward.
//
// Replaces the reference's TPU kernels ops/pallas_soft.py:_soft_fwd_kernel
// (launched by _pallas_soft_fwd) and _soft_bwd_kernel (launched by
// _pallas_soft_bwd), the single-group path of rasterize_softmax_pallas.
// Their custom-VJP boundary is kept: the operands are the per-face edge
// coefficients coef (B, F, 3, 3) [face, edge, (A, B, C)], the z weights
// zw (B, 1, F), the colors (B, F, 3) and the background (B, 3, R, R).
//
// Forward, per camera and pixel (px, py) = (row + 0.5, col + 0.5), faces in
// ascending order (the reference's sum order):
//   t_e = A_e*px + B_e*py + C_e; s_e = 1 / (1 + exp(-clip(t_e, -30, 30)));
//   alpha = s_0*s_1*s_2 * clip(min_e t_e + 4, 0, 1); w = alpha * zw;
//   num += w * color; den += w; transp *= 1 - alpha;
//   out = (1 - transp) * num / max(den, 1e-8) + transp * bg.
// Backward: pass 1 repeats the forward and keeps each face's alpha and its
// exclusive prefix product prod_{g<f} (1 - alpha_g) per pixel (never by
// division: a face that covers a pixel fully has 1 - alpha == 0); pass 2
// walks the faces in descending order with a running suffix product and
// forms the 13 per-face gradient terms of the reference (gA, gB, gC per
// edge, gzw, gcolor) per pixel, plus gbg = g * transp.
//
// Reduction: the blocks of one camera run in parallel, so each block writes
// deterministic partial sums, (B, tiles, F, 13): a fixed-order warp shuffle
// tree, then the warps' partials added in warp order. The wrapper finishes
// with one sum over tiles (the counterpart of the reference's XLA sum over
// its per-lane partial rows). No atomics, so gradients repeat bit for bit.
//
// Arithmetic: products and sums use round-to-nearest intrinsics, so nvcc
// cannot contract them into fused multiply-adds, and the logistic is
// __frcp_rn(1 + expf(-t)) with the accurate expf; the plain PyTorch versions
// (ops/soft.py) perform the same operations, so the forward and gbg agree
// with them bit for bit and the reduced sums to summation order. The
// per-face terms, the face staging and the gradient terms live in
// soft_face.cuh, shared with the grouped kernels (soft_accum.cu).
//
// Bound: per face and pixel the forward evaluates 3 exp and 3 reciprocals
// on the special-function units. At the IL configuration (16 cameras,
// 64 x 64, 24 faces) that is 9.4 M SFU operations, ~2.2 us at the card's
// SFU rate, against 1.6 MB of traffic (~0.5 us); the backward does twice the
// transcendental work plus 13 reductions per face. One thread per pixel,
// the camera's face table (13 floats a face) in shared memory; the
// backward keeps alpha and the prefix product in shared memory columns
// [face][thread], so neighbouring threads hit neighbouring banks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_face.cuh"

namespace {

using namespace tds;

constexpr int kMaxFaces = 128;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
soft_fwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                const float* __restrict__ color, const float* __restrict__ bg,
                int n_faces, int res, float* __restrict__ out) {
  extern __shared__ float s_face[];
  const int cam = blockIdx.y;
  load_faces(coef, zw, color, (size_t)cam * n_faces, n_faces, s_face);
  __syncthreads();

  const int npix = res * res;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= npix) return;
  const float px = (float)(pix / res) + 0.5f;
  const float py = (float)(pix % res) + 0.5f;

  float num[3] = {0.0f, 0.0f, 0.0f};
  float den = 0.0f;
  float transp = 1.0f;
  for (int f = 0; f < n_faces; ++f) {
    const float* fc = s_face + f * kFaceFloats;
    const FaceTerms ft = face_terms(fc, px, py);
    const float w = __fmul_rn(ft.alpha, fc[9]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      num[ch] = __fadd_rn(num[ch], __fmul_rn(w, fc[10 + ch]));
    den = __fadd_rn(den, w);
    transp = __fmul_rn(transp, __fsub_rn(1.0f, ft.alpha));
  }
  const float inv_den = __frcp_rn(fmaxf(den, 1e-8f));
  const float cover = __fsub_rn(1.0f, transp);
  const size_t plane = (size_t)npix;
  const float* b = bg + (size_t)cam * 3 * plane + pix;
  float* o = out + (size_t)cam * 3 * plane + pix;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    o[ch * plane] = __fadd_rn(__fmul_rn(cover, __fmul_rn(num[ch], inv_den)),
                              __fmul_rn(transp, b[ch * plane]));
}

__global__ void __launch_bounds__(kThreads)
soft_bwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                const float* __restrict__ color, const float* __restrict__ bg,
                const float* __restrict__ g, int n_faces, int res,
                float* __restrict__ partial,     // (B, tiles, F, 13)
                float* __restrict__ gbg) {       // (B, 3, R, R)
  extern __shared__ float smem[];
  float* s_face = smem;                                  // F * 13
  float* s_alpha = s_face + n_faces * kFaceFloats;       // F * kThreads
  float* s_prefix = s_alpha + n_faces * kThreads;        // F * kThreads
  float* s_red = s_prefix + n_faces * kThreads;          // kWarps * F * 13
  const int cam = blockIdx.y;
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  load_faces(coef, zw, color, (size_t)cam * n_faces, n_faces, s_face);
  __syncthreads();

  const int npix = res * res;
  const int pix = tile * blockDim.x + tid;
  const bool live = pix < npix;
  const int pix_c = live ? pix : 0;
  const float px = (float)(pix_c / res) + 0.5f;
  const float py = (float)(pix_c % res) + 0.5f;
  const size_t plane = (size_t)npix;
  const size_t cam_off = (size_t)cam * 3 * plane + pix_c;

  // pass 1: alphas, exclusive prefix products, accumulators
  float num[3] = {0.0f, 0.0f, 0.0f};
  float den = 0.0f;
  float transp = 1.0f;
  for (int f = 0; f < n_faces; ++f) {
    const float* fc = s_face + f * kFaceFloats;
    const FaceTerms ft = face_terms(fc, px, py);
    s_alpha[f * kThreads + tid] = ft.alpha;
    s_prefix[f * kThreads + tid] = transp;
    const float w = __fmul_rn(ft.alpha, fc[9]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      num[ch] = __fadd_rn(num[ch], __fmul_rn(w, fc[10 + ch]));
    den = __fadd_rn(den, w);
    transp = __fmul_rn(transp, __fsub_rn(1.0f, ft.alpha));
  }

  // the num-gradient always flows through 1/D, the den-gradient only where
  // den > eps (the derivative of max(den, eps))
  const float dmask = den > 1e-8f ? 1.0f : 0.0f;
  const float inv_den = __frcp_rn(fmaxf(den, 1e-8f));
  const float cover = __fsub_rn(1.0f, transp);
  float dl_da = 0.0f;
  float q = 0.0f;
  float p[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float gc = live ? g[cam_off + ch * plane] : 0.0f;
    const float bc = live ? bg[cam_off + ch * plane] : 0.0f;
    const float cface = __fmul_rn(num[ch], inv_den);
    dl_da = __fadd_rn(dl_da, __fmul_rn(gc, __fsub_rn(cface, bc)));
    p[ch] = __fmul_rn(__fmul_rn(gc, cover), inv_den);
    q = __fsub_rn(q, __fmul_rn(__fmul_rn(p[ch], cface), dmask));
    if (live) gbg[cam_off + ch * plane] = __fmul_rn(gc, transp);
  }

  // pass 2: descending faces, running suffix product, per-face sums
  const int warp = tid / 32;
  const int lane = tid % 32;
  float suffix = 1.0f;
  for (int f = n_faces - 1; f >= 0; --f) {
    const float* fc = s_face + f * kFaceFloats;
    const float alpha = s_alpha[f * kThreads + tid];
    const float except_f = __fmul_rn(s_prefix[f * kThreads + tid], suffix);
    suffix = __fmul_rn(suffix, __fsub_rn(1.0f, alpha));
    const float dl_dw = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(p[0], fc[10]), __fmul_rn(p[1], fc[11])),
                  __fmul_rn(p[2], fc[12])), q);
    const float dl_dalpha = __fadd_rn(__fmul_rn(fc[9], dl_dw),
                                      __fmul_rn(dl_da, except_f));
    const FaceTerms ft = face_terms(fc, px, py);
    float vals[kFaceFloats];
    face_grad_terms(ft, alpha, dl_dalpha, dl_dw, p, fc[9], px, py, vals);
#pragma unroll
    for (int k = 0; k < kFaceFloats; ++k) {
      const float v = warp_sum(live ? vals[k] : 0.0f);
      if (lane == 0) s_red[(warp * n_faces + f) * kFaceFloats + k] = v;
    }
  }
  __syncthreads();

  const int per_warp = n_faces * kFaceFloats;
  float* out = partial + ((size_t)cam * gridDim.x + tile) * per_warp;
  for (int i = tid; i < per_warp; i += blockDim.x) {
    float acc = s_red[i];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) acc = __fadd_rn(acc, s_red[wi * per_warp + i]);
    out[i] = acc;
  }
}

size_t bwd_smem_bytes(int n_faces) {
  return sizeof(float) * ((size_t)n_faces * kFaceFloats
                          + 2 * (size_t)n_faces * kThreads
                          + (size_t)kWarps * n_faces * kFaceFloats);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// more than 128 faces; neither synchronizes.
extern "C" int tds_soft_raster_fwd(const float* coef, const float* zw,
                                   const float* color, const float* bg,
                                   int batch, int n_faces, int res, void* out,
                                   void* stream) {
  if (n_faces < 1 || n_faces > kMaxFaces) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)n_faces * kFaceFloats;
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  soft_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, bg, n_faces, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int tds_soft_raster_bwd(const float* coef, const float* zw,
                                   const float* color, const float* bg,
                                   const float* g, int batch, int n_faces,
                                   int res, void* partial, void* gbg,
                                   void* stream) {
  if (n_faces < 1 || n_faces > kMaxFaces) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(n_faces);
  cudaError_t err = cudaFuncSetAttribute(
      soft_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  soft_bwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, bg, g, n_faces, res, static_cast<float*>(partial),
      static_cast<float*>(gbg));
  return (int)cudaGetLastError();
}
