// Bilinear background warp: each camera's float RGB view of the packed mip
// level, by the two-pass (Catmull-Smith) linear filter, straight from the
// camera poses (B3); and its pose VJP.
//
// Replaces the reference's TPU kernel ops/pallas_warp.py:_warp_bilinear_kernel
// (its per-camera body warp_view_bilinear), launched by
// warp_background_bilinear, together with the per-camera coefficient
// arithmetic the reference runs before it (warp_coefficients, now
// warp_coef.cuh); and the XLA backward of warp_background_diff
// (pallas_warp.py:638-673), which has no TPU kernel.
//
// Forward, per camera and output pixel (r, c) of a res x res view (res <=
// 128): each thread first builds its camera's coefficients from the pose
// (warp_coef.cuh: the window origin (oy, ox), the affine coefficients f[0:12]
// and the transpose flag of ops/warp.py:warp_coefficients), then
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
//     background color.
// The TPU kernel computes a 128 x 128 view and crops it; this one computes
// only the res x res pixels.
//
// VJP, per camera, from the saved view I and its cotangent g: per pixel the
// central differences dI/dr, dI/dc (one-sided at the edges, per channel),
// mapped to texel space through the inverse of [[a_y, b_y], [a_x, b_x]]
// (det = a_y*b_x - a_x*b_y, applied as a product by its float32 reciprocal:
// six IEEE divisions a pixel cost 1.4 of 6.9 us on an H100), cot_ty =
// sum_ch g * dI/dty and cot_tx alike,
// each times the forward's validity of the pixel; then the six sums S, R =
// sum cot * r, C = sum cot * c of each, and the closed form of the chain
// through ops/warp.py:sample_positions:
//   gxy = (S_x, S_y) / cell,
//   gsin = (mh0 S_y - m R_y) + lh (m C_x - mh0 S_x),
//   gcos = lh (mh0 S_y - m C_y) + (mh0 S_x - m R_x).
// One cluster of 8 blocks of 512 per camera (128 blocks at B = 16, where
// one block per camera left 116 of the 132 SMs idle: 0.0127 ms on an
// H100); each thread sums its pixels in float64, each block reduces in a
// fixed order (warp shuffle trees, then the warps' partials in warp order)
// into its shared memory, and the cluster's first block adds the eight
// blocks' sums in rank order through distributed shared memory, so the
// gradients repeat bit for bit; no atomics, no global scratch.
//
// Arithmetic: every float32 product, sum and difference is spelled with a
// round-to-nearest intrinsic so that nvcc cannot contract it into a fused
// multiply-add; the plain PyTorch versions (ops/warp.py: warp_coefficients
// with warp_view_bilinear_reference, and warp_bilinear_vjp_reference)
// perform the same operations in the same order, so the forward agrees bit
// for bit and the VJP's per-pixel cotangents too (its float64 sums to
// summation order).
//
// Bound: at the IL configuration (16 cameras, 64 x 64) the forward writes
// 16*3*64*64*4 B = 786 KB and reads the poses and under 1 MB of texture
// from L2: about 0.3 us of memory traffic, far below a launch; the VJP
// reads the view and its cotangent, 1.57 MB, about 0.5 us. Both sit near
// the launch floor; what this design changes is the work around them:
// warp_coefficients (68 device operations a frame on an H100) and the
// backward's PyTorch chain (118) become part of the two launches.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_coef.cuh"

namespace cg = cooperative_groups;

namespace {

using tds::TexAffine;
using tds::WarpCoef;
using tds::WarpPose;

constexpr int kWinRows = 128;
constexpr int kWindow = 256;
constexpr int kThreads = 256;
constexpr int kVjpThreads = 512;
constexpr int kVjpBlocks = 8;   // blocks (one cluster) per camera in the VJP
// float32(1 / 255), the reference's per-channel scale
constexpr float kInv255 = 0x1.010102p-8f;

// The (B, 2) pose tensors with their element strides (a camera's xy may be
// a slice of the agent state).
struct Poses {
  const float* xy;
  const float* sc;
  int xy_s0, xy_s1, sc_s0, sc_s1;

  __device__ __forceinline__ void load(int cam, float& x, float& y, float& sn,
                                       float& cs) const {
    x = __ldg(xy + (size_t)cam * xy_s0);
    y = __ldg(xy + (size_t)cam * xy_s0 + xy_s1);
    sn = __ldg(sc + (size_t)cam * sc_s0);
    cs = __ldg(sc + (size_t)cam * sc_s0 + sc_s1);
  }
};

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
warp_bilinear_kernel(const int* __restrict__ tex,       // (tex_h, tex_w)
                     int tex_h, int tex_w, Poses poses,
                     const float* __restrict__ bg,      // (3,)
                     WarpPose pose, int res,
                     float* __restrict__ out) {         // (B, 3, res, res)
  const int cam = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= res * res) return;
  float x, y, sn, cs;
  poses.load(cam, x, y, sn, cs);
  const WarpCoef k = tds::warp_coefficients(pose, x, y, sn, cs, tex_h, tex_w, bg);
  const float* f = k.f;
  const int oy = k.oy, ox = k.ox;
  const bool flip = k.flip;

  const int r = pix / res;
  const int c = pix % res;
  const float fr = (float)r;
  const float fc = (float)c;
  const float k_hi = flip ? (float)(kWindow - 2) : (float)(kWinRows - 2);
  const float j_hi = flip ? (float)(kWinRows - 2) : (float)(kWindow - 2);

  const float v = affine(f[0], fr, f[1], fc, f[2]);
  const float k0 = clampf(floorf(v), 0.0f, k_hi);
  const float fv = clampf(__fsub_rn(v, k0), 0.0f, 1.0f);

  float pass1[2][3];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const float kk = __fadd_rn(k0, (float)t);
    const float h = affine(f[3], kk, f[4], fc, f[5]);
    const float j0 = clampf(floorf(h), 0.0f, j_hi);
    const float fh = clampf(__fsub_rn(h, j0), 0.0f, 1.0f);
    const int ki = (int)kk;
    const int ji = (int)j0;
    const int row0 = oy + (flip ? ji : ki);
    const int col0 = ox + (flip ? ki : ji);
    const int row1 = oy + (flip ? ji + 1 : ki);
    const int col1 = ox + (flip ? ki : ji + 1);
    // the window lies inside the padded level by construction; the clamps
    // only keep malformed poses from reading outside it
    const int t0 = __ldg(tex + (size_t)min(max(row0, 0), tex_h - 1) * tex_w
                         + min(max(col0, 0), tex_w - 1));
    const int t1 = __ldg(tex + (size_t)min(max(row1, 0), tex_h - 1) * tex_w
                         + min(max(col1, 0), tex_w - 1));
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      pass1[t][ch] = lerp(channel(t0, ch), channel(t1, ch), fh);
  }

  const float ty = affine(f[6], fr, f[7], fc, f[8]);
  const float tx = affine(f[9], fr, f[10], fc, f[11]);
  const bool valid = ty >= 0.0f && ty < f[12] && tx >= 0.0f && tx < f[13];
  const size_t plane = (size_t)res * res;
  float* o = out + (size_t)cam * 3 * plane + pix;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    o[ch * plane] = valid ? lerp(pass1[0][ch], pass1[1][ch], fv)
                          : channel(k.bg_packed, ch);
}

// ops/warp.py:_central_differences at index i of n along a line of stride
// ``step``: the central difference, one-sided at the two ends.
__device__ __forceinline__ float central_difference(const float* __restrict__ p,
                                                    int i, int n, int step) {
  const int lo = i == 0 ? 0 : i - 1;
  const int hi = i == n - 1 ? n - 1 : i + 1;
  const float d = __fsub_rn(__ldg(p + hi * step), __ldg(p + lo * step));
  return (i == 0 || i == n - 1) ? d : __fmul_rn(d, 0.5f);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// One cluster of kVjpBlocks blocks per camera: block ``rank`` of the
// cluster takes pixels rank * kVjpThreads + t, t + kVjpBlocks * kVjpThreads,
// ..., and leaves its six sums in its shared memory; block 0 reads the
// others' through the cluster's distributed shared memory, in rank order.
__global__ void __cluster_dims__(kVjpBlocks, 1, 1) __launch_bounds__(kVjpThreads)
warp_bilinear_vjp_kernel(const float* __restrict__ out,   // (B, 3, res, res)
                         const float* __restrict__ g,     // (B, 3, res, res)
                         Poses poses, WarpPose pose, int res,
                         float* __restrict__ gxy,         // (B, 2)
                         float* __restrict__ gsc) {       // (B, 2)
  __shared__ double warp_part[kVjpThreads / 32][6];
  __shared__ double block_part[6];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cam = blockIdx.y;
  float x, y, sn, cs;
  poses.load(cam, x, y, sn, cs);
  const TexAffine t = tds::texture_affine(pose, x, y, sn, cs);
  const float det = __fsub_rn(__fmul_rn(t.a_y, t.b_x), __fmul_rn(t.a_x, t.b_y));
  const float inv_det = __fdiv_rn(1.0f, det);
  const int plane = res * res;
  const float* img = out + (size_t)cam * 3 * plane;
  const float* cot = g + (size_t)cam * 3 * plane;

  // S_y, R_y, C_y, S_x, R_x, C_x of this thread's pixels
  double s[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int pix = rank * kVjpThreads + threadIdx.x; pix < plane;
       pix += kVjpBlocks * kVjpThreads) {
    const int r = pix / res;
    const int c = pix % res;
    float cty = 0.0f, ctx = 0.0f;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* p = img + ch * plane;
      const float d_dr = central_difference(p + c, r, res, res);
      const float d_dc = central_difference(p + r * res, c, res, 1);
      const float d_dty = __fmul_rn(
          __fsub_rn(__fmul_rn(d_dr, t.b_x), __fmul_rn(d_dc, t.a_x)), inv_det);
      const float d_dtx = __fmul_rn(
          __fsub_rn(__fmul_rn(d_dc, t.a_y), __fmul_rn(d_dr, t.b_y)), inv_det);
      const float gv = __ldg(cot + ch * plane + pix);
      const float py = __fmul_rn(gv, d_dty);
      const float px = __fmul_rn(gv, d_dtx);
      cty = ch == 0 ? py : __fadd_rn(cty, py);
      ctx = ch == 0 ? px : __fadd_rn(ctx, px);
    }
    const float fr = (float)r;
    const float fc = (float)c;
    const float ty = affine(t.a_y, fr, t.b_y, fc, t.e_y);
    const float tx = affine(t.a_x, fr, t.b_x, fc, t.e_x);
    const float ok = (ty >= 0.0f && ty < pose.h_tex && tx >= 0.0f && tx < pose.w_tex)
                         ? 1.0f : 0.0f;
    const double vy = (double)__fmul_rn(cty, ok);
    const double vx = (double)__fmul_rn(ctx, ok);
    s[0] += vy;
    s[1] += vy * (double)r;
    s[2] += vy * (double)c;
    s[3] += vx;
    s[4] += vx * (double)r;
    s[5] += vx * (double)c;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const double v = warp_sum(s[k]);
    if (lane == 0) warp_part[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    double v = 0.0;
    for (int w = 0; w < kVjpThreads / 32; ++w) v += warp_part[w][threadIdx.x];
    block_part[threadIdx.x] = v;
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    double sum[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int b = 0; b < kVjpBlocks; ++b) {
      const double* part = cluster.map_shared_rank(block_part, b);
#pragma unroll
      for (int k = 0; k < 6; ++k) sum[k] += part[k];
    }
    const double sy = sum[0], ry = sum[1], cy = sum[2];
    const double sx = sum[3], rx = sum[4], cx = sum[5];
    const double m = pose.m, mh0 = pose.mh0, lh = pose.lh, cell = pose.cell;
    gxy[2 * cam] = (float)(sx / cell);
    gxy[2 * cam + 1] = (float)(sy / cell);
    gsc[2 * cam] = (float)((mh0 * sy - m * ry) + lh * (m * cx - mh0 * sx));
    gsc[2 * cam + 1] = (float)(lh * (mh0 * sy - m * cy) + (mh0 * sx - m * rx));
  }
  // the others' shared memory must outlive block 0's reads
  cluster.sync();
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success); neither synchronizes.

// The forward: the texture (tex_h, tex_w) int32; the (B, 2) poses cam_xy
// and cam_sc with their element strides; the background colour (3,) float32;
// the host-side float32 constants of warp_coef.cuh:WarpPose; batch, res and
// the (B, 3, res, res) float32 output.
extern "C" int tds_warp_bilinear_pose(
    const int* tex, int tex_h, int tex_w, const float* cam_xy, int xy_s0,
    int xy_s1, const float* cam_sc, int sc_s0, int sc_s1, const float* bg,
    float m, float mh0, float origin_x, float origin_y, float cell, float lh,
    float h_tex, float w_tex, int batch, int res, void* out, void* stream) {
  const Poses poses{cam_xy, cam_sc, xy_s0, xy_s1, sc_s0, sc_s1};
  const WarpPose pose{m, mh0, origin_x, origin_y, cell, lh, h_tex, w_tex};
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  warp_bilinear_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tex, tex_h, tex_w, poses, bg, pose, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The pose VJP: the saved (B, 3, res, res) view and its cotangent, both
// contiguous float32; the poses and constants as above; batch and res; the
// (B, 2) float32 outputs gxy and gsc.
extern "C" int tds_warp_bilinear_vjp(
    const float* out, const float* g, const float* cam_xy, int xy_s0,
    int xy_s1, const float* cam_sc, int sc_s0, int sc_s1, float m, float mh0,
    float origin_x, float origin_y, float cell, float lh, float h_tex,
    float w_tex, int batch, int res, void* gxy, void* gsc, void* stream) {
  const Poses poses{cam_xy, cam_sc, xy_s0, xy_s1, sc_s0, sc_s1};
  const WarpPose pose{m, mh0, origin_x, origin_y, cell, lh, h_tex, w_tex};
  warp_bilinear_vjp_kernel<<<dim3(kVjpBlocks, batch), kVjpThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      out, g, poses, pose, res, static_cast<float*>(gxy), static_cast<float*>(gsc));
  return (int)cudaGetLastError();
}
