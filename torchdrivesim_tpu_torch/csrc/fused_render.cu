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
//     chunk occupancy bit is set (starts at the sentinel 0x7FFFFFFF);
//   * background: the texel the reference's two-pass warp picks -- row index
//     v rounded first, column index h evaluated at the INTEGER v -- computed
//     in one pass per pixel; on this card a gather from the L2-resident mip
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
// and the band's mask bits are staged in shared memory; each thread walks
// the band's pixels with a block-wide stride, so neighbouring threads store
// neighbouring columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 8;
constexpr int kWinRows = 128;
constexpr int kWindow = 256;
constexpr int kSentinel = 0x7FFFFFFF;
constexpr int kCoveredBelow = 127 << 24;
// float32(1 / 255), the reference's per-channel scale
constexpr float kInv255 = 0x1.010102p-8f;
constexpr int kThreads = 256;

__device__ __forceinline__ float affine(float a, float x, float b, float y,
                                        float c) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y)), c);
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.0f), hi);
}

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
  const int n_bands = gridDim.x;
  const int cam = blockIdx.y;
  const int cq = qp / kChunk;
  const int ct = tp / kChunk;

  extern __shared__ float smem[];
  float* s_qcoef = smem;                         // 6 * qp
  float* s_tcoef = s_qcoef + 6 * qp;             // 9 * tp
  float* s_fcoef = s_tcoef + 9 * tp;             // 14
  int* s_qpk = reinterpret_cast<int*>(s_fcoef + 14);   // qp
  int* s_tpk = s_qpk + qp;                       // tp
  int* s_qm = s_tpk + tp;                        // cq
  int* s_tm = s_qm + cq;                         // ct
  int* s_icoef = s_tm + ct;                      // 4

  for (int i = threadIdx.x; i < 6 * qp; i += blockDim.x)
    s_qcoef[i] = qcoef[(size_t)cam * 6 * qp + i];
  for (int i = threadIdx.x; i < 9 * tp; i += blockDim.x)
    s_tcoef[i] = tcoef[(size_t)cam * 9 * tp + i];
  for (int i = threadIdx.x; i < qp; i += blockDim.x)
    s_qpk[i] = qpk[(size_t)cam * qp + i];
  for (int i = threadIdx.x; i < tp; i += blockDim.x)
    s_tpk[i] = tpk[(size_t)cam * tp + i];
  for (int i = threadIdx.x; i < cq; i += blockDim.x)
    s_qm[i] = qmask[((size_t)cam * n_bands + band) * cq + i];
  for (int i = threadIdx.x; i < ct; i += blockDim.x)
    s_tm[i] = tmask[((size_t)cam * n_bands + band) * ct + i];
  if (threadIdx.x < 14) s_fcoef[threadIdx.x] = fcoef[cam * 14 + threadIdx.x];
  if (threadIdx.x < 4) s_icoef[threadIdx.x] = icoef[cam * 4 + threadIdx.x];
  __syncthreads();

  const float va = s_fcoef[0], vb = s_fcoef[1], vc = s_fcoef[2];
  const float ha = s_fcoef[3], hb = s_fcoef[4], hc = s_fcoef[5];
  const float ty_a = s_fcoef[6], ty_b = s_fcoef[7], ty_c = s_fcoef[8];
  const float tx_a = s_fcoef[9], tx_b = s_fcoef[10], tx_c = s_fcoef[11];
  const float h_tex = s_fcoef[12], w_tex = s_fcoef[13];
  const int oy = s_icoef[0], ox = s_icoef[1];
  const bool flip = s_icoef[2] == 1;
  const int bg_packed = s_icoef[3];
  const float v_hi = flip ? (float)(kWindow - 1) : (float)(kWinRows - 1);
  const float h_hi = flip ? (float)(kWinRows - 1) : (float)(kWindow - 1);
  const size_t plane = (size_t)res * res;

  for (int idx = threadIdx.x; idx < rpb * res; idx += blockDim.x) {
    const int r = band * rpb + idx / res;
    const int c = idx % res;
    const float px = (float)r + 0.5f;
    const float py = (float)c + 0.5f;

    int best = kSentinel;
    for (int ci = 0; ci < cq; ++ci) {
      if (s_qm[ci] == 0) continue;
      for (int p = ci * kChunk; p < (ci + 1) * kChunk; ++p) {
        const float* k0 = s_qcoef + p * 3;
        const float* k1 = s_qcoef + (qp + p) * 3;
        const float e0 = affine(k0[0], px, k0[1], py, k0[2]);
        const float e1 = affine(k1[0], px, k1[1], py, k1[2]);
        // == max(|e0|, |e1|) <= 0.5, false on NaN like the reference
        if (fabsf(e0) <= 0.5f && fabsf(e1) <= 0.5f) best = min(best, s_qpk[p]);
      }
    }
    for (int ci = 0; ci < ct; ++ci) {
      if (s_tm[ci] == 0) continue;
      for (int p = ci * kChunk; p < (ci + 1) * kChunk; ++p) {
        const float* k0 = s_tcoef + p * 3;
        const float* k1 = s_tcoef + (tp + p) * 3;
        const float* k2 = s_tcoef + (2 * tp + p) * 3;
        const float e0 = affine(k0[0], px, k0[1], py, k0[2]);
        const float e1 = affine(k1[0], px, k1[1], py, k1[2]);
        const float e2 = affine(k2[0], px, k2[1], py, k2[2]);
        // == min(e0, e1, e2) >= 0, false on NaN like the reference
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) best = min(best, s_tpk[p]);
      }
    }

    // background: nearest texel by the two-pass index arithmetic
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
    const int bg = valid ? __ldg(tex + (size_t)ty_i * tex_w + tx_i) : bg_packed;

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
  const size_t smem = sizeof(float) * (6 * qp + 9 * tp + 14)
                      + sizeof(int) * (qp + tp + qp / kChunk + tp / kChunk + 4);
  dim3 grid(n_bands, batch);
  fused_render_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      fcoef, icoef, qmask, tmask, qcoef, qpk, tcoef, tpk, tex, tex_h, tex_w,
      res, rpb, qp, tp, packed, packed ? nullptr : static_cast<float*>(out),
      packed ? static_cast<int*>(out) : nullptr);
  return (int)cudaGetLastError();
}
