// The per-pixel primitive winner shared by the fused render
// (fused_render.cu) and the primitive raster (prim_raster.cu): the
// reference's banded winner loop of ops/pallas_fused.py:_fused_kernel and
// ops/pallas_rasterize.py:_raster_kernel_prims_masked.
//
// One camera's operands (ops/prims.py:prep_prims), staged in shared memory:
//   qcoef (2, qp, 3): each quad's two centered affine coordinates f = a*px +
//     b*py + c; a pixel is inside iff max(|f1|, |f2|) <= 0.5;
//   tcoef (3, tp, 3): each triangle's edge values, winding canonicalized;
//     inside iff all three are >= 0;
//   qpk (qp), tpk (tp): packs zrank << 24 | R << 16 | G << 8 | B, the
//     sentinel 0x7FFFFFFF for padding and degenerate prims;
//   qm (qp / 8), tm (tp / 8): the band's occupancy bit of each 8-primitive
//     chunk; a chunk whose bit is 0 is skipped. Without masks (the unbanded
//     raster) every bit is set.
// The winner is the minimum pack over the inside prims of the live chunks;
// the pixel is covered iff it is below 127 << 24.
//
// Arithmetic: tds::affine, (a*x + b*y) + c with each operation rounded on
// its own, as the plain PyTorch version (ops/prims.py:
// prim_winner_reference) computes it.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "warp_index.cuh"

namespace tds {

constexpr int kChunk = 8;
constexpr int kPrimSentinel = 0x7FFFFFFF;
constexpr int kCoveredBelow = 127 << 24;

// Bytes of shared memory the table of qp quads and tp triangles takes.
__host__ __device__ inline size_t prim_table_bytes(int qp, int tp) {
  return sizeof(float) * (6 * qp + 9 * tp)
         + sizeof(int) * (qp + tp + qp / kChunk + tp / kChunk);
}

struct PrimTable {
  const float* qcoef;
  const float* tcoef;
  const int* qpk;
  const int* tpk;
  const int* qm;
  const int* tm;
  int qp, tp;

  // Stage camera ``cam``'s operands and band ``band``'s mask bits (all set
  // when ``qmask`` is null) into ``smem``, prim_table_bytes(qp, tp) long,
  // with the whole block; the caller synchronizes before reading.
  __device__ __forceinline__ PrimTable(void* smem, int cam, int band,
                                       int n_bands, int qp_, int tp_,
                                       const float* __restrict__ g_qcoef,
                                       const int* __restrict__ g_qpk,
                                       const float* __restrict__ g_tcoef,
                                       const int* __restrict__ g_tpk,
                                       const int* __restrict__ g_qmask,
                                       const int* __restrict__ g_tmask)
      : qp(qp_), tp(tp_) {
    const int cq = qp / kChunk;
    const int ct = tp / kChunk;
    float* s_qcoef = static_cast<float*>(smem);
    float* s_tcoef = s_qcoef + 6 * qp;
    int* s_qpk = reinterpret_cast<int*>(s_tcoef + 9 * tp);
    int* s_tpk = s_qpk + qp;
    int* s_qm = s_tpk + tp;
    int* s_tm = s_qm + cq;
    for (int i = threadIdx.x; i < 6 * qp; i += blockDim.x)
      s_qcoef[i] = g_qcoef[(size_t)cam * 6 * qp + i];
    for (int i = threadIdx.x; i < 9 * tp; i += blockDim.x)
      s_tcoef[i] = g_tcoef[(size_t)cam * 9 * tp + i];
    for (int i = threadIdx.x; i < qp; i += blockDim.x)
      s_qpk[i] = g_qpk[(size_t)cam * qp + i];
    for (int i = threadIdx.x; i < tp; i += blockDim.x)
      s_tpk[i] = g_tpk[(size_t)cam * tp + i];
    for (int i = threadIdx.x; i < cq; i += blockDim.x)
      s_qm[i] = g_qmask ? g_qmask[((size_t)cam * n_bands + band) * cq + i] : 1;
    for (int i = threadIdx.x; i < ct; i += blockDim.x)
      s_tm[i] = g_tmask ? g_tmask[((size_t)cam * n_bands + band) * ct + i] : 1;
    qcoef = s_qcoef;
    tcoef = s_tcoef;
    qpk = s_qpk;
    tpk = s_tpk;
    qm = s_qm;
    tm = s_tm;
  }

  // The winning pack at pixel center (px, py), or the sentinel.
  __device__ __forceinline__ int winner(float px, float py) const {
    int best = kPrimSentinel;
    for (int ci = 0; ci < qp / kChunk; ++ci) {
      if (qm[ci] == 0) continue;
      for (int p = ci * kChunk; p < (ci + 1) * kChunk; ++p) {
        const float* k0 = qcoef + p * 3;
        const float* k1 = qcoef + (qp + p) * 3;
        const float e0 = affine(k0[0], px, k0[1], py, k0[2]);
        const float e1 = affine(k1[0], px, k1[1], py, k1[2]);
        // == max(|e0|, |e1|) <= 0.5, false on NaN like the reference
        if (fabsf(e0) <= 0.5f && fabsf(e1) <= 0.5f) best = min(best, qpk[p]);
      }
    }
    for (int ci = 0; ci < tp / kChunk; ++ci) {
      if (tm[ci] == 0) continue;
      for (int p = ci * kChunk; p < (ci + 1) * kChunk; ++p) {
        const float* k0 = tcoef + p * 3;
        const float* k1 = tcoef + (tp + p) * 3;
        const float* k2 = tcoef + (2 * tp + p) * 3;
        const float e0 = affine(k0[0], px, k0[1], py, k0[2]);
        const float e1 = affine(k1[0], px, k1[1], py, k1[2]);
        const float e2 = affine(k2[0], px, k2[1], py, k2[2]);
        // == min(e0, e1, e2) >= 0, false on NaN like the reference
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) best = min(best, tpk[p]);
      }
    }
    return best;
  }
};

}  // namespace tds
