// The per-pixel primitive winner shared by the fused render
// (fused_render.cu, B1) and the primitive raster (prim_raster.cu, B7/B8):
// the reference's banded winner loop of ops/pallas_fused.py:_fused_kernel and
// ops/pallas_rasterize.py:_raster_kernel_prims_masked, each 16 x 16 pixel
// tile testing only the primitives that can reach it. The triangle edge
// test (TileBox, edge_range, tri_edge_out) and the argument below for why
// the cull is exact also serve the hard raster (hard_raster.cu, B6a/B6b),
// which has a layout of its own: one block per tile, see there.
//
// One camera's operands (ops/prims.py:prep_prims):
//   qcoef (2, qp, 3): each quad's two centered affine coordinates e = a*px +
//     b*py + c; a pixel is inside iff |e0| <= 0.5 && |e1| <= 0.5;
//   tcoef (3, tp, 3): each triangle's edge values, winding canonicalized;
//     inside iff all three are >= 0;
//   qpk (qp), tpk (tp): packs zrank << 24 | R << 16 | G << 8 | B, the
//     sentinel 0x7FFFFFFF for padding and degenerate prims;
//   qmask (J, qp / 8), tmask (J, tp / 8): per band of rpb pixel rows, the
//     occupancy bit of each 8-primitive chunk; null (the unbanded raster):
//     every chunk is live in every band.
// The winner at pixel centre (px, py) = (row + 0.5, col + 0.5) is the
// minimum pack over the prims whose inside test holds there and whose
// chunk's bit is set in the pixel's band (the sentinel if none); the pixel
// is covered iff it is below 127 << 24.
//
// Why a per-tile cull is exact. min is exact, commutative and associative
// on int32, so a tile may drop any primitive that cannot pass both tests at
// any of its pixels, and visit the rest in any order: the winner has the
// same bits. A primitive is dropped from a 16 x 16 tile iff
//   - its pack is the sentinel (padding and degenerate prims never lower
//     the minimum); or
//   - its chunk's bit is 0 in every band the tile's rows meet; or
//   - one of its affine values e = a*px + b*py + c, evaluated in float64 at
//     the tile's four extreme pixel centres (e is affine, so its extremes
//     over the tile lie there), satisfies
//       quad:     max e < -0.5 - delta  or  min e > 0.5 + delta,
//       triangle: max e < -delta,
//     delta = 2^-20 (|a| x_max + |b| y_max + |c|) + 2^-149 [a != 0]
//     + 2^-149 [b != 0], with x_max, y_max the tile's largest pixel centres.
// delta covers the float32 rounding of affine() (two products and two
// sums, each rounded on its own: under 2^-22 of |a| x_max + |b| y_max +
// |c|, plus at most 2^-150, half the least subnormal, for each nonzero
// product that underflows; a sum whose result is subnormal is exact, and a
// zero coefficient's product is exact) and the float64 evaluation's own, so
// at every pixel of a tile that drops the primitive its float32 value is
// strictly outside: |e| > 0.5, or e < 0 and never -0.0 (which would pass
// >= 0). (The kernels are built without -ftz, so subnormals are kept.) The
// inequalities are strict for the case delta = 0 (a = b = c = 0: e is 0
// everywhere, inside a triangle's edge). A near-degenerate primitive
// (|cross| just above 1e-9) has coefficients up to ~1e9 and a delta to
// match: it is dropped only where it is far out. A NaN coefficient makes
// every comparison false, an infinite one delta infinite, so the primitive
// is kept; it never wins.
//
// Two things the cull keeps from the reference. The test is built from the
// primitive's own coefficients, never from its corners: a quad's accepted
// region is the parallelogram on corners 0, 1 and 3, which can leave the
// corners' bounding box. And the band masks are honoured per pixel, even
// where they are not conservative for such a parallelogram: in a tile whose
// rows meet two bands or more, a listed primitive counts at a pixel only if
// its chunk's bit is set in that pixel's band.
//
// The float64 arithmetic is spelled with round-to-nearest intrinsics in one
// order; the plain version ops/prims.py:prim_tile_keep_reference computes
// the same keep set bit for bit. The float32 arithmetic is tds::affine,
// (a*x + b*y) + c with each operation rounded on its own, as the plain
// version of the winner (ops/prims.py:prim_winner_reference) computes it.
//
// Layout, for B1, B7 and B8 (not hard_raster.cu): one block of
// kTileWarps warps per kTileWarps consecutive tiles (row-major) of one
// camera. The block stages the camera's table once in shared memory, each
// primitive's affine values as float4 (a, b, c, and the pack's bits in the
// first edge's w) so that one 128-bit shared load fetches an edge. Each warp
// takes one tile: its 32 lanes test 32 primitive slots at once, and
// __ballot_sync packs the keep bits into one word (no atomics, no list in
// memory); then the warp walks the word's set bits with __ffs, each lane
// evaluating the listed primitive at its kTilePixels pixels (column
// lane & 15; rows lane >> 4, + 2, ..., + 14 of the tile). Quad and triangle
// words are separate, since their tests differ.
#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "warp_index.cuh"

namespace tds {

constexpr int kChunk = 8;
constexpr int kPrimSentinel = 0x7FFFFFFF;
constexpr int kCoveredBelow = 127 << 24;
constexpr int kPrimTile = 16;                               // pixels per tile side
constexpr int kTileWarps = 8;                               // tiles per block
constexpr int kPrimThreads = 32 * kTileWarps;
constexpr int kTilePixels = kPrimTile * kPrimTile / 32;     // pixels per lane
constexpr double kPrimSlack = 0x1p-20;                      // delta per unit of |terms|
constexpr double kPrimUnderflow = 0x1p-149;                 // delta per nonzero product

// Bytes of shared memory the table of qp quads and tp triangles takes.
__host__ __device__ inline size_t prim_table_bytes(int qp, int tp) {
  return sizeof(float4) * (2 * qp + 3 * tp);
}

// The grid over a res x res frame (res a multiple of kPrimTile) of
// ``batch`` cameras: (blocks of kTileWarps tiles, cameras).
inline dim3 prim_grid(int res, int batch) {
  const int per_side = res / kPrimTile;
  return dim3((per_side * per_side + kTileWarps - 1) / kTileWarps, batch);
}

// Copy n_edges x n affine values (3 floats each) and n packs into float4s.
__device__ __forceinline__ void stage_edges(float4* dst, const float* __restrict__ coef,
                                            const int* __restrict__ pk, int n_edges,
                                            int n) {
  for (int i = threadIdx.x; i < n_edges * n; i += blockDim.x) {
    const float* k = coef + 3 * i;
    dst[i] = make_float4(k[0], k[1], k[2],
                         __int_as_float(i < n ? pk[i] : kPrimSentinel));
  }
}

// The tile's extreme pixel centres, in float64.
struct TileBox {
  double x_lo, x_hi, y_lo, y_hi;
};

// The float64 extremes of e = a*px + b*py + c over the tile's pixel
// centres, and delta (see the header).
__device__ __forceinline__ void edge_range(float4 k, const TileBox& t, double& lo,
                                           double& hi, double& delta) {
  const double a = k.x, b = k.y, c = k.z;
  const double ax0 = __dmul_rn(a, t.x_lo), ax1 = __dmul_rn(a, t.x_hi);
  const double by0 = __dmul_rn(b, t.y_lo), by1 = __dmul_rn(b, t.y_hi);
  hi = __dadd_rn(__dadd_rn(fmax(ax0, ax1), fmax(by0, by1)), c);
  lo = __dadd_rn(__dadd_rn(fmin(ax0, ax1), fmin(by0, by1)), c);
  const double underflow = __dadd_rn(a != 0.0 ? kPrimUnderflow : 0.0,
                                     b != 0.0 ? kPrimUnderflow : 0.0);
  delta = __dadd_rn(__dmul_rn(__dadd_rn(__dadd_rn(__dmul_rn(fabs(a), t.x_hi),
                                                  __dmul_rn(fabs(b), t.y_hi)), fabs(c)),
                              kPrimSlack),
                    underflow);
}

// True iff the quad coordinate k is outside [-0.5, 0.5] at every pixel.
__device__ __forceinline__ bool quad_edge_out(float4 k, const TileBox& t) {
  double lo, hi, delta;
  edge_range(k, t, lo, hi, delta);
  return hi < __dsub_rn(-0.5, delta) || lo > __dadd_rn(0.5, delta);
}

// True iff the triangle edge k is negative at every pixel.
__device__ __forceinline__ bool tri_edge_out(float4 k, const TileBox& t) {
  double lo, hi, delta;
  edge_range(k, t, lo, hi, delta);
  return hi < -delta;
}

struct PrimTable {
  const float4* quad;   // (2, qp): edge e of quad p at quad[e * qp + p]
  const float4* tri;    // (3, tp)
  const int* qmask;     // the camera's (J, qp / 8), or null
  const int* tmask;     // the camera's (J, tp / 8), or null
  int qp, tp, rpb;

  // Stage camera ``cam``'s table into ``smem``, prim_table_bytes(qp, tp)
  // long, with the whole block; the caller synchronizes before reading.
  // The masks stay in device memory (read through the read-only cache).
  __device__ __forceinline__ PrimTable(float4* smem, int cam, int qp_, int tp_,
                                       int rpb_, int n_bands,
                                       const float* __restrict__ g_qcoef,
                                       const int* __restrict__ g_qpk,
                                       const float* __restrict__ g_tcoef,
                                       const int* __restrict__ g_tpk,
                                       const int* __restrict__ g_qmask,
                                       const int* __restrict__ g_tmask)
      : quad(smem), tri(smem + 2 * qp_), qp(qp_), tp(tp_), rpb(rpb_) {
    stage_edges(smem, g_qcoef + (size_t)cam * 6 * qp, g_qpk + (size_t)cam * qp, 2, qp);
    stage_edges(smem + 2 * qp, g_tcoef + (size_t)cam * 9 * tp,
                g_tpk + (size_t)cam * tp, 3, tp);
    qmask = g_qmask ? g_qmask + (size_t)cam * n_bands * (qp / kChunk) : nullptr;
    tmask = g_tmask ? g_tmask + (size_t)cam * n_bands * (tp / kChunk) : nullptr;
  }
};

// Whether ``chunk``'s bit is set in some band of b_lo..b_hi (true without
// masks).
__device__ __forceinline__ bool chunk_live(const int* mask, int n_chunks, int chunk,
                                           int b_lo, int b_hi) {
  if (!mask) return true;
  for (int b = b_lo; b <= b_hi; ++b)
    if (__ldg(mask + b * n_chunks + chunk) != 0) return true;
  return false;
}

// Bit i set iff ``chunk``'s bit is set in the band of row row0 + 2 i.
__device__ __forceinline__ unsigned live_rows(const int* mask, int n_chunks, int chunk,
                                              int row0, int rpb) {
  unsigned rows = 0;
#pragma unroll
  for (int i = 0; i < kTilePixels; ++i)
    rows |= (unsigned)(__ldg(mask + ((row0 + 2 * i) / rpb) * n_chunks + chunk) != 0) << i;
  return rows;
}

// The winning packs (or the sentinel) of this lane's kTilePixels pixels of
// the tile whose first row and column are (r0, c0): rows r0 + (lane >> 4) +
// 2 i, column c0 + (lane & 15). Called by all 32 lanes of a warp.
__device__ __forceinline__ void tile_winners(const PrimTable& tab, int r0, int c0,
                                             int best[kTilePixels]) {
  const int lane = threadIdx.x & 31;
  const TileBox box{r0 + 0.5, r0 + (kPrimTile - 0.5), c0 + 0.5, c0 + (kPrimTile - 0.5)};
  const int row0 = r0 + (lane >> 4);
  const float py = (float)(c0 + (lane & 15)) + 0.5f;
  const int b_lo = r0 / tab.rpb;
  const int b_hi = (r0 + kPrimTile - 1) / tab.rpb;
#pragma unroll
  for (int i = 0; i < kTilePixels; ++i) best[i] = kPrimSentinel;

  const int cq = tab.qp / kChunk;
  for (int w = 0; 32 * w < tab.qp; ++w) {
    const int p = 32 * w + lane;
    bool keep = false;
    if (p < tab.qp) {
      const float4 k0 = tab.quad[p];
      keep = __float_as_int(k0.w) != kPrimSentinel
             && chunk_live(tab.qmask, cq, p / kChunk, b_lo, b_hi)
             && !quad_edge_out(k0, box) && !quad_edge_out(tab.quad[tab.qp + p], box);
    }
    for (unsigned bits = __ballot_sync(0xffffffffu, keep); bits; bits &= bits - 1) {
      const int q = 32 * w + __ffs(bits) - 1;
      const float4 k0 = tab.quad[q];
      const float4 k1 = tab.quad[tab.qp + q];
      const int pk = __float_as_int(k0.w);
      const unsigned rows = (b_lo == b_hi || !tab.qmask)
                                ? 0xffu : live_rows(tab.qmask, cq, q / kChunk, row0, tab.rpb);
#pragma unroll
      for (int i = 0; i < kTilePixels; ++i) {
        const float px = (float)(row0 + 2 * i) + 0.5f;
        const float e0 = affine(k0.x, px, k0.y, py, k0.z);
        const float e1 = affine(k1.x, px, k1.y, py, k1.z);
        // == max(|e0|, |e1|) <= 0.5, false on NaN like the reference
        if (fabsf(e0) <= 0.5f && fabsf(e1) <= 0.5f && ((rows >> i) & 1u))
          best[i] = min(best[i], pk);
      }
    }
  }

  const int ct = tab.tp / kChunk;
  for (int w = 0; 32 * w < tab.tp; ++w) {
    const int p = 32 * w + lane;
    bool keep = false;
    if (p < tab.tp) {
      const float4 k0 = tab.tri[p];
      keep = __float_as_int(k0.w) != kPrimSentinel
             && chunk_live(tab.tmask, ct, p / kChunk, b_lo, b_hi)
             && !tri_edge_out(k0, box) && !tri_edge_out(tab.tri[tab.tp + p], box)
             && !tri_edge_out(tab.tri[2 * tab.tp + p], box);
    }
    for (unsigned bits = __ballot_sync(0xffffffffu, keep); bits; bits &= bits - 1) {
      const int q = 32 * w + __ffs(bits) - 1;
      const float4 k0 = tab.tri[q];
      const float4 k1 = tab.tri[tab.tp + q];
      const float4 k2 = tab.tri[2 * tab.tp + q];
      const int pk = __float_as_int(k0.w);
      const unsigned rows = (b_lo == b_hi || !tab.tmask)
                                ? 0xffu : live_rows(tab.tmask, ct, q / kChunk, row0, tab.rpb);
#pragma unroll
      for (int i = 0; i < kTilePixels; ++i) {
        const float px = (float)(row0 + 2 * i) + 0.5f;
        const float e0 = affine(k0.x, px, k0.y, py, k0.z);
        const float e1 = affine(k1.x, px, k1.y, py, k1.z);
        const float e2 = affine(k2.x, px, k2.y, py, k2.z);
        // == min(e0, e1, e2) >= 0, false on NaN like the reference
        if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && ((rows >> i) & 1u))
          best[i] = min(best[i], pk);
      }
    }
  }
}

// Registers per thread, resident blocks per SM at ``smem`` bytes of
// dynamic shared memory, and local-memory (spill) bytes per thread of
// ``kernel``, into out[0..2]; returns the CUDA error code.
template <typename Kernel>
inline int kernel_occupancy(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[0] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel,
                                                            kPrimThreads, smem);
}

}  // namespace tds
