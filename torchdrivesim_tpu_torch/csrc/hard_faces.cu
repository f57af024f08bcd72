// The plain hard raster of per-face arrays with float colors, over an
// H x W frame (HF): the reference's XLA rasterize_hard_faces
// (torchdrivesim_tpu/ops/rasterize.py:566) and the rectangular
// _rasterize_hard_rect (:810) that its texture baker runs, computed exactly.
//
// Replaces no TPU kernel: the reference runs these as XLA code. It was added
// because the card must not run the plain version on a served path: the
// differentiable primitive render (Renderer._render_prims_plain), the
// differentiable face soup (render_faces_chw) and the map texture bake. The
// packed and chunked hard rasters (hard_raster.cu, B6a/B6b) cannot stand in:
// they quantize colors to RGB8, canonicalize the winding and break z ties
// by the least RGB8.
//
// Semantics (the plain version is ops/hard_faces.py:hard_faces_reference):
//   * pixel (row, col) has its centre at (px, py) = (row + 0.5, col + 0.5);
//   * edge k of a face with corners c (row, col), a = c[k], b = c[k+1 mod 3]:
//     e_k = ex * (py - a1) - ey * (px - a0), ex = b0 - a0, ey = b1 - a1,
//     every operation rounded on its own (__fsub_rn / __fmul_rn: nvcc cannot
//     contract them into FMAs), as the plain version computes them;
//   * area = ex_0 * (c2_1 - c0_1) - ey_0 * (c2_0 - c0_0), rounded the same
//     way; the face counts only where |area| > 1e-9f;
//   * a face covers a pixel where its three edges are all >= 0 or all <= 0
//     (either winding; a NaN edge covers nothing);
//   * the winner is the covering face of least z by a strict < in face order
//     against a minimum that starts at BIG_Z = 1e9f: the first face wins a z
//     tie, and a NaN z or a z >= BIG_Z never wins. The pixel takes the
//     winner's three floats, else the background's, and the winner index
//     (-1 for the background) is written beside the image for the backward.
//
// Design: three steps on the caller's stream, nothing read back.
//   1. cudaMemsetAsync zeroes the per-tile counts (B, tiles).
//   2. hard_faces_bin_kernel, one thread per (camera, face): the face's set-up
//      once (its three edges (a0, a1, ex, ey), rounded as the fold rounds
//      them, the area and z tests, and its conservative range of 16 x 16
//      tiles, below) into a 64-byte FaceRecord (three float4 edges, then z
//      and the range), written where some tile can read it. Then each tile
//      of the range runs the float64 edge test below, and a tile that keeps
//      the face takes it into its list by an atomicAdd on its count. A range
//      of up to kOwnTiles tiles is binned by its own thread; a larger one by
//      its whole warp, a tile a lane, so one face that spans the frame cannot
//      hold the launch back.
//   3. hard_faces_fold_kernel, one block per tile, each thread four
//      consecutive pixels of one row (64 threads cover the tile). It issues
//      its background loads first (float4 where the row is aligned), so
//      their latency overlaps the list's; reads the tile's list (at most
//      kListCap faces) into shared memory and sorts it into ascending face
//      order (each entry's rank among the distinct entries), since atomics
//      fill it in no fixed order; stages the listed records 64 at a time into
//      shared memory and folds them in that order, so the strict < fold is
//      the plain version's own and the result repeats run to run; then
//      writes the image (float4) and the winner (int4) where the row is
//      aligned, masking the ragged edge.
//      With more than kSplitFaces faces a camera (the texture strips) the
//      block has kSplitGroups groups of 64 threads: group g folds the g-th of
//      kSplitGroups contiguous parts of the sorted list over the whole tile,
//      and group 0 merges the groups' winners in group order by the same
//      strict <, which is the fold of the whole list split at the parts'
//      boundaries. A texture tile lists up to ~260 faces, and one thread's
//      serial fold over them is the strip's tail; the frames, with ~1.5
//      faces a tile, would only hold idle groups. The dispatch is on F alone.
//   A tile whose count exceeds the list's capacity (the capacity is
//   min(F, kListCap), fixed from the shapes) takes an ordered scan instead:
//   every face of its camera in order (each group a contiguous part), 64 a
//   round, those whose range holds the tile compacted in ascending order by
//   __ballot_sync. Exact either way. (Only the grouped kernel can overflow:
//   kListCap > kSplitFaces.)
//   The scratch (records, counts, lists) is allocated by the caller from the
//   shapes alone, so a call makes no host sync and can be captured into a
//   CUDA graph.
//
// The box margin. Let c_k be the float32 corners (exact reals), X_k, Y_k the
// exact row and column differences of edge k, and E*_k(p) = X_k (py - c_k1)
// - Y_k (px - c_k0) the exact edge. HF's float32 edge e_k first rounds X_k to
// ex, then the differences, the products and the difference: with
// P = X_k (py - c_k1) and Q = Y_k (px - c_k0) exact and u = 2^-24,
// |e_k - E*_k| <= ((1 + u)^3 - 1 + u (1 + u)^3) (|P| + |Q|) + 2^-148
// <= 4.1 u (|P| + |Q|) + 2^-140 (a product that underflows errs by at most
// 2^-150; a difference with a subnormal result is exact). E*_k = 2A l_(k+2),
// where 2A = E*_0(c_2) is the exact doubled signed area and l the
// barycentric coordinates (sum 1). Take a pixel centre p at L-infinity
// distance D > 0 outside the corners' box, say px < rmin - D, and let
// S = max(Sr, Sc), the box's larger side. Then sum_k l_k (c_k0 - rmin) =
// px - rmin < -D, so the negative l sum to less than -D / S: some l_j <
// -D / (2S), and the positive ones sum to more than 1 + D / S, so some
// l_i > D / (2S). So one exact edge is below -|A| D / S and another above
// |A| D / S. With M the largest |X_k| or |Y_k|, |P| + |Q| <= M (Sr + Sc + 2D)
// anywhere within D of the box, so where
//   |A| D / S > 4.1 u M (Sr + Sc + 2D) + 2^-140,
// i.e. D > D* = (4.1 u M (Sr + Sc) + 2^-140) / (|A| / S - 8.2 u M),
// one float32 edge is strictly negative and one strictly positive, and p is
// covered under neither winding; the inequality holds for every larger D.
// (A product or difference that overflows float32 gives an infinite edge of
// the exact edge's sign, since the margin keeps P and Q further apart than
// their rounding, or NaN, which covers nothing: the argument holds there.)
// The set-up computes D* in float64 from a lower bound of |A| (the float64
// area less 2^-48 (|P| + |Q|), which bounds its rounding), widens it by a
// factor 1 + 2^-40 and by 2^-48 (1 + the largest |coordinate|), which bound
// the float64 rounding of D* and of rmin - D* - 0.5, and takes the rows
// ceil(rmin - D* - 0.5) .. floor(rmax + D* - 0.5), the columns likewise,
// clamped to the frame. A face whose |A| / S does not exceed 8.2 u M (a
// sliver thinner than ~1e-6 of its length, or collinear corners with an area
// that rounding lifted past 1e-9) or that has a non-finite corner gets the
// whole frame: its rounded edges can agree in sign arbitrarily far along its
// line. A face that fails the area or z test gets an empty range.
// (ops/hard_faces.py:face_tile_ranges computes the same ranges.)
//
// The per-tile edge test. A face is dropped from a tile of its range iff
// some edge is negative at every pixel centre of the tile AND some edge is
// positive at every pixel centre of the tile (then neither "all >= 0" nor
// "all <= 0" holds anywhere, whatever the winding). "Negative at every pixel
// centre" is decided in float64 at the tile's four extreme pixel centres:
// with A = ex * (py - a1) and B = ey * (px - a0) exact (ex, ey the rounded
// differences), the float32 edge differs from A - B by at most
// 3.0001 u (|A| + |B|) + 2^-149. A - B is affine in the pixel and |A| + |B|
// convex, so A - B + 3.1 u (|A| + |B|) + 2^-140 < 0 at the four corners
// implies a float32 edge strictly below zero (never -0.0, which would pass
// >= 0) at every pixel centre between them; 3.1 u and 2^-140 also cover the
// float64 evaluation's own rounding. "Positive" is the mirror test. A NaN or
// infinite coordinate makes the tests false, so the face is kept. (The
// kernels are built without -ftz, so subnormals are kept.) The plain mirror
// of the lists is ops/hard_faces.py:hard_faces_tile_lists_reference.
//
// Bound (chip_smoke.py counts it): the background read and the image and
// winner writes, 28 bytes a pixel, on every path. On the differentiable
// primitive frames (1,280 cameras, 94 faces, ~1.5 listed a tile) and the face
// soup the fold streams them with 16-byte accesses and takes ~75-85% of the
// call; the set-up and binning (~12 us for 120,320 faces) most of the rest.
// On a texture strip (one camera, 512 x ~1,000 pixels, ~17,000-60,000 faces
// of which a few thousand reach it, ~7-21 listed a tile, at most ~263) the
// densest tiles' folds and the binning's one pass over the mesh take the
// time, well above the ~4.5 us of bytes. The earlier design (one block of 256
// threads per tile, each block reading and culling every face of its camera
// in float64 between two barriers a round, one pixel a thread, no box) took
// 0.40 ms on the Town02 strip (34.1 M float64 tile tests, 3.3% of its bound)
// and 0.116-0.118 ms on the 64 px facade frame, 38% of its byte bound (H100
// 80GB HBM3, 700 W; chip_smoke.py, tools/hf_times.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kCols = 4;                              // pixels a fold thread
constexpr int kFoldThreads = kTile * kTile / kCols;   // 64
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kBinThreads = 256;
constexpr int kOwnTiles = 8;         // a larger range is binned by the warp
constexpr int kSplitFaces = 256;     // more faces: kSplitGroups groups a tile
constexpr int kSplitGroups = 4;
constexpr int kListCap = 512;        // ops/hard_faces.py:LIST_CAP
constexpr float kBigZ = 1e9f;
constexpr float kAreaEps = 1e-9f;
constexpr double kU = 5.9604644775390625e-08;         // 2^-24
// the per-tile edge test: 3.1 u and 2^-140
constexpr double kErr = 3.1 * kU;
constexpr double kTiny = 7.174648137343064e-43;
// the box margin: 4.1 u, 8.2 u, the area's 2^-48, the pads 1 + 2^-40, 2^-48
constexpr double kBoxErr = 4.1 * kU;
constexpr double kBoxSlope = 8.2 * kU;
constexpr double kAreaRel = 3.552713678800501e-15;
constexpr double kPadRel = 1.0 + 9.094947017729282e-13;
constexpr double kPadAbs = 3.552713678800501e-15;

// one face's set-up: its edges (a0, a1, ex, ey) and (z, first | last tile
// row << 16, first | last tile column << 16, unused) as int bits
struct FaceRecord {
  float4 edge[3];
  float4 meta;
};

// edge = ex * (py - a1) - ey * (px - a0), each operation rounded on its own
__device__ __forceinline__ float edge_value(float4 e, float px, float py) {
  return __fsub_rn(__fmul_rn(e.z, __fsub_rn(py, e.y)),
                   __fmul_rn(e.w, __fsub_rn(px, e.x)));
}

struct TileCentres {
  double r0, r1, c0, c1;     // first and last pixel centre rows and columns
};

// whether the float32 edge e = (a0, a1, ex, ey) is strictly negative (neg) or
// strictly positive (pos) at every pixel centre of the tile
__device__ __forceinline__ void edge_sign(float4 e, const TileCentres& t, bool& neg,
                                          bool& pos) {
  const double a0 = e.x, a1 = e.y, ex = e.z, ey = e.w;
  neg = true;
  pos = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const double px = (i & 1) ? t.r1 : t.r0;
    const double py = (i & 2) ? t.c1 : t.c0;
    const double p = __dmul_rn(ex, __dsub_rn(py, a1));
    const double q = __dmul_rn(ey, __dsub_rn(px, a0));
    const double v = __dsub_rn(p, q);
    const double err = __dadd_rn(__dmul_rn(kErr, __dadd_rn(fabs(p), fabs(q))), kTiny);
    neg = neg && (__dadd_rn(v, err) < 0.0);
    pos = pos && (__dsub_rn(v, err) > 0.0);
  }
}

// the first and last tile of the pixel centres in [lo - d, hi + d] on an axis
// of n pixels; false where none
__device__ __forceinline__ bool tile_span(double lo, double hi, double d, int n,
                                          int& first, int& last) {
  const double a = fmax(ceil(__dsub_rn(__dsub_rn(lo, d), 0.5)), 0.0);
  const double b = fmin(floor(__dsub_rn(__dadd_rn(hi, d), 0.5)), (double)(n - 1));
  if (!(a <= b)) return false;
  first = (int)a / kTile;
  last = (int)b / kTile;
  return true;
}

// the face's tile range (first row, last row, first column, last column) from
// its corners c (row, col) x 3: the box margin above
__device__ int4 face_span(const float* c, int height, int width) {
  const int4 whole = make_int4(0, (height - 1) / kTile, 0, (width - 1) / kTile);
  const int4 empty = make_int4(1, 0, 1, 0);
  const double r0 = c[0], q0 = c[1], r1 = c[2], q1 = c[3], r2 = c[4], q2 = c[5];
  if (!(isfinite(r0) && isfinite(q0) && isfinite(r1) && isfinite(q1) && isfinite(r2)
        && isfinite(q2)))
    return whole;
  const double rmin = fmin(fmin(r0, r1), r2), rmax = fmax(fmax(r0, r1), r2);
  const double cmin = fmin(fmin(q0, q1), q2), cmax = fmax(fmax(q0, q1), q2);
  const double sr = __dsub_rn(rmax, rmin), sc = __dsub_rn(cmax, cmin);
  const double x0 = __dsub_rn(r1, r0), x1 = __dsub_rn(r2, r1), x2 = __dsub_rn(r0, r2);
  const double y0 = __dsub_rn(q1, q0), y1 = __dsub_rn(q2, q1), y2 = __dsub_rn(q0, q2);
  const double m = fmax(fmax(fmax(fabs(x0), fabs(x1)), fabs(x2)),
                        fmax(fmax(fabs(y0), fabs(y1)), fabs(y2)));
  const double p = __dmul_rn(x0, __dsub_rn(q2, q0));
  const double s = __dmul_rn(y0, __dsub_rn(r2, r0));
  const double a_lo = 0.5 * __dsub_rn(fabs(__dsub_rn(p, s)),
                                      __dmul_rn(kAreaRel, __dadd_rn(fabs(p), fabs(s))));
  const double den = __dsub_rn(__ddiv_rn(a_lo, fmax(sr, sc)), __dmul_rn(kBoxSlope, m));
  if (!(den > 0.0)) return whole;
  const double num = __dadd_rn(__dmul_rn(__dmul_rn(kBoxErr, m), __dadd_rn(sr, sc)), kTiny);
  const double reach = __dadd_rn(fmax(fmax(fabs(rmin), fabs(rmax)),
                                      fmax(fabs(cmin), fabs(cmax))), 1.0);
  const double d = __dadd_rn(__dmul_rn(__ddiv_rn(num, den), kPadRel),
                             __dmul_rn(reach, kPadAbs));
  int4 span;
  if (!tile_span(rmin, rmax, d, height, span.x, span.y)
      || !tile_span(cmin, cmax, d, width, span.z, span.w))
    return empty;
  return span;
}

// the float64 edge test of face edges e in tile (tr, tc); where it keeps the
// face, the face joins the tile's list
__device__ __forceinline__ void bin_pair(const float4* e, int tr, int tc, int cam, int face,
                                         int height, int width, int cap, int* counts,
                                         int* lists) {
  const int tiles_w = (width + kTile - 1) / kTile;
  const int tiles = ((height + kTile - 1) / kTile) * tiles_w;
  const int row0 = tr * kTile, col0 = tc * kTile;
  const TileCentres t{(double)row0 + 0.5, (double)min(row0 + kTile, height) - 0.5,
                      (double)col0 + 0.5, (double)min(col0 + kTile, width) - 0.5};
  bool neg[3], pos[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) edge_sign(e[k], t, neg[k], pos[k]);
  if ((neg[0] || neg[1] || neg[2]) && (pos[0] || pos[1] || pos[2])) return;
  const size_t cell = (size_t)cam * tiles + (size_t)tr * tiles_w + tc;
  const int slot = atomicAdd(counts + cell, 1);
  if (slot < cap) lists[cell * cap + slot] = face;
}

__global__ void __launch_bounds__(kBinThreads)
hard_faces_bin_kernel(const float* __restrict__ corners,   // (B, F, 3, 2)
                      const float* __restrict__ z,         // (B, F)
                      long long n_total, int n_faces, int height, int width, int cap,
                      FaceRecord* __restrict__ rec,        // (B, F)
                      int* __restrict__ counts,            // (B, tiles), zeroed
                      int* __restrict__ lists) {           // (B, tiles, cap)
  __shared__ float4 s_edge[kBinThreads][3];
  __shared__ int4 s_span[kBinThreads];

  const int tid = threadIdx.x, lane = tid & 31;
  const long long g = (long long)blockIdx.x * kBinThreads + tid;
  float4 e[3] = {};
  int4 span = make_int4(1, 0, 1, 0);
  if (g < n_total) {
    float c[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) c[i] = corners[g * 6 + i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int n = (k + 1) % 3;
      e[k] = make_float4(c[2 * k], c[2 * k + 1], __fsub_rn(c[2 * n], c[2 * k]),
                         __fsub_rn(c[2 * n + 1], c[2 * k + 1]));
    }
    const float area = __fsub_rn(__fmul_rn(e[0].z, __fsub_rn(c[5], c[1])),
                                 __fmul_rn(e[0].w, __fsub_rn(c[4], c[0])));
    const float fz = z[g];
    if (fabsf(area) > kAreaEps && fz < kBigZ) span = face_span(c, height, width);
    // a face whose range is empty is read only by an overflowed tile's scan,
    // and a tile can overflow only where a camera has more faces than cap
    if (span.x <= span.y || n_faces > cap)
      rec[g].meta = make_float4(fz, __int_as_float(span.x | (span.y << 16)),
                                __int_as_float(span.z | (span.w << 16)), 0.0f);
    if (span.x <= span.y) {
#pragma unroll
      for (int k = 0; k < 3; ++k) rec[g].edge[k] = e[k];
    }
  }
  const int cam = (int)(g / n_faces), face = (int)(g % n_faces);
  const long long n_span = span.x <= span.y
      ? (long long)(span.y - span.x + 1) * (span.w - span.z + 1) : 0;
  // a range of a few tiles: this thread
  if (n_span <= kOwnTiles) {
    const int n_cols = span.w - span.z + 1;
    for (int t = 0; t < (int)n_span; ++t)
      bin_pair(e, span.x + t / n_cols, span.z + t % n_cols, cam, face, height, width,
               cap, counts, lists);
  }
  // a larger range: the whole warp, one face at a time, a tile a lane
#pragma unroll
  for (int k = 0; k < 3; ++k) s_edge[tid][k] = e[k];
  s_span[tid] = span;
  __syncwarp();
  unsigned big = __ballot_sync(0xffffffffu, n_span > kOwnTiles);
  while (big) {
    const int src = (tid & ~31) + __ffs(big) - 1;
    big &= big - 1;
    const long long gs = (long long)blockIdx.x * kBinThreads + src;
    const int4 sp = s_span[src];
    const int n_cols = sp.w - sp.z + 1;
    const long long n = (long long)(sp.y - sp.x + 1) * n_cols;
    for (long long t = lane; t < n; t += 32)
      bin_pair(s_edge[src], sp.x + (int)(t / n_cols), sp.z + (int)(t % n_cols),
               (int)(gs / n_faces), (int)(gs % n_faces), height, width, cap, counts,
               lists);
  }
}

// fold the cnt staged faces into this thread's kCols pixels, in order
__device__ __forceinline__ void fold(float4 (*s_edge)[kFoldThreads], const float* s_z,
                                     const int* s_index, int cnt, float px, int col,
                                     float* best_z, int* best) {
  for (int i = 0; i < cnt; ++i) {
    const float4 e0 = s_edge[0][i], e1 = s_edge[1][i], e2 = s_edge[2][i];
    const float zi = s_z[i];
    const int fi = s_index[i];
    // ey * (px - a0) is the same for the thread's four pixels of one row
    const float t0 = __fmul_rn(e0.w, __fsub_rn(px, e0.x));
    const float t1 = __fmul_rn(e1.w, __fsub_rn(px, e1.x));
    const float t2 = __fmul_rn(e2.w, __fsub_rn(px, e2.x));
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float py = (float)(col + j) + 0.5f;
      const float v0 = __fsub_rn(__fmul_rn(e0.z, __fsub_rn(py, e0.y)), t0);
      const float v1 = __fsub_rn(__fmul_rn(e1.z, __fsub_rn(py, e1.y)), t1);
      const float v2 = __fsub_rn(__fmul_rn(e2.z, __fsub_rn(py, e2.y)), t2);
      const bool covered = ((v0 >= 0.0f) & (v1 >= 0.0f) & (v2 >= 0.0f))
                           | ((v0 <= 0.0f) & (v1 <= 0.0f) & (v2 <= 0.0f));
      if (covered && zi < best_z[j]) {
        best_z[j] = zi;
        best[j] = fi;
      }
    }
  }
}

template <int kGroups>
__global__ void __launch_bounds__(kGroups * kFoldThreads)
hard_faces_fold_kernel(const FaceRecord* __restrict__ rec,   // (B, F)
                       const int* __restrict__ counts,       // (B, tiles)
                       const int* __restrict__ lists,        // (B, tiles, cap)
                       const float* __restrict__ color,      // (B, F, 3)
                       const float* __restrict__ bg,         // (B, 3, H, W)
                       int n_faces, int height, int width, int cap, bool vec,
                       float* __restrict__ out,              // (B, 3, H, W)
                       int* __restrict__ winner) {           // (B, H, W)
  constexpr int kThreads = kGroups * kFoldThreads;
  constexpr int kPartials = kGroups > 1 ? kGroups - 1 : 1;
  __shared__ int s_list[kListCap];
  __shared__ int s_order[kListCap];
  __shared__ float4 s_edge[kGroups][3][kFoldThreads];
  __shared__ float s_z[kGroups][kFoldThreads];
  __shared__ int s_index[kGroups][kFoldThreads];
  __shared__ int s_count[kGroups * kFoldWarps];
  __shared__ float s_part_z[kPartials][kFoldThreads * kCols];
  __shared__ int s_part[kPartials][kFoldThreads * kCols];

  const int cam = blockIdx.y, tile = blockIdx.x;
  const int tiles_w = (width + kTile - 1) / kTile;
  const int tr = tile / tiles_w, tc = tile % tiles_w;
  const int tid = threadIdx.x, lane = tid & 31;
  const int group = tid / kFoldThreads, gt = tid % kFoldThreads;
  const int gwarp = gt >> 5;
  const int row = tr * kTile + gt / (kTile / kCols);
  const int col = tc * kTile + (gt % (kTile / kCols)) * kCols;
  const bool live = group == 0 && row < height && col < width;
  const size_t plane = (size_t)height * width;
  const size_t o = (size_t)row * width + col;
  const float* cam_bg = bg + (size_t)cam * 3 * plane;

  // the background first: its latency overlaps the list's
  float pix[3][kCols] = {};
  if (live) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      if (vec) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(cam_bg + ch * plane + o));
        pix[ch][0] = v.x;
        pix[ch][1] = v.y;
        pix[ch][2] = v.z;
        pix[ch][3] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          if (col + j < width) pix[ch][j] = __ldg(cam_bg + ch * plane + o + j);
      }
    }
  }

  const FaceRecord* cam_rec = rec + (size_t)cam * n_faces;
  const size_t cell = (size_t)cam * gridDim.x + tile;
  const int n = counts[cell];
  const float px = (float)row + 0.5f;
  float best_z[kCols];
  int best[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    best_z[j] = kBigZ;
    best[j] = -1;
  }
  if (n <= cap) {
    // the tile's list, sorted into ascending face order; group g folds the
    // g-th of kGroups contiguous parts of it
    const int* list = lists + cell * cap;
    for (int i = tid; i < n; i += kThreads) s_list[i] = list[i];
    __syncthreads();
    for (int i = tid; i < n; i += kThreads) {
      const int v = s_list[i];
      int rank = 0;
      for (int j = 0; j < n; ++j) rank += s_list[j] < v;
      s_order[rank] = v;
    }
    __syncthreads();
    const int lo = n * group / kGroups, hi = n * (group + 1) / kGroups;
    const int part = (n + kGroups - 1) / kGroups;
    for (int s = 0; s < part; s += kFoldThreads) {
      const int i = lo + s + gt;
      if (i < hi) {
        const int f = s_order[i];
        const FaceRecord* r = cam_rec + f;
#pragma unroll
        for (int k = 0; k < 3; ++k) s_edge[group][k][gt] = r->edge[k];
        s_z[group][gt] = r->meta.x;
        s_index[group][gt] = f;
      }
      __syncthreads();
      fold(s_edge[group], s_z[group], s_index[group], max(min(kFoldThreads, hi - lo - s), 0),
           px, col, best_z, best);
      __syncthreads();
    }
  } else {
    // more faces than the list holds: every face of the camera in order,
    // group g the g-th of kGroups contiguous parts, those whose range holds
    // the tile compacted in ascending order
    const int lo = n_faces * group / kGroups, hi = n_faces * (group + 1) / kGroups;
    const int part = (n_faces + kGroups - 1) / kGroups;
    for (int s = 0; s < part; s += kFoldThreads) {
      const int f = lo + s + gt;
      bool keep = false;
      float4 meta = {};
      if (f < hi) {
        meta = cam_rec[f].meta;
        const unsigned rows = __float_as_uint(meta.y), cols = __float_as_uint(meta.z);
        keep = (int)(rows & 0xffffu) <= tr && tr <= (int)(rows >> 16)
               && (int)(cols & 0xffffu) <= tc && tc <= (int)(cols >> 16);
      }
      const unsigned bits = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_count[group * kFoldWarps + gwarp] = __popc(bits);
      __syncthreads();                     // the last round is folded; counts in
      int at = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kFoldWarps; ++w) {
        if (w == gwarp) at = total;
        total += s_count[group * kFoldWarps + w];
      }
      if (keep) {
        at += __popc(bits & ((1u << lane) - 1u));
#pragma unroll
        for (int k = 0; k < 3; ++k) s_edge[group][k][at] = cam_rec[f].edge[k];
        s_z[group][at] = meta.x;
        s_index[group][at] = f;
      }
      __syncthreads();
      fold(s_edge[group], s_z[group], s_index[group], total, px, col, best_z, best);
    }
  }
  if (kGroups > 1) {
    // the groups' winners merged in group order by the same strict <: the
    // fold of the whole list split at the groups' boundaries
    if (group > 0) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s_part_z[group - 1][gt * kCols + j] = best_z[j];
        s_part[group - 1][gt * kCols + j] = best[j];
      }
    }
    __syncthreads();
    if (group > 0) return;
#pragma unroll
    for (int g = 0; g < kGroups - 1; ++g) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float zg = s_part_z[g][gt * kCols + j];
        if (zg < best_z[j]) {
          best_z[j] = zg;
          best[j] = s_part[g][gt * kCols + j];
        }
      }
    }
  }
  if (!live) return;

#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    if (best[j] >= 0) {
      const float* c = color + ((size_t)cam * n_faces + best[j]) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) pix[ch][j] = c[ch];
    }
  }
  float* cam_out = out + (size_t)cam * 3 * plane;
  int* cam_winner = winner + (size_t)cam * plane;
  if (vec) {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      *reinterpret_cast<float4*>(cam_out + ch * plane + o) =
          make_float4(pix[ch][0], pix[ch][1], pix[ch][2], pix[ch][3]);
    *reinterpret_cast<int4*>(cam_winner + o) = make_int4(best[0], best[1], best[2], best[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (col + j >= width) break;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) cam_out[ch * plane + o + j] = pix[ch][j];
      cam_winner[o + j] = best[j];
    }
  }
}

}  // namespace

// the set-up and binning alone: records (B, F), counts (B, tiles) and lists
// (B, tiles, cap) of 16 x 16 tiles, row-major
extern "C" int tds_hard_faces_bin(const float* corners, const float* z, int batch,
                                  int n_faces, int height, int width, int cap,
                                  void* records, int* counts, int* lists,
                                  cudaStream_t stream) {
  const int tiles = ((height + kTile - 1) / kTile) * ((width + kTile - 1) / kTile);
  if (cap < 0 || cap > kListCap || cap > n_faces) return (int)cudaErrorInvalidValue;
  if (batch == 0 || tiles == 0) return 0;
  cudaError_t err = cudaMemsetAsync(counts, 0, sizeof(int) * (size_t)batch * tiles, stream);
  if (err != cudaSuccess) return (int)err;
  const long long n_total = (long long)batch * n_faces;
  if (n_total > 0)
    hard_faces_bin_kernel<<<(unsigned)((n_total + kBinThreads - 1) / kBinThreads),
                            kBinThreads, 0, stream>>>(
        corners, z, n_total, n_faces, height, width, cap,
        static_cast<FaceRecord*>(records), counts, lists);
  return (int)cudaGetLastError();
}

extern "C" int tds_hard_faces(const float* corners, const float* z, const float* color,
                              const float* bg, int batch, int n_faces, int height,
                              int width, int cap, void* records, int* counts, int* lists,
                              float* out, int* winner, cudaStream_t stream) {
  const int err = tds_hard_faces_bin(corners, z, batch, n_faces, height, width, cap, records,
                                     counts, lists, stream);
  if (err != 0) return err;
  const int tiles = ((height + kTile - 1) / kTile) * ((width + kTile - 1) / kTile);
  if (batch == 0 || tiles == 0) return 0;
  const bool vec = width % kCols == 0
                   && (((uintptr_t)bg | (uintptr_t)out | (uintptr_t)winner) & 15) == 0;
  const FaceRecord* rec = static_cast<const FaceRecord*>(records);
  if (n_faces > kSplitFaces)
    hard_faces_fold_kernel<kSplitGroups><<<dim3(tiles, batch), kSplitGroups * kFoldThreads,
                                           0, stream>>>(
        rec, counts, lists, color, bg, n_faces, height, width, cap, vec, out, winner);
  else
    hard_faces_fold_kernel<1><<<dim3(tiles, batch), kFoldThreads, 0, stream>>>(
        rec, counts, lists, color, bg, n_faces, height, width, cap, vec, out, winner);
  return (int)cudaGetLastError();
}
