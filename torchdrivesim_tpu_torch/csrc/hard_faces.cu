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
// Layout: one block of 256 threads per 16 x 16 pixel tile of one camera, one
// thread per pixel; the grid is (ceil(H / 16) * ceil(W / 16), cameras). The
// block scans its camera's faces 256 at a time (one per thread), keeps those
// that can win somewhere in the tile, compacts them into shared memory in
// ascending face order (__ballot_sync and __popc, no atomics), and every
// thread folds them into its pixel's winner in that order, so the strict <
// fold is the plain version's own.
//
// Per-tile cull. A face is dropped from a tile iff it can never win there:
// its area test fails or its z is not below BIG_Z (both computed exactly as
// the fold would), or some edge is negative at every pixel centre of the
// tile AND some edge is positive at every pixel centre of the tile (then
// neither "all >= 0" nor "all <= 0" holds anywhere, whatever the winding).
// "Negative at every pixel centre" is decided in float64 at the tile's four
// extreme pixel centres: with A = ex * (py - a1) and B = ey * (px - a0)
// exact, the float32 edge differs from A - B by at most
// 3.0001 u (|A| + |B|) + 2^-149 (u = 2^-24: three roundings; a product that
// underflows errs by at most 2^-150, a difference whose result is subnormal
// is exact). A - B is affine in the pixel and |A| + |B| convex, so
// A - B + 3.1 u (|A| + |B|) + 2^-140 < 0 at the four corners implies a
// float32 edge strictly below zero (never -0.0, which would pass >= 0) at
// every pixel centre between them; 3.1 u and 2^-140 also cover the float64
// evaluation's own rounding. "Positive" is the mirror test. A NaN or
// infinite coordinate makes the tests false, so the face is kept. (The
// kernel is built without -ftz, so subnormals are kept.)
//
// Bound: on the differentiable primitive frames (<= 168 faces) and the face
// soup (64 faces) the background read and the image and winner writes (28
// bytes per pixel); on a texture strip (one camera, 512 x ~1,000 pixels,
// ~17,000-60,000 faces) the float64 cull, every face in every tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr float kBigZ = 1e9f;
constexpr float kAreaEps = 1e-9f;
// 3.1 * 2^-24 and 2^-140
constexpr double kErr = 3.1 * 5.9604644775390625e-08;
constexpr double kTiny = 7.174648137343064e-43;

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

__global__ void __launch_bounds__(kThreads)
hard_faces_kernel(const float* __restrict__ corners,   // (B, F, 3, 2)
                  const float* __restrict__ z,         // (B, F)
                  const float* __restrict__ color,     // (B, F, 3)
                  const float* __restrict__ bg,        // (B, 3, H, W)
                  int n_faces, int height, int width,
                  float* __restrict__ out,             // (B, 3, H, W)
                  int* __restrict__ winner) {          // (B, H, W)
  __shared__ float4 s_edge[3][kThreads];
  __shared__ float s_z[kThreads];
  __shared__ int s_index[kThreads];
  __shared__ int s_count[kWarps];

  const int cam = blockIdx.y;
  const int tiles_w = (width + kTile - 1) / kTile;
  const int row0 = (blockIdx.x / tiles_w) * kTile;
  const int col0 = (blockIdx.x % tiles_w) * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = row0 + tid / kTile, col = col0 + tid % kTile;
  const bool live = row < height && col < width;
  const float px = (float)row + 0.5f;
  const float py = (float)col + 0.5f;
  const TileCentres tile{(double)row0 + 0.5, (double)min(row0 + kTile, height) - 0.5,
                         (double)col0 + 0.5, (double)min(col0 + kTile, width) - 0.5};
  const float* cam_corners = corners + (size_t)cam * n_faces * 6;
  const float* cam_z = z + (size_t)cam * n_faces;

  float best_z = kBigZ;
  int best = -1;
  for (int s = 0; s < n_faces; s += kThreads) {
    const int f = s + tid;
    float4 e[3];
    float fz = kBigZ;
    bool keep = false;
    if (f < n_faces) {
      const float* c = cam_corners + (size_t)f * 6;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int n = (k + 1) % 3;
        e[k] = make_float4(c[2 * k], c[2 * k + 1], __fsub_rn(c[2 * n], c[2 * k]),
                           __fsub_rn(c[2 * n + 1], c[2 * k + 1]));
      }
      const float area = __fsub_rn(__fmul_rn(e[0].z, __fsub_rn(c[5], c[1])),
                                   __fmul_rn(e[0].w, __fsub_rn(c[4], c[0])));
      fz = cam_z[f];
      keep = fabsf(area) > kAreaEps && fz < kBigZ;
      if (keep) {
        bool neg[3], pos[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) edge_sign(e[k], tile, neg[k], pos[k]);
        keep = !((neg[0] || neg[1] || neg[2]) && (pos[0] || pos[1] || pos[2]));
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_count[warp] = __popc(bits);
    __syncthreads();                       // the last round is folded; counts in
    int pos = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) pos = total;
      total += s_count[w];
    }
    if (keep) {
      const int at = pos + __popc(bits & ((1u << lane) - 1u));
#pragma unroll
      for (int k = 0; k < 3; ++k) s_edge[k][at] = e[k];
      s_z[at] = fz;
      s_index[at] = f;
    }
    __syncthreads();
    for (int i = 0; i < total; ++i) {
      const float e0 = edge_value(s_edge[0][i], px, py);
      const float e1 = edge_value(s_edge[1][i], px, py);
      const float e2 = edge_value(s_edge[2][i], px, py);
      const bool covered = ((e0 >= 0.0f) & (e1 >= 0.0f) & (e2 >= 0.0f))
                           | ((e0 <= 0.0f) & (e1 <= 0.0f) & (e2 <= 0.0f));
      const float zi = s_z[i];
      if (covered && zi < best_z) {
        best_z = zi;
        best = s_index[i];
      }
    }
  }
  if (!live) return;

  const size_t plane = (size_t)height * width;
  const size_t o = (size_t)cam * 3 * plane + (size_t)row * width + col;
  if (best >= 0) {
    const float* c = color + ((size_t)cam * n_faces + best) * 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[o + ch * plane] = c[ch];
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[o + ch * plane] = bg[o + ch * plane];
  }
  winner[(size_t)cam * plane + (size_t)row * width + col] = best;
}

}  // namespace

extern "C" int tds_hard_faces(const float* corners, const float* z, const float* color,
                              const float* bg, int batch, int n_faces, int height,
                              int width, float* out, int* winner, cudaStream_t stream) {
  const int tiles = ((height + kTile - 1) / kTile) * ((width + kTile - 1) / kTile);
  hard_faces_kernel<<<dim3(tiles, batch), kThreads, 0, stream>>>(
      corners, z, color, bg, n_faces, height, width, out, winner);
  return (int)cudaGetLastError();
}
