// Hard z-priority rasterization of per-camera triangle sets, composited
// over a given background: the reference's hard mesh render.
//
// Replaces the reference's TPU kernels ops/pallas_rasterize.py:
//   * _raster_kernel_packed (at most 127 faces): each face carries one int32
//     rank << 24 | RGB8 (R in bits 16-23); a pixel's winner is the minimum
//     over the faces whose three edge values are all >= 0, and it is covered
//     iff that minimum is below 127 << 24 (sentinel 0x7FFFFFFF);
//   * _raster_kernel (more faces): z as order-preserving float bits and
//     RGB8 in two int32s, folded over chunks of 128 faces. Within a chunk the
//     winner is the minimum z-bits and its color the minimum RGB8 among the
//     faces with exactly those bits; a later chunk replaces the running
//     winner only if strictly less. Covered iff below 0x7F800000.
// Edge k of face f at pixel center (px, py) = (row + 0.5, col + 0.5) is
// (a*px + b*py) + c, each operation rounded on its own (tds::affine, so nvcc
// cannot contract them into FMAs) as the plain PyTorch version (ops/hard.py)
// computes it: the two agree bit for bit. Channel unpack is
// ((w >> 16) & 255) * float32(1/255) and so on.
//
// Layout: one block of 256 threads per 16 x 16 pixel tile of one camera, one
// thread per pixel (row0 + tid / 16, col0 + tid % 16); the grid is
// (ceil(res / 16)^2 tiles, cameras). The pixels of a ragged last tile row or
// column run the loop and write nothing.
//
// Per-tile cull. The block scans its camera's faces in rounds, each thread
// testing one face per slot (one slot for the packed kernel, two for the
// chunked one, whose ~17,000 faces then pass 512 at a time), and drops a
// face from the tile iff its key is the sentinel or one of its edges is
// negative at every pixel of the tile by tds::tri_edge_out: the float64
// test over the tile's four extreme pixel centres (the last row and column
// clamped to the frame) with the slack delta whose argument stands atop
// prim_winner.cuh (B1 and B7 run the same test). So a dropped face is
// inside at no pixel of the tile, and the fold over the survivors equals
// the fold over all faces. NaN and infinite coefficients keep the face.
// The survivors are compacted into shared memory in ascending face order
// (__ballot_sync, __popc and a prefix over the (slot, warp) counts, no
// atomics, no list in device memory), each as three float4 edges with its
// key in the first edge's w and its RGB8 in the second's; then every
// thread folds them into its pixel's winner, two at a time, and the block
// scans the next round. Shared memory: 12 KB (packed) or 24 KB (chunked),
// for any face count.
//
// The chunked fold keeps the reference's chunk semantics. A round starts
// at a multiple of its length, so it covers whole chunks of 128: slot j's
// warps 0-3 hold faces s + 256 j .. + 127, warps 4-7 the next 128. Each
// chunk's survivors are one contiguous run, folded into a fresh (cz, cr)
// (the minimum z-bits, then the minimum RGB8 among exactly those bits),
// which then replaces the running winner only if strictly less: on a z tie
// across chunks the earlier chunk's color stands. The packed minimum is
// order-free.
//
// Bound: at the RL configuration (12 faces, 64 x 64, 1024 cameras) the
// background read and the image write (24 bytes per pixel), which go out
// in 64-byte row segments. On the untextured Town02 mesh (~17,000 faces
// per camera) the scan's float64 edge tests, every face in every tile, and
// in the busiest tiles the fold: the corner test keeps faces smaller than
// a pixel and thin faces just outside the tile, ~275 per tile on average
// and ~1,000 in the busiest, where ~74 overlap a tile by bounding box.

#include <cuda_runtime.h>
#include <stdint.h>

#include "prim_winner.cuh"

namespace {

using tds::affine;
using tds::kInv255;

constexpr int kTile = tds::kPrimTile;
constexpr int kThreads = kTile * kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kFaceChunk = 128;
static_assert(kThreads == 2 * kFaceChunk, "a slot covers two chunks: warps 0-3, 4-7");
constexpr int kPackedSentinel = tds::kPrimSentinel;
constexpr int kZSentinel = 0x7F800000;
constexpr int kNoColor = 1 << 24;
constexpr int kUnroll = 2;                 // survivors folded at once

// Face f's three edges (a, b, c), key in e[0].w and RGB8 (chunked) in
// e[1].w; past the last face, the sentinel.
struct Face {
  float4 e[3];
};

__device__ __forceinline__ Face load_face(const float* __restrict__ cam_coef,
                                          const int* __restrict__ cam_key,
                                          const int* __restrict__ cam_rgb,
                                          int n_faces, int f, int sentinel) {
  Face face;
  if (f < n_faces) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float* c = cam_coef + ((size_t)k * n_faces + f) * 3;
      face.e[k] = make_float4(c[0], c[1], c[2], 0.0f);
    }
    face.e[0].w = __int_as_float(cam_key[f]);
    if (cam_rgb) face.e[1].w = __int_as_float(cam_rgb[f]);
  } else {
#pragma unroll
    for (int k = 0; k < 3; ++k) face.e[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    face.e[0].w = __int_as_float(sentinel);
  }
  return face;
}

// == min(e0, e1, e2) >= 0, false on NaN like the reference; no branch
__device__ __forceinline__ bool inside(float4 k0, float4 k1, float4 k2, float px,
                                       float py) {
  return (affine(k0.x, px, k0.y, py, k0.z) >= 0.0f)
         & (affine(k1.x, px, k1.y, py, k1.z) >= 0.0f)
         & (affine(k2.x, px, k2.y, py, k2.z) >= 0.0f);
}

// Fold the survivors s_edge[.][i0 .. i1-1], in order, into (key, rgb):
// packed, key = min(key, pack) over the inside ones; chunked, (key, rgb)
// is the run's (cz, cr), the minimum z-bits and the minimum RGB8 among
// exactly those bits. kUnroll survivors at a time are loaded and tested
// independently, so their latencies overlap; past i1 the last survivor
// is taken again, which changes neither fold.
template <bool kPacked, int kRound>
__device__ __forceinline__ void fold_run(float4 (*s_edge)[kRound], int i0, int i1,
                                         float px, float py, int& key, int& rgb) {
  for (int i = i0; i < i1; i += kUnroll) {
    bool in[kUnroll];
    int k[kUnroll], c[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int q = min(i + j, i1 - 1);
      const float4 e0 = s_edge[0][q], e1 = s_edge[1][q], e2 = s_edge[2][q];
      in[j] = inside(e0, e1, e2, px, py);
      k[j] = __float_as_int(e0.w);
      c[j] = __float_as_int(e1.w);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (!in[j]) continue;
      if (kPacked) {
        key = min(key, k[j]);
      } else if (k[j] < key) {
        key = k[j];
        rgb = c[j];
      } else if (k[j] == key) {
        rgb = min(rgb, c[j]);
      }
    }
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
hard_raster_kernel(const float* __restrict__ coef,   // (B, 3, F, 3)
                   const int* __restrict__ key,      // (B, F) packed or z bits
                   const int* __restrict__ rgb,      // (B, F) RGB8 (chunked)
                   const float* __restrict__ bg,     // (B, 3, res * res)
                   int n_faces, int res,
                   float* __restrict__ out) {        // (B, 3, res * res)
  // faces each thread tests per scan round: B6a's (at most 127) fit one
  // round of one; B6b's pass two at a time, overlapping their tests (a
  // third was no faster on an H100, a fourth spills registers)
  constexpr int kSlots = kPacked ? 1 : 2;
  constexpr int kRound = kSlots * kThreads;
  constexpr int kRuns = kRound / kFaceChunk;    // whole chunks per round
  constexpr int kSentinel = kPacked ? kPackedSentinel : kZSentinel;
  __shared__ float4 s_edge[3][kRound];
  __shared__ int s_count[kSlots * kWarps];

  const int cam = blockIdx.y;
  const int per_side = (res + kTile - 1) / kTile;
  const int row0 = (blockIdx.x / per_side) * kTile;
  const int col0 = (blockIdx.x % per_side) * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = row0 + tid / kTile, col = col0 + tid % kTile;
  const bool live = row < res && col < res;
  const float px = (float)row + 0.5f;
  const float py = (float)col + 0.5f;
  const tds::TileBox box{(double)row0 + 0.5, (double)min(row0 + kTile, res) - 0.5,
                         (double)col0 + 0.5, (double)min(col0 + kTile, res) - 0.5};
  const int plane = res * res;
  const size_t o = (size_t)cam * 3 * plane + (size_t)row * res + col;
  float back[3] = {0.0f, 0.0f, 0.0f};
  if (live) {                              // in flight during the scan
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) back[ch] = bg[o + (size_t)ch * plane];
  }
  const float* cam_coef = coef + (size_t)cam * 9 * n_faces;
  const int* cam_key = key + (size_t)cam * n_faces;
  const int* cam_rgb = kPacked ? nullptr : rgb + (size_t)cam * n_faces;

  int best = kSentinel, best_rgb = kNoColor;
  for (int s = 0; s < n_faces; s += kRound) {
    // slot j of thread tid tests face s + 256 j + tid
    Face face[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      face[j] = load_face(cam_coef, cam_key, cam_rgb, n_faces, s + j * kThreads + tid,
                          kSentinel);
    unsigned bits[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool keep = __float_as_int(face[j].e[0].w) != kSentinel
                        && !tds::tri_edge_out(face[j].e[0], box)
                        && !tds::tri_edge_out(face[j].e[1], box)
                        && !tds::tri_edge_out(face[j].e[2], box);
      bits[j] = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_count[j * kWarps + warp] = __popc(bits[j]);
    }
    __syncthreads();                       // the last round is folded; counts in
    // survivors go to shared memory in face order: by slot, then warp, then
    // lane; chunk r of the round is the run of (slot, warp) counts 4r .. 4r+3
    int run[kRuns + 1], pos[kSlots], total = 0;
#pragma unroll
    for (int c = 0; c < kSlots * kWarps; ++c) {
      if (c % (kWarps / 2) == 0) run[c / (kWarps / 2)] = total;
      if (c % kWarps == warp) pos[c / kWarps] = total;
      total += s_count[c];
    }
    run[kRuns] = total;
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if ((bits[j] >> lane) & 1u) {
        const int at = pos[j] + __popc(bits[j] & ((1u << lane) - 1u));
#pragma unroll
        for (int k = 0; k < 3; ++k) s_edge[k][at] = face[j].e[k];
      }
    }
    __syncthreads();

    if (kPacked) {
      fold_run<true>(s_edge, 0, run[kRuns], px, py, best, best_rgb);
    } else {
      // each chunk's winner replaces the running one only if strictly less
#pragma unroll
      for (int r = 0; r < kRuns; ++r) {
        int cz = kZSentinel, cr = kNoColor;
        fold_run<false>(s_edge, run[r], run[r + 1], px, py, cz, cr);
        if (cz < best) {
          best = cz;
          best_rgb = cr;
        }
      }
    }
  }
  if (!live) return;

  const bool covered = kPacked ? best < tds::kCoveredBelow : best < kZSentinel;
  const int w = kPacked ? best : best_rgb;
  if (covered) {
    out[o] = __fmul_rn((float)((w >> 16) & 255), kInv255);
    out[o + plane] = __fmul_rn((float)((w >> 8) & 255), kInv255);
    out[o + 2 * plane] = __fmul_rn((float)(w & 255), kInv255);
  } else {
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) out[o + (size_t)ch * plane] = back[ch];
  }
}

inline dim3 tile_grid(int res, int batch) {
  const int per_side = (res + kTile - 1) / kTile;
  return dim3(per_side * per_side, batch);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success); neither synchronizes.
extern "C" int tds_hard_raster_packed(const float* coef, const int* packed,
                                      const float* bg, int batch, int n_faces,
                                      int res, void* out, void* stream) {
  hard_raster_kernel<true><<<tile_grid(res, batch), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      coef, packed, nullptr, bg, n_faces, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int tds_hard_raster_chunked(const float* coef, const int* zbits,
                                       const int* rgb, const float* bg,
                                       int batch, int n_faces, int res,
                                       void* out, void* stream) {
  hard_raster_kernel<false><<<tile_grid(res, batch), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      coef, zbits, rgb, bg, n_faces, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
