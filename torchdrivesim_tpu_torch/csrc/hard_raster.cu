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
// (a*px + b*py) + c, each operation rounded on its own (round-to-nearest
// intrinsics, so nvcc cannot contract them into FMAs) as the plain PyTorch
// version (ops/hard.py) computes it: the two agree bit for bit. Channel
// unpack is ((w >> 16) & 255) * float32(1/255) and so on.
//
// Layout: one thread per pixel, one block per (256-pixel tile, camera). The
// block stages the camera's face table in shared memory 128 faces at a time
// (9 edge coefficients and one or two ints per face) and every thread keeps
// its running winner in registers, so shared memory stays at 5.6 KB for
// any face count; the TPU kernel's sequential chunk loop becomes this loop.
//
// Bound: at the RL configuration (12 faces, 64 x 64) a pixel costs 12 x ~17
// float32 operations against 24 bytes of background read and image written:
// bytes bound it. On a whole uncculled map mesh (~17k faces) the operations
// dominate: ~17 per (pixel, face), all from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_index.cuh"

namespace {

using tds::affine;
using tds::kInv255;

constexpr int kThreads = 256;
constexpr int kFaceChunk = 128;
constexpr int kPackedSentinel = 0x7FFFFFFF;
constexpr int kCoveredBelow = 127 << 24;
constexpr int kZSentinel = 0x7F800000;
constexpr int kNoColor = 1 << 24;

template <bool kPacked>
__global__ void __launch_bounds__(kThreads)
hard_raster_kernel(const float* __restrict__ coef,   // (B, 3, F, 3)
                   const int* __restrict__ key,      // (B, F) packed or z bits
                   const int* __restrict__ rgb,      // (B, F) RGB8 (chunked)
                   const float* __restrict__ bg,     // (B, 3, res * res)
                   int n_faces, int res,
                   float* __restrict__ out) {        // (B, 3, res * res)
  __shared__ float s_coef[kFaceChunk * 9];
  __shared__ int s_key[kFaceChunk];
  __shared__ int s_rgb[kFaceChunk];

  const int cam = blockIdx.y;
  const int plane = res * res;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  const float px = (float)(pix / res) + 0.5f;
  const float py = (float)(pix % res) + 0.5f;
  const float* cam_coef = coef + (size_t)cam * 9 * n_faces;
  const int* cam_key = key + (size_t)cam * n_faces;

  int best = kPacked ? kPackedSentinel : kZSentinel;
  int best_rgb = kNoColor;
  for (int s = 0; s < n_faces; s += kFaceChunk) {
    const int n = min(kFaceChunk, n_faces - s);
    __syncthreads();                      // the previous chunk is consumed
    // edge k's (a, b, c) of faces s .. s+n are contiguous in the input
    for (int i = threadIdx.x; i < 9 * n; i += blockDim.x) {
      const int k = i / (3 * n);
      const int rem = i - k * 3 * n;
      s_coef[(rem / 3) * 9 + k * 3 + rem % 3] =
          cam_coef[((size_t)k * n_faces + s) * 3 + rem];
    }
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_key[i] = cam_key[s + i];
      if (!kPacked) s_rgb[i] = rgb[(size_t)cam * n_faces + s + i];
    }
    __syncthreads();

    int cz = kZSentinel, cr = kNoColor;   // this chunk's winner (chunked)
    for (int f = 0; f < n; ++f) {
      const float* k = s_coef + f * 9;
      const float e0 = affine(k[0], px, k[1], py, k[2]);
      const float e1 = affine(k[3], px, k[4], py, k[5]);
      const float e2 = affine(k[6], px, k[7], py, k[8]);
      // == min(e0, e1, e2) >= 0, false on NaN like the reference
      if (e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f) {
        if (kPacked) {
          best = min(best, s_key[f]);
        } else {
          const int z = s_key[f];
          if (z < cz) {
            cz = z;
            cr = s_rgb[f];
          } else if (z == cz) {
            cr = min(cr, s_rgb[f]);
          }
        }
      }
    }
    if (!kPacked && cz < best) {
      best = cz;
      best_rgb = cr;
    }
  }
  if (pix >= plane) return;

  const bool covered = kPacked ? best < kCoveredBelow : best < kZSentinel;
  const int w = kPacked ? best : best_rgb;
  const size_t o = (size_t)cam * 3 * plane + pix;
  if (covered) {
    out[o] = __fmul_rn((float)((w >> 16) & 255), kInv255);
    out[o + plane] = __fmul_rn((float)((w >> 8) & 255), kInv255);
    out[o + 2 * plane] = __fmul_rn((float)(w & 255), kInv255);
  } else {
    out[o] = bg[o];
    out[o + plane] = bg[o + plane];
    out[o + 2 * plane] = bg[o + 2 * plane];
  }
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success); neither synchronizes.
extern "C" int tds_hard_raster_packed(const float* coef, const int* packed,
                                      const float* bg, int batch, int n_faces,
                                      int res, void* out, void* stream) {
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  hard_raster_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, packed, nullptr, bg, n_faces, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int tds_hard_raster_chunked(const float* coef, const int* zbits,
                                       const int* rgb, const float* bg,
                                       int batch, int n_faces, int res,
                                       void* out, void* stream) {
  dim3 grid((res * res + kThreads - 1) / kThreads, batch);
  hard_raster_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      coef, zbits, rgb, bg, n_faces, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
