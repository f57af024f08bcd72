// The grouped soft raster's accumulators over any number of faces: the
// forward (B5a) and its recompute backward (B5b), each ONE launch per render
// covering every face group, each block first culling the faces that cannot
// reach its pixel tile.
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
// Blocks: one per 16 x 16 pixel tile (row-major over ceil(R / 16)^2 tiles)
// per camera, one thread per pixel (px, py) = (row + 0.5, col + 0.5), the
// threads of a ragged last tile masked.
//
// Phase 1 of both kernels is the per-tile face cull of soft_face.cuh
// (list_tile_faces, shared with soft_raster.cu; its comment says why
// skipping is exact): the block scans the camera's faces 256 at a time, one
// face per thread, and appends the survivors in ascending face order
// (ballot and prefix count, no atomics) to its row of a wrapper-allocated
// int32 list (B, tiles, F), and writes their count to (B, tiles). The
// listed faces of one group form a run (a segment) of at most 128, staged
// into the group's table in shared memory.
//
// Forward, per pixel: each listed group's partials start from num 0, den 0,
// transp 1 and take its listed faces in ascending order (soft_face.cuh:
// face_terms); the totals combine in group order as above. By the cull's
// argument this is bit for bit the sum over every face. Outputs num (B, 3, R,
// R), den (B, R, R), transp (B, R, R).
//
// Backward, for the cotangents gnum, gden, gtransp of the three totals:
// every group receives gnum and gden, and the cotangent of its t_g,
//   gtr_g = P_g * S_g,  P_g = t_0 * ... * t_{g-1} (the forward's running
//   transp before g), S_{G-1} = gtransp, S_g = S_{g+1} * t_{g+1},
// the order in which the reference's autodiff of transp = transp * t_g
// forms it; absent groups have t_g = 1 and are not visited. Pass 1
// recomputes t_g of each listed group at the block's pixels into a
// wrapper-allocated scratch (B, G, R*R), then walks the listed groups
// downwards replacing t_g by S_g. Pass 2 takes the listed groups in order:
// the segment's exclusive prefix products in ascending order into shared
// memory (never by division: a face that covers a pixel fully has 1 - alpha
// == 0), then its faces in descending order with a running suffix product,
// forming the 13 gradient terms per face of _accum_bwd_kernel with
// dl/dalpha = zw * dl/dw - gtr_g * prod_{f' != f} (1 - alpha_f').
//
// Reduction: the blocks of one camera run in parallel, so each block writes
// deterministic partial sums of its listed faces into a zero-filled (B,
// tiles, F, 13): a fixed-order warp shuffle tree, then the warps' partials
// added in warp order. The wrapper finishes with one sum over tiles. No
// atomics, so gradients repeat bit for bit.
//
// Bound: per listed (pixel, face) the forward evaluates 3 exp and 3
// reciprocals on the special-function units and ~40 float32 operations; the
// backward evaluates the face terms three times (pass 1, prefix, suffix) and
// sums 13 terms over each warp. On the Town02 road mesh (~17,000 faces, 133
// groups) ~3.4% of the (pixel, face) pairs lie in a tile their face can
// reach, so the cull's scan (3 float64 edge tests per face and tile, the
// coefficients read from L2) is small beside the raster. Shared memory per
// block: the forward 6.7 KB of face table (static); the backward 191 KB at
// a group of 128 (face table, prefix column of 128 x 256 floats and 8 warps'
// reduction slots).

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_face.cuh"

namespace {

using namespace tds;

constexpr int kMaxGroup = 128;
constexpr int kThreads = kTileThreads;
constexpr int kWarps = kTileWarps;

// The segment from list[i]: the run of listed faces in the group of
// list[i] (at most `group`), staged as rows of s_face. Returns its length;
// every thread of the block calls it, and its first barrier also ends
// every thread's use of the previous segment's shared memory.
__device__ int stage_segment(const float* coef, const float* zw,
                             const float* color, size_t cam_first,
                             const int* list, int i, int count, int group,
                             float* s_face) {
  const int k = threadIdx.x;
  const int g = list[i] / group;
  const int f = (k < group && i + k < count) ? list[i + k] : -1;
  const bool in = f >= 0 && f / group == g;
  const int n = __syncthreads_count(in);
  if (in) {
    const size_t face = cam_first + f;
    float* row = s_face + k * kFaceFloats;
#pragma unroll
    for (int j = 0; j < 9; ++j) row[j] = coef[face * 9 + j];
    row[9] = zw[face];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) row[10 + ch] = color[face * 3 + ch];
  }
  __syncthreads();
  return n;
}

// the length of the segment that ends just before list[j]
__device__ int segment_before(const int* list, int j, int group) {
  const int k = threadIdx.x;
  const int g = list[j - 1] / group;
  return __syncthreads_count(k < group && j - 1 - k >= 0
                             && list[j - 1 - k] / group == g);
}

__global__ void __launch_bounds__(kThreads)
accum_fwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                 const float* __restrict__ color, int n_faces, int group,
                 int res, int* list, int* __restrict__ counts,
                 float* __restrict__ num, float* __restrict__ den,
                 float* __restrict__ transp) {
  __shared__ float s_face[kMaxGroup * kFaceFloats];
  __shared__ int s_warp[kWarps];
  const int cam = blockIdx.y;
  const Tile tile = block_tile(res);
  const size_t cam_first = (size_t)cam * n_faces;
  const size_t block = (size_t)cam * gridDim.x + blockIdx.x;
  int* my_list = list + block * n_faces;
  const int count = list_tile_faces(coef, cam_first, n_faces, tile, my_list,
                                    counts + block, s_warp);

  float tot_num[3] = {0.0f, 0.0f, 0.0f};
  float tot_den = 0.0f;
  float tot_transp = 1.0f;
  for (int i = 0; i < count;) {
    const int len = stage_segment(coef, zw, color, cam_first, my_list, i, count,
                                  group, s_face);
    float n[3] = {0.0f, 0.0f, 0.0f};
    float d = 0.0f;
    float t = 1.0f;
    for (int f = 0; f < len; ++f) {
      const float* fc = s_face + f * kFaceFloats;
      const FaceTerms ft = face_terms(fc, tile.px, tile.py);
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
    i += len;
  }
  if (!tile.live) return;
  const size_t plane = (size_t)res * res;
  const size_t pix = (size_t)tile.row * res + tile.col;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    num[((size_t)cam * 3 + ch) * plane + pix] = tot_num[ch];
  den[(size_t)cam * plane + pix] = tot_den;
  transp[(size_t)cam * plane + pix] = tot_transp;
}

__global__ void __launch_bounds__(kThreads)
accum_bwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                 const float* __restrict__ color,
                 const float* __restrict__ gnum,     // (B, 3, R, R)
                 const float* __restrict__ gden,     // (B, R, R)
                 const float* __restrict__ gtransp,  // (B, R, R)
                 int n_faces, int group, int res,
                 int* list,                          // (B, tiles, F)
                 int* __restrict__ counts,           // (B, tiles)
                 float* __restrict__ scratch,        // (B, G, R, R)
                 float* __restrict__ partial) {      // (B, tiles, F, 13), zeros
  extern __shared__ float smem[];
  float* s_face = smem;                                  // group * 13
  float* s_prefix = s_face + group * kFaceFloats;        // group * kThreads
  float* s_red = s_prefix + group * kThreads;            // kWarps * group * 13
  __shared__ int s_warp[kWarps];
  const int cam = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const Tile tile = block_tile(res);
  const bool live = tile.live;
  const int n_groups = n_faces / group;
  const size_t plane = (size_t)res * res;
  const size_t pix = live ? (size_t)tile.row * res + tile.col : 0;
  const size_t cam_first = (size_t)cam * n_faces;
  const size_t block = (size_t)cam * gridDim.x + blockIdx.x;
  int* my_list = list + block * n_faces;
  // this pixel's slot of group 0; group g is g * plane further
  float* slot = scratch + (size_t)cam * n_groups * plane + pix;
  const int count = list_tile_faces(coef, cam_first, n_faces, tile, my_list,
                                    counts + block, s_warp);

  // pass 1: each listed group's transparency t_g at this pixel
  for (int i = 0; i < count;) {
    const int len = stage_segment(coef, zw, color, cam_first, my_list, i, count,
                                  group, s_face);
    float t = 1.0f;
    for (int f = 0; f < len; ++f) {
      const FaceTerms ft = face_terms(s_face + f * kFaceFloats, tile.px, tile.py);
      t = __fmul_rn(t, __fsub_rn(1.0f, ft.alpha));
    }
    if (live) slot[(size_t)(my_list[i] / group) * plane] = t;
    i += len;
  }

  float gch[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    gch[ch] = live ? gnum[((size_t)cam * 3 + ch) * plane + pix] : 0.0f;
  const float gd = live ? gden[(size_t)cam * plane + pix] : 0.0f;
  // the cotangent carried down the product chain: slot g takes S_g
  float carried = live ? gtransp[(size_t)cam * plane + pix] : 0.0f;
  for (int j = count; j > 0;) {
    const int len = segment_before(my_list, j, group);
    if (live) {
      float* s = slot + (size_t)(my_list[j - 1] / group) * plane;
      const float t = *s;
      *s = carried;
      carried = __fmul_rn(carried, t);
    }
    j -= len;
  }

  // pass 2: per listed group, prefix products, then descending faces
  float running = 1.0f;   // P_g
  for (int i = 0; i < count;) {
    const int len = stage_segment(coef, zw, color, cam_first, my_list, i, count,
                                  group, s_face);
    const float gtr = live
        ? __fmul_rn(running, slot[(size_t)(my_list[i] / group) * plane]) : 0.0f;
    float t = 1.0f;
    for (int f = 0; f < len; ++f) {
      const FaceTerms ft = face_terms(s_face + f * kFaceFloats, tile.px, tile.py);
      s_prefix[f * kThreads + tid] = t;
      t = __fmul_rn(t, __fsub_rn(1.0f, ft.alpha));
    }
    float suffix = 1.0f;
    for (int f = len - 1; f >= 0; --f) {
      const float* fc = s_face + f * kFaceFloats;
      const FaceTerms ft = face_terms(fc, tile.px, tile.py);
      const float except_f = __fmul_rn(s_prefix[f * kThreads + tid], suffix);
      suffix = __fmul_rn(suffix, __fsub_rn(1.0f, ft.alpha));
      const float dl_dw = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(gch[0], fc[10]), __fmul_rn(gch[1], fc[11])),
                    __fmul_rn(gch[2], fc[12])), gd);
      // d transp_g / d alpha_f = -prod_{f' != f} (1 - alpha_f')
      const float dl_dalpha = __fsub_rn(__fmul_rn(fc[9], dl_dw),
                                        __fmul_rn(gtr, except_f));
      float vals[kFaceFloats];
      face_grad_terms(ft, ft.alpha, dl_dalpha, dl_dw, gch, fc[9], tile.px,
                      tile.py, vals);
#pragma unroll
      for (int k = 0; k < kFaceFloats; ++k) {
        const float v = warp_sum(live ? vals[k] : 0.0f);
        if (lane == 0) s_red[(warp * group + f) * kFaceFloats + k] = v;
      }
    }
    __syncthreads();
    const int per_warp = group * kFaceFloats;
    float* out = partial + block * n_faces * kFaceFloats;
    for (int r = tid; r < len * kFaceFloats; r += blockDim.x) {
      float acc = s_red[r];
#pragma unroll
      for (int wi = 1; wi < kWarps; ++wi)
        acc = __fadd_rn(acc, s_red[wi * per_warp + r]);
      out[(size_t)my_list[i + r / kFaceFloats] * kFaceFloats + r % kFaceFloats] = acc;
    }
    running = __fmul_rn(running, t);
    i += len;
  }
}

size_t bwd_smem_bytes(int group) {
  return sizeof(float) * ((size_t)group * kFaceFloats
                          + (size_t)group * kThreads
                          + (size_t)kWarps * group * kFaceFloats);
}

bool bad_shape(int batch, int n_faces, int group, int res) {
  return group < 1 || group > kMaxGroup || n_faces < group
      || n_faces % group != 0 || res < 1 || batch < 1 || batch > 65535;
}

dim3 grid_of(int batch, int res) {
  const int per_side = (res + kTile - 1) / kTile;
  return dim3(per_side * per_side, batch);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// group size outside 1..128 or a face count that is not a whole number of
// groups; neither synchronizes. Both need an int32 list (B, tiles, F) and
// int32 counts (B, tiles), tiles = ceil(R / 16)^2, into which they write
// each tile's faces; the backward also a float32 scratch (B, F / group, R,
// R) and a zero-filled float32 partial (B, tiles, F, 13).
extern "C" int tds_soft_accum_fwd(const float* coef, const float* zw,
                                  const float* color, int batch, int n_faces,
                                  int group, int res, void* list, void* counts,
                                  void* num, void* den, void* transp,
                                  void* stream) {
  if (bad_shape(batch, n_faces, group, res)) return (int)cudaErrorInvalidValue;
  accum_fwd_kernel<<<grid_of(batch, res), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, n_faces, group, res, static_cast<int*>(list),
      static_cast<int*>(counts), static_cast<float*>(num),
      static_cast<float*>(den), static_cast<float*>(transp));
  return (int)cudaGetLastError();
}

extern "C" int tds_soft_accum_bwd(const float* coef, const float* zw,
                                  const float* color, const float* gnum,
                                  const float* gden, const float* gtransp,
                                  int batch, int n_faces, int group, int res,
                                  void* list, void* counts, void* scratch,
                                  void* partial, void* stream) {
  if (bad_shape(batch, n_faces, group, res)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes(group);
  cudaError_t err = cudaFuncSetAttribute(
      accum_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  accum_bwd_kernel<<<grid_of(batch, res), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, gnum, gden, gtransp, n_faces, group, res,
      static_cast<int*>(list), static_cast<int*>(counts),
      static_cast<float*>(scratch), static_cast<float*>(partial));
  return (int)cudaGetLastError();
}
