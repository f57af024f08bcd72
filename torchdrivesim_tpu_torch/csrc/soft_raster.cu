// Differentiable (softmax-blend) soft rasterization of up to 128 faces per
// camera over a background: the forward kernel (B4a) and its recompute
// backward (B4b), each block first culling the faces that cannot reach its
// pixel tile.
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
// Backward: pass 1 repeats the forward and keeps each face's exclusive
// prefix product prod_{g<f} (1 - alpha_g) per pixel (never by division: a
// face that covers a pixel fully has 1 - alpha == 0); pass 2 walks the faces
// in descending order with a running suffix product, recomputes each face's
// terms (alpha bit for bit as in pass 1) and forms the 13 per-face gradient
// terms of the reference (gA, gB, gC per edge, gzw, gcolor) per pixel, plus
// gbg = g * transp.
//
// Blocks: one per 16 x 16 pixel tile per camera, one thread per pixel, the
// threads of a ragged last tile masked (soft_face.cuh: block_tile). Each
// block first lists the faces that can reach its tile, ascending, into
// shared memory (soft_face.cuh: list_tile_faces, the cull the grouped
// kernels share; at most 128 faces, so one round of one face per thread)
// and stages their 13-float rows; then every pixel folds only the listed
// faces, in the order above. The faces left out add exactly nothing there
// (the argument is in soft_face.cuh), so the forward and gbg equal the
// unculled sums bit for bit, and the backward's per-pixel terms of a listed
// face are the unculled ones.
//
// Reduction (backward): each block sums its listed faces' 13 terms over its
// pixels (a fixed-order warp shuffle tree, then the 8 warps' partials in
// warp order) and writes its whole (F, 13) row of a (B, tiles, F, 13)
// partial, zeros for the faces it did not list. With per-camera counters
// (int32, zero), the last block of each camera to finish (a __threadfence,
// then an atomic ticket) sums that camera's tile rows in tile order into
// gcoef, gzw and gcolor and sets its counter back to 0; without, the caller
// sums the partial. The atomics touch only the tickets, so gradients repeat
// bit for bit.
//
// Arithmetic: products and sums use round-to-nearest intrinsics, so nvcc
// cannot contract them into fused multiply-adds, and the logistic is
// __frcp_rn(1 + expf(-t)) with the accurate expf; the plain PyTorch versions
// (ops/soft.py) perform the same operations, so the forward and gbg agree
// with them bit for bit and the reduced sums to summation order.
//
// Bound: per (pixel, face) the forward evaluates 3 exp and 3 reciprocals on
// the special-function units, the backward twice that plus 13 reductions.
// At the IL configuration (16 cameras, 64 x 64, 24 faces) ~5% of the
// (camera, face, tile) triples can contribute (~1.2 faces per tile), so the
// special-function work of the listed pairs (~0.1 us forward, ~0.3 us
// backward) falls below the bytes (~1.6 MB forward, ~2.4 MB backward, ~0.5
// and ~0.7 us); both kernels are far below either, at the launch floor of
// 256 small blocks. Shared memory per block: the forward 7.2 KB (the face
// table and list, static); the backward, sized by F at launch, F * (13 +
// 256 + 8 * 13) floats of face table, prefix column and warp partials plus
// the list and each face's slot: 36 KB at F = 24, 192 KB at F = 128.

#include <cuda_runtime.h>
#include <stdint.h>

#include "soft_face.cuh"

namespace {

using namespace tds;

constexpr int kMaxFaces = 128;

// The faces of the camera that reach the block's tile: their indices into
// s_list, ascending, and their rows (kFaceFloats) into s_face in that order.
// With s_slot, also each face's row in the list, -1 for a face not listed.
// Every thread calls it; the tables are visible to the block on return.
__device__ __forceinline__ int stage_tile_faces(const float* coef, const float* zw,
                                                const float* color, size_t first,
                                                int n_faces, const Tile& tile,
                                                float* s_face, int* s_list,
                                                int* s_slot, int* s_warp) {
  const int tid = threadIdx.x;
  if (s_slot != nullptr && tid < n_faces) s_slot[tid] = -1;
  const int count = list_tile_faces(coef, first, n_faces, tile, s_list, nullptr,
                                    s_warp);
  if (tid < count) {
    const size_t face = first + s_list[tid];
    float* row = s_face + tid * kFaceFloats;
#pragma unroll
    for (int j = 0; j < 9; ++j) row[j] = coef[face * 9 + j];
    row[9] = zw[face];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) row[10 + ch] = color[face * 3 + ch];
    if (s_slot != nullptr) s_slot[s_list[tid]] = tid;
  }
  __syncthreads();
  return count;
}

__global__ void __launch_bounds__(kTileThreads)
soft_fwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                const float* __restrict__ color, const float* __restrict__ bg,
                int n_faces, int res, float* __restrict__ out) {
  __shared__ float s_face[kMaxFaces * kFaceFloats];
  __shared__ int s_list[kMaxFaces];
  __shared__ int s_warp[kTileWarps];
  const int cam = blockIdx.y;
  const Tile tile = block_tile(res);
  const int count = stage_tile_faces(coef, zw, color, (size_t)cam * n_faces,
                                     n_faces, tile, s_face, s_list, nullptr,
                                     s_warp);
  if (!tile.live) return;

  float num[3] = {0.0f, 0.0f, 0.0f};
  float den = 0.0f;
  float transp = 1.0f;
  for (int i = 0; i < count; ++i) {
    const float* fc = s_face + i * kFaceFloats;
    const FaceTerms ft = face_terms(fc, tile.px, tile.py);
    const float w = __fmul_rn(ft.alpha, fc[9]);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      num[ch] = __fadd_rn(num[ch], __fmul_rn(w, fc[10 + ch]));
    den = __fadd_rn(den, w);
    transp = __fmul_rn(transp, __fsub_rn(1.0f, ft.alpha));
  }
  const float inv_den = __frcp_rn(fmaxf(den, 1e-8f));
  const float cover = __fsub_rn(1.0f, transp);
  const size_t plane = (size_t)res * res;
  const size_t at = (size_t)cam * 3 * plane + (size_t)tile.row * res + tile.col;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
    out[at + ch * plane] = __fadd_rn(__fmul_rn(cover, __fmul_rn(num[ch], inv_den)),
                                     __fmul_rn(transp, bg[at + ch * plane]));
}

__global__ void __launch_bounds__(kTileThreads)
soft_bwd_kernel(const float* __restrict__ coef, const float* __restrict__ zw,
                const float* __restrict__ color, const float* __restrict__ bg,
                const float* __restrict__ g, int n_faces, int res,
                float* __restrict__ partial,     // (B, tiles, F, 13)
                float* __restrict__ gbg,         // (B, 3, R, R)
                int* __restrict__ counters,      // (B,) zeros, or null
                float* __restrict__ gcoef,       // (B, F, 9)
                float* __restrict__ gzw,         // (B, F)
                float* __restrict__ gcolor) {    // (B, F, 3)
  extern __shared__ float smem[];
  float* s_face = smem;                                    // F * 13
  float* s_prefix = s_face + n_faces * kFaceFloats;        // F * kTileThreads
  float* s_red = s_prefix + n_faces * kTileThreads;        // kTileWarps * F * 13
  int* s_list = reinterpret_cast<int*>(s_red + kTileWarps * n_faces * kFaceFloats);
  int* s_slot = s_list + n_faces;                          // F
  __shared__ int s_warp[kTileWarps];
  __shared__ bool s_last;
  const int cam = blockIdx.y;
  const int tid = threadIdx.x;
  const Tile tile = block_tile(res);
  const bool live = tile.live;
  const float px = tile.px, py = tile.py;
  const size_t plane = (size_t)res * res;
  const size_t cam_off = (size_t)cam * 3 * plane
      + (live ? (size_t)tile.row * res + tile.col : 0);
  const int count = stage_tile_faces(coef, zw, color, (size_t)cam * n_faces,
                                     n_faces, tile, s_face, s_list, s_slot,
                                     s_warp);

  // pass 1: exclusive prefix products, accumulators
  float num[3] = {0.0f, 0.0f, 0.0f};
  float den = 0.0f;
  float transp = 1.0f;
  for (int i = 0; i < count; ++i) {
    const float* fc = s_face + i * kFaceFloats;
    const FaceTerms ft = face_terms(fc, px, py);
    s_prefix[i * kTileThreads + tid] = transp;
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

  // pass 2: descending listed faces, running suffix product, per-face sums
  const int warp = tid / 32;
  const int lane = tid % 32;
  float suffix = 1.0f;
  for (int i = count - 1; i >= 0; --i) {
    const float* fc = s_face + i * kFaceFloats;
    const FaceTerms ft = face_terms(fc, px, py);
    const float except_f = __fmul_rn(s_prefix[i * kTileThreads + tid], suffix);
    suffix = __fmul_rn(suffix, __fsub_rn(1.0f, ft.alpha));
    const float dl_dw = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(p[0], fc[10]), __fmul_rn(p[1], fc[11])),
                  __fmul_rn(p[2], fc[12])), q);
    const float dl_dalpha = __fadd_rn(__fmul_rn(fc[9], dl_dw),
                                      __fmul_rn(dl_da, except_f));
    float vals[kFaceFloats];
    face_grad_terms(ft, ft.alpha, dl_dalpha, dl_dw, p, fc[9], px, py, vals);
#pragma unroll
    for (int k = 0; k < kFaceFloats; ++k) {
      const float v = warp_sum(live ? vals[k] : 0.0f);
      if (lane == 0) s_red[(warp * n_faces + i) * kFaceFloats + k] = v;
    }
  }
  __syncthreads();

  // the block's row of the partial: every face, zeros for the unlisted
  const int per_block = n_faces * kFaceFloats;
  float* row = partial + ((size_t)cam * gridDim.x + blockIdx.x) * per_block;
  for (int r = tid; r < per_block; r += kTileThreads) {
    const int slot = s_slot[r / kFaceFloats];
    float acc = 0.0f;
    if (slot >= 0) {
      const int at = slot * kFaceFloats + r % kFaceFloats;
      acc = s_red[at];
#pragma unroll
      for (int w = 1; w < kTileWarps; ++w)
        acc = __fadd_rn(acc, s_red[w * per_block + at]);
    }
    row[r] = acc;
  }
  if (counters == nullptr) return;

  // the camera's last block sums its tile rows in tile order
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(counters + cam, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  const float* rows = partial + (size_t)cam * gridDim.x * per_block;
  for (int r = tid; r < per_block; r += kTileThreads) {
    float acc = __ldcg(rows + r);
    for (int t = 1; t < (int)gridDim.x; ++t)
      acc = __fadd_rn(acc, __ldcg(rows + (size_t)t * per_block + r));
    const size_t face = (size_t)cam * n_faces + r / kFaceFloats;
    const int k = r % kFaceFloats;
    if (k < 9) gcoef[face * 9 + k] = acc;
    else if (k == 9) gzw[face] = acc;
    else gcolor[face * 3 + k - 10] = acc;
  }
  if (tid == 0) counters[cam] = 0;
}

size_t bwd_smem_bytes(int n_faces) {
  return sizeof(float) * (size_t)n_faces
             * (kFaceFloats + kTileThreads + kTileWarps * kFaceFloats)
         + sizeof(int) * 2 * (size_t)n_faces;
}

cudaError_t set_bwd_smem(int n_faces) {
  return cudaFuncSetAttribute(soft_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bwd_smem_bytes(n_faces));
}

bool bad_shape(int batch, int n_faces, int res) {
  return n_faces < 1 || n_faces > kMaxFaces || res < 1 || batch < 1
      || batch > 65535;
}

dim3 grid_of(int batch, int res) {
  const int per_side = (res + kTile - 1) / kTile;
  return dim3(per_side * per_side, batch);
}

template <typename Kernel>
cudaError_t kernel_stats(Kernel kernel, size_t dynamic_smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[2] = (int)attr.localSizeBytes;
  out[3] = (int)(attr.sharedSizeBytes + dynamic_smem);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 1, kernel,
                                                       kTileThreads, dynamic_smem);
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on ``stream`` and
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// a face count outside 1..128, a res below 1 or a batch outside 1..65535;
// neither synchronizes. The backward needs a float32 partial (B, tiles, F,
// 13), tiles = ceil(R / 16)^2, which it fills whole; with int32 counters
// (B, zeros, left at zeros) it also writes gcoef (B, F, 3, 3), gzw (B, 1, F)
// and gcolor (B, F, 3), which are not touched when counters is null. Two
// launches sharing counters must not run at once.
extern "C" int tds_soft_raster_fwd(const float* coef, const float* zw,
                                   const float* color, const float* bg,
                                   int batch, int n_faces, int res, void* out,
                                   void* stream) {
  if (bad_shape(batch, n_faces, res)) return (int)cudaErrorInvalidValue;
  soft_fwd_kernel<<<grid_of(batch, res), kTileThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, bg, n_faces, res, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

extern "C" int tds_soft_raster_bwd(const float* coef, const float* zw,
                                   const float* color, const float* bg,
                                   const float* g, int batch, int n_faces,
                                   int res, void* partial, void* gbg,
                                   void* counters, void* gcoef, void* gzw,
                                   void* gcolor, void* stream) {
  if (bad_shape(batch, n_faces, res)) return (int)cudaErrorInvalidValue;
  cudaError_t err = set_bwd_smem(n_faces);
  if (err != cudaSuccess) return (int)err;
  soft_bwd_kernel<<<grid_of(batch, res), kTileThreads, bwd_smem_bytes(n_faces),
                    static_cast<cudaStream_t>(stream)>>>(
      coef, zw, color, bg, g, n_faces, res, static_cast<float*>(partial),
      static_cast<float*>(gbg), static_cast<int*>(counters),
      static_cast<float*>(gcoef), static_cast<float*>(gzw),
      static_cast<float*>(gcolor));
  return (int)cudaGetLastError();
}

// Registers per thread, resident blocks per SM, local (spill) bytes per
// thread and shared bytes per block of the forward (out[0..3]) and the
// backward (out[4..7]) at ``n_faces`` faces per camera.
extern "C" int tds_soft_raster_occupancy(int n_faces, int* out) {
  if (n_faces < 1 || n_faces > kMaxFaces) return (int)cudaErrorInvalidValue;
  cudaError_t err = kernel_stats(soft_fwd_kernel, 0, out);
  if (err == cudaSuccess) err = set_bwd_smem(n_faces);
  if (err == cudaSuccess)
    err = kernel_stats(soft_bwd_kernel, bwd_smem_bytes(n_faces), out + 4);
  return (int)err;
}
