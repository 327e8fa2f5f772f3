// What the tiled torso forms of fused_resblock_tf32.cu (3xTF32) and
// fused_resblock_mma.cu (bf16) share: the conv arguments (TiledArgs,
// tiled_args), a block's view of its halo tile (TileView), the copy of one
// chunk of the f32 operand tile into shared memory (by one tensor-map load, or
// by 4-byte cp.async where the rows cannot take the map) and the map itself.
// Each file keeps its own kernel, its plan header (tiled_tf32_plan.cuh,
// tiled_mma_plan.cuh), its weight image and its entry points.  ops/build.py
// hashes this header into both libraries' names.

#pragma once

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

struct TiledArgs {
  const float* in;     // [M * B, ci, H, W]
  const float* w;      // member m's weight image at w + m * w_ms (f32 floats; bf16 values)
  const float* b;      // member m's [co] at b + m * b_ms
  const float* s;      // member m's [ci] at s + m * st_ms and t + m * st_ms
  const float* t;
  const float* res;    // [M * B, co, H, W] added after the bias, or null; may be out
  float* out;          // [M * B, co, H, W], or the pooled [M * B, co, Ho, Wo]
  long long w_ms;
  int b_ms, st_ms;
  int B, ci, co, H, W;
  int th, tw;          // the conv outputs a block computes: th rows x tw columns
  int ntc, ntiles;     // column tiles, and tiles a frame
  int relu;            // ReLU after the affine (the res stage's convs)
  int vec;             // the operand by tensor-map loads (W % 4 == 0, in aligned)
  int ph, pw, Ho, Wo;  // the feature pool: pooled rows x columns a block, the pooled frame
  void* pout;          // bf16: the next conv's operand as bf16 planes, or null
  const float* sn;     // bf16: the next conv's affine (member m's at + m * st_ms)
  const float* tn;
};

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The arguments' shape: tiles of th x tw conv outputs over the frame (the res
// stage, ph = pw = 0), or of ph x pw pooled outputs over the pooled frame (the
// feature pool, th = 2 ph + 1, tw = 2 pw + 1).  Pointers, strides and the
// prologue are the caller's.
inline TiledArgs tiled_args(int B, int ci, int co, int H, int W, int th, int tw, int ph, int pw) {
  TiledArgs a = {};
  a.B = B;
  a.ci = ci;
  a.co = co;
  a.H = H;
  a.W = W;
  a.th = th;
  a.tw = tw;
  a.ph = ph;
  a.pw = pw;
  a.Ho = (H + 1) / 2;
  a.Wo = (W + 1) / 2;
  const int rows = ph > 0 ? a.Ho : H, cols = pw > 0 ? a.Wo : W;  // what the tiles cover
  const int tile_rows = ph > 0 ? ph : th, tile_cols = pw > 0 ? pw : tw;
  a.ntc = (cols + tile_cols - 1) / tile_cols;
  a.ntiles = a.ntc * ((rows + tile_rows - 1) / tile_rows);
  return a;
}

// A tiled block's view of its tile.  The operand's halo tile is th + 2 rows
// x tile_w = tw + 2 columns from frame row oy - 1 and column ox - 1; it
// lands raw from frame column x0 (4-aligned where the copies take 16 bytes)
// in rows of lw floats, halo column 0 at landing column dx; its planes hold
// pa positions (P of the halo tile, then what the halo-padded products read
// past it).
struct TileView {
  int oy, ox, rows, tile_w, P, pa, x0, lw, dx;
};

// Start copying chunk c0 .. c0 + KC - 1 of the input channels into the
// landing tile [KC][rows][lw].  Where a.vec, one thread starts a tensor-map
// load of the whole box, completing on bar (what lies off the frame reads
// zero; channels past the member's ci read its neighbour's); else each warp
// copies a landing row at a time, 4 bytes a lane, and what lies off the
// frame or past ci is left as it is.  The caller's transform zeroes all of
// those.  Either way no thread waits for the other's copies here.
template <int KC, int THREADS>
__device__ void issue_operand(const TiledArgs& a, const CUtensorMap& map, float* land,
                              uint64_t* bar, size_t mb, int c0, const TileView& v) {
  if (a.vec) {
    if (threadIdx.x == 0) {
      fence_proxy_async();
      tma_load_3d(land, &map, v.x0, v.oy - 1, int(mb * a.ci + c0),
                  uint32_t(4 * KC * v.rows * v.lw), bar);
    }
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t plane = (size_t)a.H * a.W;
  const float* src = a.in + (mb * a.ci + c0) * plane;
  const int nc = min(KC, a.ci - c0);
  for (int cr = warp; cr < nc * v.rows; cr += THREADS / 32) {
    const int c = cr / v.rows, y = v.oy - 1 + (cr - c * v.rows);
    if (y < 0 || y >= a.H) continue;
    const float* row = src + c * plane + (size_t)y * a.W;
    float* dst = land + cr * v.lw;
    for (int u = lane; u < v.lw; u += 32) {
      const int x = v.x0 + u;
      if (x >= 0 && x < a.W) cp_async4(dst + u, row + x);
    }
  }
}

// The tensor map of a.in as [planes][H][W] f32 (M B ci planes) whose box is a
// chunk's landing tile (kc planes x th + 2 rows x lw columns), zero outside;
// a.vec (W % 4 == 0, a.in 16-byte aligned) is the caller's.
inline cudaError_t operand_map(const TiledArgs& a, int M, int lw, int kc, CUtensorMap* map) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return cudaErrorInvalidValue;
  }
  const cuuint64_t dims[3] = {(cuuint64_t)a.W, (cuuint64_t)a.H, (cuuint64_t)M * a.B * a.ci};
  const cuuint64_t strides[2] = {(cuuint64_t)a.W * 4, (cuuint64_t)a.H * a.W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)lw, (cuuint32_t)a.th + 2, (cuuint32_t)kc};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(a.in), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace
