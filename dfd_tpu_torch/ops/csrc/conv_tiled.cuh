// The tiled torso forms' conv arguments (TiledArgs, tiled_args), which
// fused_resblock_tf32.cu (3xTF32) and fused_resblock_mma.cu (bf16) share,
// and what only the bf16 forms take: the copy of one chunk of K (all nine
// taps x KC input channels) into shared memory by cp.async, and the res
// stage's four passes.  (The f32 forms stream a split weight image and their
// own ring; tiled_tf32_plan.cuh.)  Each file keeps its own kernel, its
// launch plan and its entry points.  ops/build.py hashes this header into
// both libraries' names.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

constexpr int kTiledGroup = 64;  // output channels of a tiled block

struct TiledArgs {
  const float* in;     // [M * B, ci, H, W]
  const float* w;      // member m's [co, 9 ci] at w + m * w_ms, in tap order (f32: its image)
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
  int vec;             // bf16: weights copied in 16-byte pieces (ci % 4 == 0, w aligned);
                       // f32: the operand rows (W % 4 == 0, in aligned)
  int ph, pw, Ho, Wo;  // the feature pool: pooled rows x columns a block, the pooled frame
};

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

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

// Start copying chunk c0 .. c0 + KC - 1 of the input channels in f32: the
// operand tile (frame rows oy - 1 .. oy + th, columns ox - 1 .. ox + tw,
// position-major, KC + 4 floats a position; what lies off the frame or past
// ci is left for the caller's prologue pass) and the group's weights
// ([row][tap * KC + c], 9 KC + 4 floats a row; zero past ci and past co).
template <int KC, int THREADS>
__device__ void issue_tiled(const TiledArgs& a, float* tile, float* wb, size_t mb, int m, int oy,
                            int ox, int co0, int c0, int rows) {
  constexpr int cs = KC + 4, csw = 9 * KC + 4, warps = THREADS / 32;
  const int tile_w = a.tw + 2, npt = (a.th + 2) * tile_w, nc = min(KC, a.ci - c0);
  const size_t plane = (size_t)a.H * a.W;
  const float* src = a.in + (mb * a.ci + c0) * plane;
  for (int p = threadIdx.x; p < npt; p += THREADS) {
    const int r = p / tile_w, x = ox - 1 + (p - r * tile_w), y = oy - 1 + r;
    if (y < 0 || y >= a.H || x < 0 || x >= a.W) continue;
    const float* col = src + (size_t)y * a.W + x;
    float* d = tile + p * cs;
    for (int c = 0; c < nc; ++c) cp_async4(d + c, col + c * plane);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, valid = min(kTiledGroup, a.co - co0);
  const float* w = a.w + m * a.w_ms + (size_t)co0 * 9 * a.ci + c0;
  if (a.vec) {  // ci % 4 == 0: a piece of 4 channels lies wholly below ci or past it
    constexpr int q = KC / 4;
    for (int r = warp; r < rows; r += warps) {
      for (int i = lane; i < 9 * q; i += 32) {
        const int tap = i / q, c = (i - tap * q) * 4;
        float* dst = wb + r * csw + tap * KC + c;
        if (r < valid && c0 + c < a.ci)
          cp_async16(dst, w + (size_t)r * 9 * a.ci + tap * a.ci + c);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int r = warp; r < rows; r += warps) {
      for (int i = lane; i < 9 * KC; i += 32) {
        const int tap = i / KC, c = i - tap * KC;
        float* dst = wb + r * csw + tap * KC + c;
        if (r < valid && c0 + c < a.ci)
          cp_async4(dst, w + (size_t)r * 9 * a.ci + tap * a.ci + c);
        else
          *dst = 0.f;
      }
    }
  }
  cp_async_commit();
}

// The res stage as four launches of conv j (launch(a) with a set for it),
// each conv's f32 output in device memory: scratch <- conv0(x);
// out <- x + conv1(scratch); scratch <- conv2(out); out <- out + conv3(scratch).
// The block input is never overwritten; a conv that adds its residual to out
// reads and writes each value of it on one thread.  Four launches rather than
// one persistent kernel with a grid-wide barrier: no launch needs every block
// resident at once, and each pass reads only what the last one wrote.
template <class Launch>
cudaError_t res_stage_passes(TiledArgs a, const float* x, const float* w, const float* b,
                             const float* s, const float* t, float* scratch, float* out, int C,
                             Launch launch) {
  a.w_ms = 4LL * C * 9 * C;
  a.b_ms = a.st_ms = 4 * C;
  a.relu = 1;
  a.vec = C % 4 == 0 && aligned16(w);
  const float* in[4] = {x, scratch, out, scratch};
  float* dst[4] = {scratch, out, scratch, out};
  const float* res[4] = {nullptr, x, nullptr, out};
  for (int j = 0; j < 4; ++j) {
    a.in = in[j];
    a.out = dst[j];
    a.res = res[j];
    a.w = w + (size_t)j * 9 * C * C;
    a.b = b + (size_t)j * C;
    a.s = s + (size_t)j * C;
    a.t = t + (size_t)j * C;
    const cudaError_t err = launch(a);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace
