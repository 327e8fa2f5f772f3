// The launch plan and weight image of the f32 tiled torso forms
// (fused_resblock_tf32.cu's conv_tiled_tf32_kernel), in plain C++ so that
// a host compiler can build it too: ops/fused_resblock.py mirrors every
// function here (res_stage_tiled_plan, feat_pool_tiled_plan,
// tf32_weight_image_floats), and tests/test_torch_fused_mma.py compiles
// this header with g++ and holds the two to each other.  ops/build.py
// hashes it into every library's name.
//
// A block is 16 warps (512 threads), one a streaming multiprocessor:
//   res stage:    64 output channels x a tile of th x tw <= 128 conv outputs
//                 whose halo-padded rows, th (tw + 2) - 2 positions, fit 144
//                 (kResHalo: two warpgroups' m64n72 products); warps 2 x 4 x 2
//                 (rows, positions, the halves of each chunk's K);
//   feature pool: 32 output channels x the (2 ph + 1) x (2 pw + 1) <= 320
//                 dense conv outputs behind ph x pw pooled ones; warps 2
//                 (16 channels each) x 8 (40 positions each).
// K = 9 ci streams in chunks of kKc input channels x all nine taps (K =
// 144), each in three kinds of buffer, two of each: the raw operand tile
// landing by cp.async ([kKc][th + 2][lw]), the same tile as the conv's
// operand split into TF32 hi and lo planes, and the group's weights from
// the split image.  The planes lie in the core-matrix layout of Hopper's
// tensor-core operands (planes of 4 channels, 16 bytes a position or a
// weight row).

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define TILED_HD __host__ __device__
#else
#define TILED_HD
#endif

namespace tiled_tf32 {

constexpr int kThreads = 512;  // 16 warps
constexpr int kKc = 16;        // input channels a chunk
constexpr int kKq = kKc / 4;   // core-matrix planes (4 channels each) a chunk
constexpr int kStages = 2;
constexpr int kResGroup = 64, kResSlots = 128;   // output channels, positions a res block
constexpr int kResHalo = 144;                     // positions of its halo-padded rows
constexpr int kPoolGroup = 32, kPoolSlots = 320;  // the same, a feature-pool block (dense)
constexpr long long kSmemMax = 232448 - 256;  // an H100 block's shared memory, bytes, less
                                               // the kernel's static mbarriers' room

TILED_HD inline int cdiv(int n, int d) { return (n + d - 1) / d; }
TILED_HD inline int imin(int a, int b) { return a < b ? a : b; }
TILED_HD inline int imax(int a, int b) { return a > b ? a : b; }

// Floats of one chunk's weight image: [hi, lo][9 taps][kKq][group rows][4].
TILED_HD inline long long chunk_floats(int group) { return 2LL * 9 * kKc * group; }

// Floats of one conv's weight image for one member: every group of output
// channels, every chunk of input channels.
TILED_HD inline long long conv_image_floats(int ci, int co, int group) {
  return (long long)cdiv(co, group) * cdiv(ci, kKc) * chunk_floats(group);
}

// Where weight w[o][tap * ci + c] of one conv's image goes, for o < the
// groups' rows and c < the chunks' channels: hi at the returned offset, lo
// chunk_floats(group) / 2 after it.  Rows past co and channels past ci are
// zero in the image.
TILED_HD inline long long image_offset(int ci, int group, int o, int tap, int c) {
  const long long chunk = (long long)(o / group) * cdiv(ci, kKc) + c / kKc;
  const int cc = c % kKc;
  return chunk * chunk_floats(group) + ((tap * kKq + cc / 4) * (long long)group + o % group) * 4 +
         cc % 4;
}

// Floats of a landing row: the halo row's tile_w columns from a column
// aligned to 4 floats below it (16-byte copies).
TILED_HD inline int landing_width(int tw) { return 4 * cdiv(tw + 2 + 3, 4); }

// Positions of an operand plane: the halo tile, and in the res stage what
// the halo-padded rows' products read past it.
TILED_HD inline int plane_positions(bool pool, int th, int tw) {
  const int halo = (th + 2) * (tw + 2);
  return pool ? halo : imax(halo, kResHalo + 2 * (tw + 2) + 2);
}

// Shared bytes of a block over a th x tw tile of conv outputs: two of each
// buffer (landing tile, hi and lo planes, weights) from a 128-byte boundary,
// or what overlays them once the products are done, whichever is larger: the K halves' sums (8
// warps x 32 lanes x 36 floats, the res stage) or the dense map (the pool).
inline long long smem_bytes(bool pool, int th, int tw) {
  const int group = pool ? kPoolGroup : kResGroup;
  const long long landing = (long long)kKc * (th + 2) * landing_width(tw);
  const long long planes = 2LL * kKc * plane_positions(pool, th, tw);
  const long long ring = 4LL * kStages * (landing + planes + chunk_floats(group)) + 128;
  const long long after = 4LL * 8 * 32 * (pool ? 40 : 36) + (pool ? 4LL * group * th * tw : 0);
  return ring > after ? ring : after;
}

// The res stage's tile: 16 columns (all of W where it is narrower), as many
// rows as fill the block's 128 positions (all of H where it is shorter, the
// columns then widened to fill them), fewer rows (then fewer columns) while
// the halo-padded rows pass 144 positions or the buffers do not fit; then
// spread evenly over the frame.
inline void res_plan(int H, int W, int* th, int* tw) {
  int w = imin(W, 16);
  int h = imin(H, kResSlots / w);
  if (h == H) w = imin(W, kResSlots / h);
  while (h * (w + 2) - 2 > kResHalo || smem_bytes(false, h, w) > kSmemMax) {
    if (h > 1) --h;
    else --w;
  }
  *th = cdiv(H, cdiv(H, h));
  *tw = cdiv(W, cdiv(W, w));
}

// The feature pool's tile of ph x pw pooled outputs: 8 x 8 (289 dense
// outputs of the block's 320), a side short of 8 giving its positions to the
// other; fewer while the ring does not fit; then spread evenly.
inline void feat_plan(int H, int W, int* ph, int* pw) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  int r = imin(Ho, 8), c = imin(Wo, 8);
  if (r < 8)
    c = imin(Wo, imax(1, (kPoolSlots / (2 * r + 1) - 1) / 2));
  else if (c < 8)
    r = imin(Ho, imax(1, (kPoolSlots / (2 * c + 1) - 1) / 2));
  while ((r > 1 || c > 1) && smem_bytes(true, 2 * r + 1, 2 * c + 1) > kSmemMax) {
    if (r >= c) --r;
    else --c;
  }
  *ph = cdiv(Ho, cdiv(Ho, r));
  *pw = cdiv(Wo, cdiv(Wo, c));
}

}  // namespace tiled_tf32
