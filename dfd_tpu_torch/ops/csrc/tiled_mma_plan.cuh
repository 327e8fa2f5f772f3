// The launch plan and weight image of the bf16 tiled torso forms
// (fused_resblock_mma.cu's conv_tiled_mma_kernel), in plain C++ so that a
// host compiler can build it too: ops/fused_resblock.py mirrors every
// function here (res_stage_tiled_plan, feat_pool_tiled_plan,
// mma_weight_image_elems, mma_weight_image_plain), and
// tests/test_torch_fused_mma.py compiles this header with g++ and holds the
// two to each other.  ops/build.py hashes it into every library's name.
//
// A block is 4 warpgroups (512 threads), one an SM.  Each warpgroup
// multiplies 64 output channels (wgmma's m64) x kN = 152 positions of the
// operand tile's halo-padded rows (a tile row and its two halo columns, so a
// tap is a shift of B's start).  A block takes one group of 64 output
// channels with its warpgroups over 4 x 152 positions, or, where the conv has
// more than 64, two groups over 2 x 152, both reading the same operand tile:
// the tile is landed and transformed once for 128 channels.
//   res stage:    a tile of th x tw conv outputs with th (tw + 2) - 2 <=
//                 608 (304) halo-padded positions, whole rows where they fit
//                 (6 x 96 at 96x96; 6 x 48 at 48x48 and 128 channels);
//   feature pool: the (2 ph + 1) x (2 pw + 1) dense outputs behind ph x pw
//                 pooled ones, 8 pooled rows and as many columns as fit
//                 (8 x 7 at 192x192 and 128 channels: 4.55 dense outputs a
//                 pooled one).
// K = 9 ci streams in chunks of kKc = 16 input channels x all nine taps,
// one k16 step a tap, through a ring of `stages` slots, each the group's
// weights from the bf16 image by one bulk copy and the operand's chunk by
// tensor-map loads: an f32 operand (the feature pool, the res stage's first
// conv) as its raw tile ([kKc][th + 2][lw]), transformed into two slots of
// bf16 planes; the previous conv's bf16 planes (the res stage's convs 1-3)
// straight into the slot.  Image and planes lie in the core-matrix layout of
// Hopper's tensor-core operands (planes of 8 channels, 16 bytes a position
// or a weight row).

#pragma once

#include <cstddef>

#ifdef __CUDACC__
#define TILED_HD __host__ __device__
#else
#define TILED_HD
#endif

namespace tiled_mma {

constexpr int kThreads = 512;   // 4 warpgroups
constexpr int kKc = 16;         // input channels a chunk: one k16 step a tap
constexpr int kPlanes = kKc / 8;  // core-matrix planes (8 channels each) a chunk
constexpr int kGroup = 64;      // output channels of a warpgroup's products (m64)
constexpr int kN = 152;         // halo-padded positions of a warpgroup's products (n152)
constexpr int kBoxMax = 251;    // the widest tile whose landing rows fit a tensor map's box
                                // (256 floats)
constexpr long long kSmemMax = 232448 - 256;  // an H100 block's shared memory, bytes, less
                                               // the kernel's static mbarriers' room

TILED_HD inline int cdiv(int n, int d) { return (n + d - 1) / d; }
TILED_HD inline int imin(int a, int b) { return a < b ? a : b; }
TILED_HD inline int imax(int a, int b) { return a > b ? a : b; }

// Groups of 64 output channels a block takes: two past 64 channels, else one.
TILED_HD inline int block_groups(int co) { return co > kGroup ? 2 : 1; }

// Halo-padded positions a block's products cover: 4 / block_groups spans of kN.
TILED_HD inline int block_slots(int co) { return 4 / block_groups(co) * kN; }

// Groups of one conv's image: whole blocks' worth, zero rows past co.
TILED_HD inline int image_groups(int co) {
  const int gb = block_groups(co);
  return gb * cdiv(cdiv(co, kGroup), gb);
}

// bf16 values of one chunk of one group's weights: [9 taps][kPlanes][kGroup rows][8].
TILED_HD inline long long chunk_elems() { return 9LL * kKc * kGroup; }

// bf16 values of one conv's image for one member: [chunks][image groups][chunk].
TILED_HD inline long long conv_image_elems(int ci, int co) {
  return (long long)cdiv(ci, kKc) * image_groups(co) * chunk_elems();
}

// Where weight w[o][tap * ci + c] of one conv's image goes, for o < co and
// c < ci; everything else in the image is zero.  A block's groups of one
// chunk lie next to each other: one bulk copy brings them.
TILED_HD inline long long image_offset(int ci, int co, int o, int tap, int c) {
  const long long chunk = (long long)(c / kKc) * image_groups(co) + o / kGroup;
  const int cc = c % kKc;
  return chunk * chunk_elems() + ((tap * kPlanes + cc / 8) * (long long)kGroup + o % kGroup) * 8 +
         cc % 8;
}

// Floats of a landing row: the halo row's tw + 2 columns from a column
// aligned to 4 floats below it (16-byte tensor-map boxes).
TILED_HD inline int landing_width(int tw) { return 4 * cdiv(tw + 2 + 3, 4); }

// Positions of an operand plane: the halo tile, or what the products read
// past it (the block's slots shifted by the last tap), whichever is more,
// rounded to 8.
TILED_HD inline int plane_positions(int co, int th, int tw) {
  return 8 * cdiv(imax((th + 2) * (tw + 2), block_slots(co) + 2 * (tw + 2) + 2), 8);
}

// Floats a row of the block's sums takes in shared memory after the products:
// the tile's outputs rounded to 4, plus 4 (fewer bank conflicts).
TILED_HD inline int stage_stride(int npos) { return 4 * cdiv(npos, 4) + 4; }

// Shared bytes of a block over a th x tw tile of conv outputs with `stages`
// ring slots, from a 128-byte boundary: each slot the weights and, for an
// f32 operand, its landing tile (two slots of planes beside them), for a
// planar one (the res stage's convs 1-3) its planes; or the block's sums (the
// pool's dense map) and the next conv's affine, which overlay them once the
// products are done, whichever is larger.
inline long long smem_bytes(bool pool, bool planar, int co, int th, int tw, int stages) {
  const long long landing = 4LL * kKc * (th + 2) * landing_width(tw);
  const long long planes = 2LL * kKc * plane_positions(co, th, tw);
  const long long weights = 2LL * block_groups(co) * chunk_elems();
  const long long ring = planar ? stages * (planes + weights) + 128
                                : stages * (landing + weights) + 2 * planes + 128;
  const long long sums = 4LL * block_groups(co) * kGroup * (stage_stride(th * tw) + (pool ? 0 : 2));
  return ring > sums ? ring : sums;
}

// The ring's slots: for an f32 operand 3 where they fit, else 2; for a
// planar one 4, 3 or 2.
inline int stages(bool pool, bool planar, int co, int th, int tw) {
  for (int s = planar ? 4 : 3; s > 2; --s)
    if (smem_bytes(pool, planar, co, th, tw, s) <= kSmemMax) return s;
  return 2;
}

// The res stage's tile: whole rows of at most (slots + 2) / 4 - 2 columns
// (so that at least 4 rows fit), as many rows as the block's halo-padded
// positions take (all of H where it is shorter, the columns then widened to
// fill them, up to kBoxMax), fewer rows (then columns) while two ring slots
// do not fit; then spread evenly over the frame.
inline void res_plan(int C, int H, int W, int* th, int* tw) {
  const int slots = block_slots(C);
  int w = imin(W, (slots + 2) / 4 - 2);
  int h = imin(H, (slots + 2) / (w + 2));
  if (h == H) w = imin(W, imin(kBoxMax, (slots + 2) / h - 2));
  while (smem_bytes(false, false, C, h, w, 2) > kSmemMax) {
    if (h > 1) --h;
    else --w;
  }
  *th = cdiv(H, cdiv(H, h));
  *tw = cdiv(W, cdiv(W, w));
}

// The feature pool's tile of ph x pw pooled outputs: 8 pooled rows (all of
// them where fewer) and as many columns as the halo-padded dense rows
// take; all the columns where they fit, the rows then widened to fill the
// positions; fewer while two ring slots or the dense map do not fit; then
// spread evenly.
inline void feat_plan(int co, int H, int W, int* ph, int* pw) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2, slots = block_slots(co);
  int r = imin(Ho, 8);
  int c = imin(Wo, imax(1, ((slots + 2) / (2 * r + 1) - 3) / 2));
  if (c == Wo) r = imin(Ho, imax(1, ((slots + 2) / (2 * c + 3) - 1) / 2));
  while ((r > 1 || c > 1) && ((2 * r + 1) * (2 * c + 3) - 2 > slots ||
                              smem_bytes(true, false, co, 2 * r + 1, 2 * c + 1, 2) > kSmemMax)) {
    if (r >= c) --r;
    else --c;
  }
  *ph = cdiv(Ho, cdiv(Ho, r));
  *pw = cdiv(Wo, cdiv(Wo, c));
}

}  // namespace tiled_mma
