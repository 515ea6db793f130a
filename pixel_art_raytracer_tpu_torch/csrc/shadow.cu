// Kernel 2: shadow occlusion — the lit mask of every (frame, pixel), for a
// point light per frame or a directional light per frame.
//
// Replaces: pixel_art_raytracer_tpu/ops/shadow_pallas.py::_shadow_kernel,
// as the JAX package's batched path launches it for point lights and, on
// its extended tables, for directional lights (models/batched.py:821).
// Computes exactly ops/shadow.py::trace_light_dynamic of the port (and of
// the JAX package): each pixel's ray runs the reference's 7-phase thick DDA
// (x, y, z, xy, xz, yz, advance) from the pixel's bin toward the light's
// bin for 7 * int(largest) phases (alternative.cpp:399-500); every probed
// in-range flat bin other than the start bin tests its first `count`
// slots, skipping the pixel's own entity, with the slab test in the
// reference's std::min/std::max order; out-of-range flat bins are skipped
// and in-range aliased bins are used as they are.  Every pixel is marched,
// background included, but where a winner-input mode stores frames: there
// a pixel whose lit factor is the ambient one (background, a face turned
// from the light) has the same colour lit or not, and is stored without a
// march.
//
// G-buffer point mode (par_shadow_lit): ten per-pixel ray buffers, the
// light bin is the frame's, and the march is exact for any light and any
// rays, with no table or reroute.  It takes an optional step cap: a ray
// probes 7 * min(int(largest), max_steps) phases, the statically bounded
// march of the JAX package's ops/shadow.py::trace_light (max_steps < 0 for
// none, as the render paths call it; the inverse fitter's soft_frame
// passes the renderer's shadow_max_steps).  A launch covers a window of
// whole bin rows of the view (all of them, or a row shard's,
// parallel/mesh.py), with per-pixel arrays of the window's rows.
//
// Winner-input point mode (par_shadow_shade): the JAX kernel's winner-direct
// inputs and its shade epilogue (shadow_pallas.py:766-790, 1140-1216).  It
// reads trace.cu's winners instead of ten per-pixel ray buffers, decodes
// each pixel's surface point once (ops/trace.py::decode_winner) and derives
// its start bin, origin and reciprocal direction (ops/shade.py::
// light_geometry); the march is the G-buffer mode's, uncapped, over the
// whole view.  Where a frame is asked for, the store shades the pixel (the
// Lambert dot, the ambient + Lambert factor and the truncated u8 colour of
// ops/shade.py, in its op order) and writes RGB; otherwise it writes the
// lit mask.  No G-buffer, light geometry, lit mask or dot reaches device
// memory.  Its plain version is ops/shade.py::point_frames.
//
// Winner-input directional mode (par_shadow_dir_shade): the directional
// mode's march, from trace.cu's winners to the frames.  Its first phase
// decodes each pixel's surface from its winner (ops/trace.py::
// decode_winner) into the tile's shared memory, and its store shades the
// pixel (the Lambert dot against the frame's direction, the ambient +
// Lambert factor of ops/shade.py, then the truncated u8 colour or the
// ordered dither of ops/dither.py onto the palette, in their op order) and
// writes RGB.  A pixel whose factor lit is the ambient factor settles in
// the first phase and is not marched.  No G-buffer, dot, lit mask or
// factor reaches device memory.  Its plain version is ops/shade.py::
// directional_frames.
//
// Multi-light mode (par_shadow_lights): the winner-input point mode's
// frames under L point lights a frame whose shadowed diffuse adds (the
// JAX package's framework extension, ops/shade.py::shade_multi and
// models/batched.py:896-905; the reference keeps a vector of lights and
// shades with its first).  One launch: each block decodes its pixels once,
// marches them toward each light in order (a pixel whose factor toward
// that light is the ambient one lit or not takes no key and no march for
// it), adds each light's max(factor - ambient, 0) to a float32 sum and
// stores trunc(colour * min(1, ambient + sum)) once, the op sequence of
// ops/shade.py's add_light, multi_light_factor and shade_u8.  No G-buffer,
// ray buffer, lit mask or factor reaches device memory; the running sum
// does, in a scratch each pixel's thread alone reads and writes.  Its
// plain version is ops/shade.py::light_frames.
//
// Directional mode (par_shadow_dir_lit): the march of the JAX package's
// shade_directional, i.e. trace_light_dynamic with the per-pixel light bins
// of ops/shadow_dir.py::pixel_light_bins and the step cap max_steps
// (ops/shadow_dir.grid_max_steps on the render path): a ray probes
// 7 * min(int(largest), max_steps) phases.  The kernel reads each pixel's
// surface point (y, z) and entity and derives the rest as ops/shade.py
// does: start bin (i / bs, (view_h - y - z) / bs, z / bs), origin
// (i, y, z), the frame's reciprocal direction, and the virtual far light's
// bin ((i + Kx) / bs, (view_h - y - z - (Ky + Kz)) / bs, (z + Kz) / bs)
// from the frame's offsets K, C's truncating `/` throughout.
//
// What bounds it on the H100: in the G-buffer point mode the bytes, 41 B
// of ray inputs and 1 B of output a pixel; in the winner-input mode 4 B of
// winner and 3 B of frame a pixel, so the slab tests may bound it instead;
// in directional mode the slab tests the rays need (13 B a pixel; ~190 M
// tests of 23 operations on chip_smoke.py's sweep of 64 graybox frames),
// and in its winner-input mode too (4 B of winner and 3 B of frame a
// pixel).  It runs at several times its bound.  Marched per pixel, as the
// reference does, each ray ran ~48 DDA phases, probed the same bins again and again (14-31
// distinct of ~40-56 probes on graybox) and gathered every tested box's
// 24 B from the entity arrays, in loops of different lengths within a
// warp.  What is left is the per-pixel slab tests and each block's short
// phases between barriers: collecting the keys, the DDA, staging the boxes.
//
// What the design does about it: a ray's probed bins depend only on its
// start bin, its light bin and the step cap, and a tile's pixels share few
// of them.  So one block takes one (frame, bin-column tile) of bs x bs
// pixels, or one band of its rows.
//
// Point modes: one template, shadow_shade_kernel<kCount, Px>, runs
// common.cuh march_band, the one point-light march of the port (fused.cu
// runs it too), from winners (Px = WinnerPixels) or from ray buffers
// (Px = PixelRays):
// 1. one block per (frame, bin-column tile, band of rows), trace.cu's
//    bands (par::Grid's band_rows: the most rows whose pixels fit
//    kBandPixels), so the per-pixel state is the band's whatever the bin
//    size;
// 2. each pixel is loaded once, kShadePixels pixels a thread at a time so
//    their gathers overlap, into the band's shared memory: the ray's
//    origin y and z, the entity, the texel, and the reciprocal direction;
//    from winners, the surface point decoded and 1 / (d / length); from
//    ray buffers, the buffers' values (the origin's x as well, in the
//    texel's place, so rays that do not come from the view march as any
//    other);
// 3. the band's distinct start bins (up to kShadeKeys): each warp lists its
//    own, and warp 0 merges the warps' lists with __match_any_sync; a
//    start bin from ray buffers whose components do not fit a packed key
//    (21 bits each) marches on its own;
// 4. the visit lists are streamed: each key keeps its DDA where it stopped
//    (the anchor of dda_rounds, the step it reached, the lanes of that
//    round already listed, and a V-bit mask of the bins listed), and each
//    chunk its warp lists the key's next distinct bins, in first-visit
//    order, into its share of `chunk` entries, so no list of V entries
//    exists; the staged entries' boxes are tested by every pixel of the key
//    not yet occluded, in that order (the order matters for speed: a ray
//    meets its occluder sooner among the bins near its start);
// 5. the pixels whose key did not fit march on their own, and every
//    pixel's lit bit or colour is stored from its loaded state.
// Where the winner-input mode stores frames, only the pixels whose colour
// the march can change are marched: at step 2 a pixel whose factor lit
// (the store's own operations) equals the ambient factor is settled, takes
// no key and no direct march, and is stored as occluded, which writes the
// same bytes; and at step 4 a key none of whose pixels is left unoccluded
// after a chunk lists no more, so a band of settled pixels goes from the
// decode straight to the store.  The lit-mask stores march every pixel.
// Shared memory is then fixed but for the V / 8 B of each key's mask
// (ShadeSmem::bytes), and the wrapper takes the longest chunk, up to 32
// entries, at which 4 blocks fit an SM (shadow_cuda.shade_chunk).
// The multi-light mode (Px = LightPixels) is the same march once a light,
// its pixels kept in the band's shared memory from one light to the next.
// shadow_shade_kernel<false, WinnerPixels> is the render path's kernel,
// and shadow_shade_kernel<true, WinnerPixels>, which the wrapper launches
// only while the program is traced (runtime/tracing.py), also counts its
// slab tests into work[kWorkShadeTests] and the pixels it marched (not
// settled) into work[kWorkShadeMarched]: each thread in a register, one
// warp reduce, one atomicAdd a block.  The count is each marched pixel's
// tests up to its first hit, over its key's distinct bins in first-visit
// order (ops/shadow.py's work["slab_tests"]), plus those of the pixels
// that march on their own, repeats included.
//
// Directional mode (shadow_dir_kernel): each pixel has its own virtual far
// light, so a key is a (start bin, light bin) pair, ~4.8 of them a graybox
// tile (at most 10), whose visit lists share most of their bins (~115
// entries a tile, ~41 distinct).  The block
// 1. packs each pixel's key into one 64-bit word (the start bin's y and z,
//    the light bin minus the start bin; ops/shadow_dir.key_fields sizes the
//    fields from the RenderConfig; the start bin's x is the tile's;
//    dividing by the bin size with a multiply), finds each warp's distinct
//    keys with __match_any_sync and inserts them into an open-addressed
//    table in shared memory with atomicCAS, up to kDirKeys (16) keys, and
//    sorts the pixels by key (a count per table slot, a scan, a place
//    each), so that a warp holds pixels of one key;
// 2. walks one warp-parallel DDA per key (common.cuh dda_rounds, the
//    per-pixel march's float stepping and cap) that sets the key's bit in
//    a word per grid bin;
// 3. compacts the bins with any bit set into one union list, in flat order;
// 4. stages the union's candidate boxes once, kDirChunk entries at a time,
//    and walks them in lockstep: every thread holds kDirPixels pixels in
//    registers and all lanes take the same entry at the same time, so the
//    boxes' shared-memory reads are broadcasts; a pixel tests an entry only
//    where the entry's mask has its key's bit, skips its own entity and
//    stops at its first hit.
// The winner-input directional mode (shadow_dir_kernel<DirFrames>) is the
// same march with another first phase and store: phase 1 decodes each
// pixel once and keeps in shared memory what the walk and the store read
// (the surface point's y and z in 16 bits each, the entity, the texel's
// offset in its sprite: 10 B a pixel), and phase 5 shades.  A pixel whose
// y or z does not fit 16 bits takes the direct march, which decodes its
// winner again.  Only the pixels whose colour the march can change are
// marched, the rule of the winner-input point mode (ops/shade.py
// march_live): phase 1 takes the Lambert dot of the decoded texel's normal
// against the frame's direction, and a pixel whose factor lit (the store's
// own operations, directional_lit_factor) equals the ambient factor
// settles: with ambient <= 1 every background pixel and every face with a
// dot <= 0 or NaN, none with ambient > 1, every one with ambient 1.  It
// takes no key, no place in the sort and no direct march, and phase 5
// stores it as occluded, which writes the same bytes (the dither reads
// only the factor).  So the key table, the DDAs, the union and the staged
// chunks come from the live pixels alone, and a tile with none goes from
// the decode to the store.  Every launch adds the pixels it marched (list
// path and direct) to work[kWorkDirMarched]: the list path's count and
// each warp's direct pixels, one atomicAdd a block.
// A pixel whose key does not fit the table or the packed fields marches on
// its own (march_occluded) and is counted in stats[kStatDirect]; the slab
// tests of both paths add to work[kWorkTests] (a register a thread, one
// shared add a warp, one atomicAdd a block).  Exact
// because the lit bit is an OR over the probed bins, which ignores order
// and repeats: the union and its masks give each pixel exactly its key's
// bins.
//
// The slab test: where the frame's reciprocal direction is finite on every
// axis, no (corner - origin) * inv is NaN, so par::slab_hit's
// std::min/std::max chain takes the values' min and max, and each axis's
// min and max are the products at the corners nearer and farther along
// the axis (the products are monotone in the corner: the rounding of a
// difference and of a product by a positive or negative number is).  So
// the staged boxes hold each axis's near corner first (swapped by the sign
// of inv and the box's own order) and near_far_hit takes two maxima and
// two minima: the same hi >= lo as slab_hit (a -0 and a +0 compare equal),
// in 17 operations instead of slab_hit's 23 (~33 instructions: each of its
// ten std::min/std::max is a compare and a select).  A frame with an
// infinite or NaN component (a direction along a plane) takes slab_hit.
//
// The TPU kernel's per-tile candidate lists, membership words, extended
// start space and division helpers have no counterpart.
#include <type_traits>

#include "common.cuh"

namespace {

// Ray inputs of the G-buffer point mode: per pixel, each (F, H, W), the
// start bin, the float origin, the reciprocal direction (from
// ops/shade.light_geometry) and the pixel's own entity (from the
// G-buffer); and each frame's light bin, (F, 3).
struct PixelRays {
  const int* rbx;
  const int* rby;
  const int* rbz;
  const float* ox;
  const float* oy;
  const float* oz;
  const float* ivx;
  const float* ivy;
  const float* ivz;
  const int* self;
  const int* light_bin;
};

// Inputs of the winner-input point mode: trace.cu's winners, the atlas and
// palette the surface and the shade read, each frame's light, and the
// shade's constants.
struct WinnerPixels {
  const int* winner;           // (F, H, W) winner entity, -1 background
  const int* sprite_id;        // (N,)
  const int* atlas_depth;      // (S, SH, SW)
  const int* atlas_color;      // (S, SH, SW) palette index
  const float* atlas_normal;   // (S, SH, SW, 3)
  const unsigned char* palette;  // (P, 4) RGBA
  const int* lights;           // (F, 3) the point light of each frame
  int sprite_w, sprite_h;
  int bg_r, bg_g, bg_b;        // the background colour
  float ambient;
};

// Inputs of the multi-light mode: the winner-input point mode's, whose
// lights are (F, L, 3), n_lights = L point lights a frame in the order
// their diffuse adds, and the (F, H, W) float32 sum of the lights' diffuse
// so far, which each pixel's thread writes after a light and reads at the
// next (null where L is 1).
struct LightPixels {
  WinnerPixels w;
  int n_lights;
  float* sums;
};

// A pixel's surface as ops/trace.py::decode_winner gives it: the world y
// and z of the winner's hit, the entity and its clipped atlas texel;
// background (winner -1) takes y = z = entity = 0 (quirk Q6).
struct Surface {
  int y, z, ent, texel;
  bool hit;
};

__device__ __forceinline__ Surface decode_winner(
    const int* pos, const int* ext, const int* players,
    const WinnerPixels& px, const par::Grid& g, int f, int i, int j) {
  const int w = px.winner[g.pixel(f, i, j)];
  const bool hit = w >= 0;
  const int ent = hit ? w : 0;
  const int* p = par::entity_pos(pos, players, f, ent);
  const int* x = ext + 3 * static_cast<size_t>(ent);
  const int row = p[1] + x[1] + p[2] + x[2] - (g.view_h - j);
  const int texel = par::texel_at(px.sprite_id[ent] * px.sprite_h, row,
                                  i - p[0], px.sprite_w, px.sprite_h);
  const int sdep = px.atlas_depth[texel];
  return Surface{hit ? p[1] + x[1] + x[2] - row - sdep : 0,
                 hit ? p[2] + sdep : 0, ent, texel, hit};
}

// Per-pixel inputs of the directional mode, each (F, H, W) int32: the
// G-buffer's surface point y, z and the pixel's own entity.
struct SurfacePixels {
  const int* y;
  const int* z;
  const int* self;
};

// Inputs of the winner-input directional mode: trace.cu's winners and the
// arrays the surface and the shade read (WinnerPixels; its lights are not
// read), each frame's direction toward the light, and the style's tables.
struct DirFrames {
  WinnerPixels w;
  const float* tl;            // (F, 3) the L1-normalised direction
  const float* palette_luma;  // (P,) ops/dither.luminance of the palette
  int n_palette;
  float bg_luma;              // the background colour's luminance
  bool dithered;              // style "dithered", else "reference"
};

// The texel offset of a background pixel in DirSmem::local.
constexpr unsigned short kNoTexel = 0xFFFF;

// The threshold of view column i and row j in ops/dither.bayer_matrix(4):
// (m + 0.5) / 16 for the entry m at row j % 4 and column i % 4, which is
// 4 B(i % 2, j % 2) + B(i / 2 % 2, j / 2 % 2) with B(x, y) = 2 (x ^ y) + y,
// the 2 x 2 matrix the recursion starts from.
__device__ __forceinline__ float bayer4(int i, int j) {
  const int x0 = i & 1, y0 = j & 1;
  const int x1 = (i >> 1) & 1, y1 = (j >> 1) & 1;
  const int m = 4 * (2 * (x0 ^ y0) + y0) + 2 * (x1 ^ y1) + y1;
  return (static_cast<float>(m) + 0.5f) / 16.0f;
}

// Whether v fits a 16-bit signed integer.
__device__ __forceinline__ bool fits16(int v) {
  return v == static_cast<short>(v);
}

// The factor where lit of a pixel of decoded surface (hit, texel) under
// the frame's direction t: ops/shade.py's lambert_dot of the texel's normal
// (0 for background) and t, left to right, then factor_from_dot
// (std::min/std::max as ternaries, so a NaN dot gives a diffuse of 0):
// min(1, max(0, dot) + ambient).
__device__ __forceinline__ float directional_lit_factor(
    const DirFrames& px, float t0, float t1, float t2, bool hit,
    int texel) {
  float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
  if (hit) {
    const float* nv = px.w.atlas_normal + 3 * static_cast<size_t>(texel);
    n0 = nv[0];
    n1 = nv[1];
    n2 = nv[2];
  }
  const float dot = n0 * t0 + n1 * t1 + n2 * t2;
  const float diffuse = 0.0f < dot ? dot : 0.0f;
  const float bright = diffuse + px.w.ambient;
  return bright < 1.0f ? bright : 1.0f;
}

// The frame of a pixel at (i, j) of the view, from its decoded surface
// (hit, texel) and lit bit, into rgb[0..2]: the ambient factor where
// occluded, else directional_lit_factor, then ops/shade.py's shade_u8, or
// with px.dithered ops/dither.py's shade_dithered at view row j (the
// palette neighbours of the lit luminance by a count of palette lumas <=
// it, a clamp that keeps NaN, and the Bayer threshold of (j % 4, i % 4)).
__device__ __forceinline__ void shade_directional_pixel(
    const DirFrames& px, float t0, float t1, float t2, int i, int j,
    bool hit, int texel, bool occluded, unsigned char* rgb) {
  const int c = hit ? px.w.atlas_color[texel] : 0;
  const float factor =
      occluded ? px.w.ambient
               : directional_lit_factor(px, t0, t1, t2, hit, texel);
  const unsigned char* pal = px.w.palette;
  if (!px.dithered) {
    const int col[3] = {hit ? pal[4 * c] : px.w.bg_r,
                        hit ? pal[4 * c + 1] : px.w.bg_g,
                        hit ? pal[4 * c + 2] : px.w.bg_b};
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rgb[a] = static_cast<unsigned char>(
          static_cast<int>(static_cast<float>(col[a]) * factor));
    return;
  }
  const float* luma = px.palette_luma;
  const float target = (hit ? luma[c] : px.bg_luma) * factor;
  int below = -1;
  for (int k = 0; k < px.n_palette; ++k) below += luma[k] <= target ? 1 : 0;
  const int lo = below < 0 ? 0 : below;
  const int hi = min(lo + 1, px.n_palette - 1);
  const float luma_lo = luma[lo];
  const float luma_hi = luma[hi];
  const float span = luma_hi > luma_lo ? luma_hi - luma_lo : 1.0f;
  float frac = (target - luma_lo) / span;
  if (frac == frac) frac = frac < 0.0f ? 0.0f : (frac > 1.0f ? 1.0f : frac);
  const int idx = frac > bayer4(i, j) ? hi : lo;
#pragma unroll
  for (int a = 0; a < 3; ++a) rgb[a] = pal[4 * idx + a];
}

// ---------------------------------------------------------------------------
// The directional mode's march: one union of visit lists per tile.
// ---------------------------------------------------------------------------

// Keys a tile's table gives a mask bit: a tile of chip_smoke.py's graybox
// sweep holds at most 12.
constexpr int kDirKeys = 16;
// Open-addressed slots of the key table (insert_key hashes to 6 bits).
constexpr int kDirSlots = 64;
// Pixels a thread holds in registers while it walks the staged entries: a
// graybox tile of 1,600 pixels is one round of 320 threads.
constexpr int kDirPixels = 5;
// Union entries staged at once.
constexpr int kDirChunk = 64;
// An empty slot of the key table: no packed key is all ones, since the
// fields take at most 63 bits.
constexpr unsigned long long kNoKey = ~0ull;
// A pixel's table slot (DirSmem::slot) where the winner-input mode settles
// it: its colour is the same lit or occluded, so it takes no key and no
// march (beside par::kDirect and par::kNoPixel; table slots are below
// kDirSlots).
constexpr unsigned char kDirSettled = 0xFD;
// 4 blocks of 320 threads leave 51 registers a thread (48 used, a few
// bytes spilled), which measured faster than 3 blocks without spills.
constexpr int kDirBlocksPerSM = 4;

// 64-bit counters, one (7,) int64 array per launch's caller (added to):
// the directional mode's union entries staged, summed over the tiles, and
// the slab tests it performed, on its union lists and in its direct march;
// the winner-input mode's slab tests, on its lists and in its direct
// march, and its pixels marched (those not settled), in the launches that
// count (shadow_shade_kernel<true, WinnerPixels>); the same two of the
// multi-light mode, over its lights (shadow_shade_kernel<true,
// LightPixels>: slab tests and pixel-lights marched); and the pixels the
// winner-input directional mode marched (those not settled, on its lists
// and directly), in every launch of shadow_dir_kernel<DirFrames>.
enum MarchWork {
  kWorkStaged = 0,
  kWorkTests = 1,
  kWorkShadeTests = 2,
  kWorkShadeMarched = 3,
  kWorkLightTests = 4,
  kWorkLightMarched = 5,
  kWorkDirMarched = 6
};
// march_band adds its slab tests and its pixels marched side by side.
static_assert(kWorkShadeMarched == kWorkShadeTests + 1, "march_band's work");
static_assert(kWorkLightMarched == kWorkLightTests + 1, "march_band's work");

// The fields of a packed key, in order: the start bin's y and z, and the
// light bin minus the start bin in x, y and z (the start bin's x is the
// tile's).  Field a holds value - lo[a] in bits[a] <= 31 bits from bit
// shift[a]; ops/shadow_dir.key_fields sizes them from the RenderConfig.
// The keys divide by the bin size bs with a multiply: div_m, div_s1 and
// div_s2 are its magic number and shifts (bin_divisor).
constexpr int kKeyFields = 5;
struct KeyFields {
  int lo[kKeyFields];
  int bits[kKeyFields];
  int shift[kKeyFields];
  unsigned div_m;
  int div_s1, div_s2;
};

// Division of an unsigned 32-bit n by d >= 1 as a multiply and two shifts
// (Granlund and Montgomery's round-up method, exact for every n): with
// l = ceil(log2 d), m = floor(2^32 (2^l - d) / d) + 1,
// n / d = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0), t = (m n) >> 32.
__host__ void bin_divisor(unsigned d, KeyFields& kf) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  kf.div_m = static_cast<unsigned>(
      (((1ull << 32) * ((1ull << l) - d)) / d) + 1ull);
  kf.div_s1 = l < 1 ? l : 1;
  kf.div_s2 = l > 1 ? l - 1 : 0;
}

__device__ __forceinline__ unsigned udiv_bs(unsigned n, const KeyFields& kf) {
  const unsigned t = __umulhi(kf.div_m, n);
  return (t + ((n - t) >> kf.div_s1)) >> kf.div_s2;
}

// n / bs with C's truncation toward zero.
__device__ __forceinline__ int div_bs(int n, const KeyFields& kf) {
  return n >= 0 ? static_cast<int>(udiv_bs(static_cast<unsigned>(n), kf))
                : static_cast<int>(0u - udiv_bs(0u - static_cast<unsigned>(n),
                                                kf));
}

// The packed key of field values v, or kNoKey if one does not fit.
__device__ __forceinline__ unsigned long long pack_key(
    const KeyFields& kf, const int (&v)[kKeyFields]) {
  unsigned long long key = 0;
  bool fits = true;
#pragma unroll
  for (int a = 0; a < kKeyFields; ++a) {
    const unsigned u = static_cast<unsigned>(v[a])
                       - static_cast<unsigned>(kf.lo[a]);
    fits = fits && u < (1u << kf.bits[a]);
    key |= static_cast<unsigned long long>(u) << kf.shift[a];
  }
  return fits ? key : kNoKey;
}

// Exchange a and b.
__device__ __forceinline__ void swap_axis(float& a, float& b) {
  const float t = a;
  a = b;
  b = t;
}

// Field a's value in a packed key.
__device__ __forceinline__ int key_field(const KeyFields& kf,
                                         unsigned long long key, int a) {
  const unsigned long long m = (1ull << kf.bits[a]) - 1ull;
  return static_cast<int>((key >> kf.shift[a]) & m) + kf.lo[a];
}

// A flag known at compile time: the lockstep walk's two slab tests.
// Whether the box with near corner n and far corner r on every axis (for
// the signs of iv) meets the ray from o: the slab test of finite
// reciprocal directions, equal to par::slab_hit there (see the header).
__device__ __forceinline__ bool near_far_hit(float4 n, float4 r, float ox,
                                             float oy, float oz, float ivx,
                                             float ivy, float ivz) {
  const float lo = fmaxf(fmaxf((n.x - ox) * ivx, (n.y - oy) * ivy),
                         (n.z - oz) * ivz);
  const float hi = fminf(fminf((r.x - ox) * ivx, (r.y - oy) * ivy),
                         (r.z - oz) * ivz);
  return hi >= lo;
}

// The shared memory shadow_dir_kernel works in, with the per-pixel
// surface of the winner-input mode where `frames`; the base must be
// 16-byte aligned.
struct DirSmem {
  float4* cand;               // (kDirChunk * cap, 2) staged boxes
                              // (common.cuh Box)
  unsigned long long* slots;  // (kDirSlots,) the key table, kNoKey if empty
  unsigned long long* keys;   // (kDirKeys,) the key of each index
  int* index;                 // (kDirSlots,) each slot's key index, kDirect
                              // past kDirKeys
  int* ent_n;                 // (kDirChunk,) live slots of a staged entry
  unsigned* ent_mask;         // (kDirChunk,) its key mask
  int* ctl;                   // [0] keys inserted, [1] the longest visit
                              // list, [2] slab tests (unsigned), [3] the
                              // list path's pixels
  int* warp_n;                // (kMarchWarps,) union bins each warp found
  int* slot_n;                // (kDirSlots,) the list path's pixels of
                              // each slot's key; after the scan, where
                              // they start in `perm`
  unsigned* mask;             // (V,) the key mask of each flat bin
  int* list;                  // (V,) the union: bins with a mask, in flat
                              // order
  int* self;                  // (n_pix,) with frames: the pixel's entity
  short* y;                   // (n_pix,) the surface point's y
  short* z;                   // (n_pix,) and z (where they fit 16 bits)
  unsigned short* local;      // (n_pix,) the texel's offset in its sprite,
                              // kNoTexel for background
  unsigned short* perm;       // (n_pix,) the list path's pixels by key
  unsigned short* rank;       // (n_pix,) a pixel's place among its key's
  unsigned char* slot;        // (n_pix,) each pixel's table slot, kDirect
                              // or kNoPixel
  unsigned char* occ;         // (n_pix,) occluded by a union entry so far

  __host__ __device__ static size_t bytes(const par::Grid& g, int n_pix,
                                          bool frames) {
    return static_cast<size_t>(32 * kDirChunk * g.bin_cap
                               + 8 * (kDirSlots + kDirKeys)
                               + 4 * (2 * kDirSlots + 2 * kDirChunk + 4
                                      + par::kMarchWarps)
                               + 8 * g.volume() + (frames ? 16 : 6) * n_pix);
  }
  __device__ DirSmem(int* base, const par::Grid& g, int n_pix, bool frames) {
    char* p = reinterpret_cast<char*>(base);
    cand = reinterpret_cast<float4*>(p);
    p += 32 * kDirChunk * g.bin_cap;
    slots = reinterpret_cast<unsigned long long*>(p);
    keys = slots + kDirSlots;
    index = reinterpret_cast<int*>(keys + kDirKeys);
    ent_n = index + kDirSlots;
    ent_mask = reinterpret_cast<unsigned*>(ent_n + kDirChunk);
    ctl = reinterpret_cast<int*>(ent_mask + kDirChunk);
    warp_n = ctl + 4;
    slot_n = warp_n + par::kMarchWarps;
    mask = reinterpret_cast<unsigned*>(slot_n + kDirSlots);
    list = reinterpret_cast<int*>(mask + g.volume());
    self = list + g.volume();
    y = reinterpret_cast<short*>(self + (frames ? n_pix : 0));
    z = y + (frames ? n_pix : 0);
    local = reinterpret_cast<unsigned short*>(z + (frames ? n_pix : 0));
    perm = local + (frames ? n_pix : 0);
    rank = perm + n_pix;
    slot = reinterpret_cast<unsigned char*>(rank + n_pix);
    occ = slot + n_pix;
  }
};

// The slot of `key` in the tile's table, inserting it where it is missing;
// kDirect if the table is full.  A newly inserted key takes the next index
// (s.ctl[0]) and, below kDirKeys, its entry in s.keys.
__device__ inline int insert_key(const DirSmem& s, unsigned long long key) {
  static_assert(kDirSlots == 64, "the hash keeps the top 6 bits");
  int h = static_cast<int>((key * 0x9E3779B97F4A7C15ull) >> 58);
#pragma unroll 1
  for (int probe = 0; probe < kDirSlots; ++probe) {
    const unsigned long long old = atomicCAS(s.slots + h, kNoKey, key);
    if (old == kNoKey) {
      const int k = atomicAdd(s.ctl, 1);
      s.index[h] = k < kDirKeys ? k : par::kDirect;
      if (k < kDirKeys) s.keys[k] = key;
      return h;
    }
    if (old == key) return h;
    h = (h + 1) & (kDirSlots - 1);
  }
  return par::kDirect;
}

// ---------------------------------------------------------------------------
// The point modes: par::march_band from trace.cu's winners or from ray
// buffers.
// ---------------------------------------------------------------------------

// march_band's source of the winner-input point mode: each pixel's surface
// decoded from its winner (decode_winner) and its reciprocal direction
// 1 / (d / length) toward the frame's light; its store writes the lit bit,
// or with rgb the pixel's colour: ops/shade.py's lambert_dot,
// factor_from_dot (std::min/std::max as ternaries, so a NaN dot gives a
// diffuse of 0) and shade_u8.  With rgb a pixel whose factor lit is the
// ambient factor settles (ops/shade.py's point_frames marks the same
// pixels): with ambient <= 1 every background pixel and every face with
// a dot <= 0 or NaN; none with ambient > 1, every one with ambient 1.
struct WinnerRays : par::SurfaceRays {
  const int* pos;
  const int* ext;
  const int* players;
  const WinnerPixels& px;
  int f;
  int3 light;
  unsigned char* lit;
  unsigned char* rgb;
  static constexpr int max_steps = par::kNoStepCap;
  static constexpr bool kSettles = true;

  __device__ int3 light_bin(const par::Grid& g) const {
    return par::light_bin(light, g);
  }
  __device__ bool settles() const { return rgb != nullptr; }
  // The factor where lit of a pixel of atlas texel `texel` (-1 for
  // background) whose direction toward the light is tl: the Lambert dot
  // of the texel's normal (0 for background) and tl, then
  // min(1, max(0, dot) + ambient).
  __device__ float lit_factor(int texel, float3 tl) const {
    float n0 = 0.0f, n1 = 0.0f, n2 = 0.0f;
    if (texel >= 0) {
      const float* nv = px.atlas_normal + 3 * static_cast<size_t>(texel);
      n0 = nv[0];
      n1 = nv[1];
      n2 = nv[2];
    }
    const float dot = n0 * tl.x + n1 * tl.y + n2 * tl.z;
    const float diffuse = 0.0f < dot ? dot : 0.0f;
    const float bright = diffuse + px.ambient;
    return bright < 1.0f ? bright : 1.0f;
  }
  // Loads the pixel; returns whether it settles: with rgb, where its factor
  // lit is the ambient factor.  A settled pixel's direction is neither
  // marched nor stored, so it is not computed; a background pixel's
  // factor lit does not depend on it (its dot is 0 or NaN, its diffuse 0).
  __device__ bool load(const par::ShadeSmem& s, const par::Grid& g, int q,
                       int i, int j) const {
    const Surface u = decode_winner(pos, ext, players, px, g, f, i, j);
    const int texel = u.hit ? u.texel : -1;
    s.y[q] = u.y;
    s.z[q] = u.z;
    s.self[q] = u.ent;
    s.texel[q] = texel;
    if (rgb != nullptr && !u.hit
        && lit_factor(-1, make_float3(0.0f, 0.0f, 0.0f)) == px.ambient)
      return true;
    const float3 tl = par::towards_light(i, u.y, u.z, light);
    if (rgb != nullptr && lit_factor(texel, tl) == px.ambient) return true;
    s.ivx[q] = 1.0f / tl.x;
    s.ivy[q] = 1.0f / tl.y;
    s.ivz[q] = 1.0f / tl.z;
    return false;
  }
  __device__ void store(const par::ShadeSmem& s, const par::Grid& g, int q,
                        int i, int j, bool occluded) const {
    const size_t o = g.pixel(f, i, j);
    if (rgb == nullptr) {
      lit[o] = occluded ? 0 : 1;
      return;
    }
    const int texel = s.texel[q];
    int col[3] = {px.bg_r, px.bg_g, px.bg_b};
    if (texel >= 0) {
      const unsigned char* c = px.palette + 4 * px.atlas_color[texel];
      col[0] = c[0];
      col[1] = c[1];
      col[2] = c[2];
    }
    const float factor =
        occluded ? px.ambient
                 : lit_factor(texel, par::towards_light(i, s.y[q], s.z[q],
                                                        light));
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rgb[3 * o + a] = static_cast<unsigned char>(
          static_cast<int>(static_cast<float>(col[a]) * factor));
  }
};

// march_band's source of the multi-light mode for light l of the frame's
// n_lights: WinnerRays toward that light, whose loads and stores keep a
// pixel across the lights.  Light 0's load decodes each pixel from its
// winner into the band's shared memory (y, z, entity, texel), which
// march_band's other steps leave as they are, and the later lights' loads
// read it back (a thread loads the same pixels at every light), so a
// winner is decoded once.  For light l a pixel settles where its factor
// lit toward l is the ambient factor (background pixels at every light
// where bg_settles): its factor is then the ambient either way, and light
// l adds max(ambient - ambient, 0) to its sum.  The store adds
// max(factor_l - ambient, 0) (a max that keeps a NaN gain, as
// ops/shade.py's add_light) to the pixel's float32 sum, which it keeps in
// `sums` between lights; the last light's store writes trunc(colour *
// min(1, ambient + sum)) (a min that keeps a NaN total: ops/shade.py's
// multi_light_factor, then shade_u8).
struct LightRays : WinnerRays {
  int l;
  int n_lights;
  bool bg_settles;
  float* sums;

  __device__ bool load(const par::ShadeSmem& s, const par::Grid& g, int q,
                       int i, int j) const {
    int y, z, texel;
    if (l == 0) {
      const Surface u = decode_winner(pos, ext, players, px, g, f, i, j);
      y = u.y;
      z = u.z;
      texel = u.hit ? u.texel : -1;
      s.y[q] = y;
      s.z[q] = z;
      s.self[q] = u.ent;
      s.texel[q] = texel;
    } else {
      y = s.y[q];
      z = s.z[q];
      texel = s.texel[q];
    }
    if (texel < 0 && bg_settles) return true;
    const float3 tl = par::towards_light(i, y, z, light);
    if (lit_factor(texel, tl) == px.ambient) return true;
    s.ivx[q] = 1.0f / tl.x;
    s.ivy[q] = 1.0f / tl.y;
    s.ivz[q] = 1.0f / tl.z;
    return false;
  }
  __device__ void store(const par::ShadeSmem& s, const par::Grid& g, int q,
                        int i, int j, bool occluded) const {
    const size_t o = g.pixel(f, i, j);
    const int texel = s.texel[q];
    const float factor =
        occluded ? px.ambient
                 : lit_factor(texel, par::towards_light(i, s.y[q], s.z[q],
                                                        light));
    const float gain = factor - px.ambient;
    const float sum = (l == 0 ? 0.0f : sums[o]) + (gain < 0.0f ? 0.0f : gain);
    if (l + 1 < n_lights) {
      sums[o] = sum;
      return;
    }
    const float total = px.ambient + sum;
    const float shade = 1.0f < total ? 1.0f : total;
    int col[3] = {px.bg_r, px.bg_g, px.bg_b};
    if (texel >= 0) {
      const unsigned char* c = px.palette + 4 * px.atlas_color[texel];
      col[0] = c[0];
      col[1] = c[1];
      col[2] = c[2];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
      rgb[3 * o + a] = static_cast<unsigned char>(
          static_cast<int>(static_cast<float>(col[a]) * shade));
  }
};

// A start bin's three components in one word, kRayField bits each (biased
// by half their range), where they fit.
constexpr int kRayField = 21;
constexpr unsigned kRayBias = 1u << (kRayField - 1);
constexpr unsigned long long kRayMask = (1ull << kRayField) - 1ull;

// march_band's source of the G-buffer point mode: each pixel's ray from
// the ten buffers of PixelRays, which need not come from the view (the
// origin's x is kept in s.texel as float bits, and y and z in s.y and s.z,
// so any origin takes the list path); a key is the whole start bin, and a
// pixel whose start bin does not fit the packed key marches on its own.
// Its store writes the lit bit, so no pixel settles.
struct BufferRays {
  const PixelRays& rays;
  int f;
  int max_steps;
  unsigned char* lit;
  static constexpr bool kSettles = false;

  __device__ int3 light_bin(const par::Grid&) const {
    return make_int3(rays.light_bin[3 * f], rays.light_bin[3 * f + 1],
                     rays.light_bin[3 * f + 2]);
  }
  __device__ void load(const par::ShadeSmem& s, const par::Grid& g, int q,
                       int i, int j) const {
    const size_t o = g.pixel(f, i, j);
    s.texel[q] = __float_as_int(rays.ox[o]);
    s.y[q] = __float_as_int(rays.oy[o]);
    s.z[q] = __float_as_int(rays.oz[o]);
    s.self[q] = rays.self[o];
    s.ivx[q] = rays.ivx[o];
    s.ivy[q] = rays.ivy[o];
    s.ivz[q] = rays.ivz[o];
  }
  __device__ bool key(const par::ShadeSmem&, const par::Grid& g, int,
                      int i, int j, unsigned long long& k) const {
    const size_t o = g.pixel(f, i, j);
    const unsigned u[3] = {static_cast<unsigned>(rays.rbx[o]) + kRayBias,
                           static_cast<unsigned>(rays.rby[o]) + kRayBias,
                           static_cast<unsigned>(rays.rbz[o]) + kRayBias};
    k = 0ull;
    bool fits = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      fits = fits && u[a] <= kRayMask;
      k |= static_cast<unsigned long long>(u[a]) << (kRayField * a);
    }
    return fits;
  }
  __device__ static int3 start(unsigned long long k, const par::Band&) {
    int v[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      v[a] = static_cast<int>(static_cast<unsigned>(
                 (k >> (kRayField * a)) & kRayMask) - kRayBias);
    return make_int3(v[0], v[1], v[2]);
  }
  __device__ static float3 origin(const par::ShadeSmem& s, int q, int) {
    return make_float3(__int_as_float(s.texel[q]), __int_as_float(s.y[q]),
                       __int_as_float(s.z[q]));
  }
  __device__ par::Ray direct(const par::ShadeSmem&, const par::Grid& g,
                             const par::Band&, int, int i, int j) const {
    const size_t o = g.pixel(f, i, j);
    return par::Ray{rays.rbx[o], rays.rby[o], rays.rbz[o],
                    rays.ox[o],  rays.oy[o],  rays.oz[o],
                    rays.ivx[o], rays.ivy[o], rays.ivz[o],
                    rays.self[o]};
  }
  __device__ void store(const par::ShadeSmem&, const par::Grid& g, int,
                        int i, int j, bool occluded) const {
    lit[g.pixel(f, i, j)] = occluded ? 0 : 1;
  }
};

__device__ __forceinline__ WinnerRays source(
    const WinnerPixels& px, const int* pos, const int* ext,
    const int* players, int f, int, unsigned char* lit, unsigned char* rgb) {
  return WinnerRays{{}, pos, ext, players, px, f,
                    make_int3(px.lights[3 * f], px.lights[3 * f + 1],
                              px.lights[3 * f + 2]),
                    lit, rgb};
}

__device__ __forceinline__ BufferRays source(
    const PixelRays& rays, const int*, const int*, const int*, int f,
    int max_steps, unsigned char* lit, unsigned char*) {
  return BufferRays{rays, f, max_steps, lit};
}

// The source of light l of frame f in the multi-light mode.
__device__ __forceinline__ LightRays light_source(
    const LightPixels& px, const int* pos, const int* ext,
    const int* players, int f, int l, bool bg_settles, unsigned char* rgb) {
  const int* lt = px.w.lights + 3 * (static_cast<size_t>(f) * px.n_lights + l);
  return LightRays{{{}, pos, ext, players, px.w, f,
                    make_int3(lt[0], lt[1], lt[2]), nullptr, rgb},
                   l, px.n_lights, bg_settles, px.sums};
}

// The point modes: march_band over band blockIdx.z of bin-column tile
// blockIdx.x of the Grid's window, frame blockIdx.y (par::Band::of_block),
// from the winners (Px = WinnerPixels: the lit mask, or with rgb the
// shaded frame; one of lit and rgb is null) or from the ray buffers
// (Px = PixelRays: the lit mask under step cap max_steps).  Launch as
// march_band asks.  With kCount the block adds its slab tests to
// work[kWorkShadeTests] and its pixels marched to work[kWorkShadeMarched];
// without, work is not read.
// The multi-light mode (Px = LightPixels: the shaded frame into rgb) runs
// march_band once a light, in light order, on the same shared memory
// (LightRays), a barrier between lights; with kCount it adds its slab
// tests and pixel-lights marched to work[kWorkLightTests] and
// work[kWorkLightMarched].
template <bool kCount, class Px>
__global__ void __launch_bounds__(par::kMarchThreads,
                                  par::kMarchBlocksPerSM)
shadow_shade_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, Px px, unsigned char* __restrict__ lit,
    unsigned char* __restrict__ rgb, int* __restrict__ stats,
    unsigned long long* __restrict__ work, par::Grid g, int max_steps,
    int chunk) {
  extern __shared__ __align__(16) int smem[];
  const par::ShadeSmem s(smem, g, g.band_pixels(), chunk);
  const int f = blockIdx.y;
  if constexpr (std::is_same_v<Px, LightPixels>) {
    const par::Band b = par::Band::of_block(g);
    // Whether the background settles, once for all lights: its normal is
    // 0, so its factor lit is the same toward every light.
    const bool bg_settles =
        light_source(px, pos, ext, players, f, 0, false, rgb)
            .lit_factor(-1, make_float3(0.0f, 0.0f, 0.0f)) == px.w.ambient;
    for (int l = 0; l < px.n_lights; ++l) {
      if (l > 0) __syncthreads();
      const LightRays src =
          light_source(px, pos, ext, players, f, l, bg_settles, rgb);
      par::march_band<kCount>(pos, ext, players, bins_ent, counts, f, g, b,
                              src.light_bin(g), src.max_steps, s, chunk,
                              src, stats,
                              kCount ? work + kWorkLightTests : nullptr);
    }
  } else {
    const auto src = source(px, pos, ext, players, f, max_steps, lit, rgb);
    par::march_band<kCount>(pos, ext, players, bins_ent, counts, f, g,
                            par::Band::of_block(g), src.light_bin(g),
                            src.max_steps, s, chunk, src, stats,
                            kCount ? work + kWorkShadeTests : nullptr);
  }
}

// The lit mask (Px = SurfacePixels: out is (F, H, W) 0/1) or the frame
// (Px = DirFrames: out is (F, H, W, 3) RGB) of bin-column tile blockIdx.x
// of frame blockIdx.y under a directional light, in five phases (the
// header's 1-4, then the pixels off the list path and the store).  All
// threads of the block take part; blockDim.x is a multiple of 32 and at
// most kMarchThreads.
template <class Px>
__global__ void __launch_bounds__(par::kMarchThreads, kDirBlocksPerSM)
shadow_dir_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, Px px,
    const float* __restrict__ inv, const int* __restrict__ offsets,
    unsigned char* __restrict__ out, int* __restrict__ stats,
    unsigned long long* __restrict__ work, par::Grid g, int max_steps,
    KeyFields kf) {
  constexpr bool kFrames = std::is_same<Px, DirFrames>::value;
  extern __shared__ __align__(16) int smem[];
  const int bs = g.bin_size;
  const int n_pix = bs * bs;
  const DirSmem s(smem, g, n_pix, kFrames);
  const int V = g.volume();
  const int cap = g.bin_cap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid / 32;
  const int f = blockIdx.y;
  const par::Band tile = par::Band::tile(g, blockIdx.x);
  const int i0 = tile.i0(g);
  const int j0 = tile.j0(g);
  const int kx = offsets[3 * f], ky = offsets[3 * f + 1];
  const int kz = offsets[3 * f + 2];
  const float ivx = inv[3 * f], ivy = inv[3 * f + 1], ivz = inv[3 * f + 2];

  for (int v = tid; v < V; v += nt) s.mask[v] = 0u;
  for (int h = tid; h < kDirSlots; h += nt) {
    s.slots[h] = kNoKey;
    s.slot_n[h] = 0;
  }
  if (tid < 4) s.ctl[tid] = 0;
  __syncthreads();

  // 1. Each pixel's key, (start bin, light bin) of the ray from surface
  //    point (i, y, z), and the tile's table of distinct keys: the lowest
  //    lane of each key in a warp inserts it and takes places for the
  //    key's lanes among the slot's pixels.  A thread loads the surface
  //    points of kDirPixels pixels (those of TilePixel's order) at once;
  //    with frames it decodes them from their winners and keeps them in
  //    shared memory, and a pixel whose y or z does not fit there takes
  //    the direct march.  With frames a pixel whose factor lit
  //    (directional_lit_factor, the store's own operations) is the ambient
  //    factor settles (kDirSettled): it takes no key, no place and no
  //    march, and the store shades it as occluded, the same bytes.
  par::TilePixel tp(bs);
  for (int r0 = 0; r0 < n_pix; r0 += nt * kDirPixels) {
    int qs[kDirPixels], is[kDirPixels], ys[kDirPixels], zs[kDirPixels];
    unsigned wide = 0u;  // bit p: pixel p's y or z does not fit 16 bits
    unsigned settled = 0u;  // bit p: pixel p settles
#pragma unroll
    for (int p = 0; p < kDirPixels; ++p) {
      qs[p] = tp.q;
      is[p] = i0 + tp.col;
      const int j = j0 + tp.row;
      ys[p] = zs[p] = 0;
      if (tp.q < n_pix && is[p] < g.view_w && j < g.view_h) {
        if constexpr (kFrames) {
          const WinnerPixels& w = px.w;
          const Surface u = decode_winner(pos, ext, players, w, g, f, is[p],
                                          j);
          ys[p] = u.y;
          zs[p] = u.z;
          s.self[tp.q] = u.ent;
          s.y[tp.q] = static_cast<short>(u.y);
          s.z[tp.q] = static_cast<short>(u.z);
          s.local[tp.q] = u.hit ? static_cast<unsigned short>(
                                      u.texel - w.sprite_id[u.ent]
                                                    * w.sprite_h * w.sprite_w)
                                : kNoTexel;
          wide |= fits16(u.y) && fits16(u.z) ? 0u : 1u << p;
          settled |= directional_lit_factor(px, px.tl[3 * f],
                                            px.tl[3 * f + 1],
                                            px.tl[3 * f + 2], u.hit, u.texel)
                             == w.ambient
                         ? 1u << p
                         : 0u;
        } else {
          const size_t o = g.pixel(f, is[p], j);
          ys[p] = px.y[o];
          zs[p] = px.z[o];
        }
      } else {
        is[p] = -1;  // out of view
      }
      tp.next();
    }
#pragma unroll
    for (int p = 0; p < kDirPixels; ++p) {
      const bool live = is[p] >= 0;
      const bool settles = ((settled >> p) & 1u) != 0u;
      unsigned long long key = kNoKey;
      if (live && !settles) {
        const int hy = g.view_h - ys[p] - zs[p];
        const int sby = div_bs(hy, kf);
        const int sbz = div_bs(zs[p], kf);
        const int v[kKeyFields] = {sby, sbz,
                                   div_bs(is[p] + kx, kf) - tile.bin_x,
                                   div_bs(hy - (ky + kz), kf) - sby,
                                   div_bs(zs[p] + kz, kf) - sbz};
        key = pack_key(kf, v);
        if constexpr (kFrames) {
          if ((wide >> p) & 1u) key = kNoKey;
        }
      }
      const unsigned same = __match_any_sync(par::kFullWarp, key);
      const int leader = __ffs(same) - 1;
      int h = par::kDirect;
      int first = 0;
      if (key != kNoKey && lane == leader) {
        h = insert_key(s, key);
        if (h < kDirSlots) first = atomicAdd(s.slot_n + h, __popc(same));
      }
      h = __shfl_sync(par::kFullWarp, h, leader);
      first = __shfl_sync(par::kFullWarp, first, leader);
      if (qs[p] < n_pix) {
        s.slot[qs[p]] = static_cast<unsigned char>(
            !live     ? par::kNoPixel
            : settles ? kDirSettled
            : key == kNoKey ? par::kDirect
                            : h);
        s.rank[qs[p]] = static_cast<unsigned short>(
            first + __popc(same & ((1u << lane) - 1u)));
        s.occ[qs[p]] = 0;
      }
    }
  }
  __syncthreads();
  const int inserted = s.ctl[0];
  const int n = min(inserted, kDirKeys);
  // Pixel q's key index, or kDirect off the list path (or out of view).
  auto key_index = [&](int q) {
    const int sl = s.slot[q];
    return sl < kDirSlots ? s.index[sl] : par::kDirect;
  };

  // 1b. Sort the list path's pixels by key: a scan of the slots' counts
  //     (the slots of keys past the table hold none), then each pixel's
  //     place, so that a warp's lanes hold pixels of one key, which take
  //     the same union entries.
  if (warp == 0) {
    static_assert(kDirSlots == 64, "two slots a lane");
    int c[2];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int h = 2 * lane + a;
      c[a] = s.slots[h] != kNoKey && s.index[h] < kDirKeys ? s.slot_n[h]
                                                          : 0;
    }
    int sum = c[0] + c[1];
    for (int d = 1; d < 32; d *= 2) {
      const int o = __shfl_up_sync(par::kFullWarp, sum, d);
      if (lane >= d) sum += o;
    }
    s.slot_n[2 * lane] = sum - c[0] - c[1];
    s.slot_n[2 * lane + 1] = sum - c[1];
    if (lane == 31) s.ctl[3] = sum;
  }
  __syncthreads();
  for (par::TilePixel p(bs); p.q < n_pix; p.next()) {
    const int sl = s.slot[p.q];
    if (sl < kDirSlots && s.index[sl] < kDirKeys)
      s.perm[s.slot_n[sl] + s.rank[p.q]] = static_cast<unsigned short>(p.q);
  }

  // 2. One DDA per key, a warp each, setting the key's bit in every bin it
  //    probes; the bins whose bit it set first are its visit list.
  for (int k = warp; k < n; k += nt / 32) {
    const unsigned long long key = s.keys[k];
    const int sby = key_field(kf, key, 0);
    const int sbz = key_field(kf, key, 1);
    const unsigned bit = 1u << k;
    int m = 0;
    par::dda_rounds(tile.bin_x, sby, sbz, tile.bin_x + key_field(kf, key, 2),
                    sby + key_field(kf, key, 3), sbz + key_field(kf, key, 4),
                    g, max_steps, [&](int flat) {
      const bool fresh =
          flat >= 0 && (atomicOr(s.mask + flat, bit) & bit) == 0u;
      m += __popc(__ballot_sync(par::kFullWarp, fresh));
    });
    if (lane == 0) atomicMax(s.ctl + 1, m);
  }
  __syncthreads();

  // 3. The union: the bins with a mask, in flat order; thread t takes a
  //    run of `per` bins, and a scan of the runs' counts places them.
  const int per = (V + nt - 1) / nt;
  const int v0 = min(tid * per, V);
  const int v1 = min(v0 + per, V);
  int c = 0;
  for (int v = v0; v < v1; ++v) c += s.mask[v] != 0u ? 1 : 0;
  int upto = c;  // the union bins of this warp's runs up to this thread's
  for (int d = 1; d < 32; d *= 2) {
    const int o = __shfl_up_sync(par::kFullWarp, upto, d);
    if (lane >= d) upto += o;
  }
  if (lane == 31) s.warp_n[warp] = upto;
  __syncthreads();
  int at = upto - c;
  int total = 0;
  for (int w = 0; w < nt / 32; ++w) {
    const int t = s.warp_n[w];
    at += w < warp ? t : 0;
    total += t;
  }
  for (int v = v0; v < v1; ++v)
    if (s.mask[v] != 0u) s.list[at++] = v;
  __syncthreads();

  // 4. Stage the union kDirChunk entries at a time and walk each chunk in
  //    lockstep, kDirPixels pixels a thread in registers: pixel p of lane
  //    l of warp w in a round is perm[r0 + (w * kDirPixels + p) * 32 + l],
  //    so a warp holds a run of 32 * kDirPixels pixels in key order, of one
  //    key (two at a key's end), and its lanes take the same entry and
  //    slot together.
  const int n_list = s.ctl[3];
  const size_t fbase = static_cast<size_t>(f) * V;
  unsigned tests = 0;
  auto march_chunks = [&](auto near_far) {
    constexpr bool kNearFar = decltype(near_far)::value;
    for (int c0 = 0; c0 < total; c0 += kDirChunk) {
      const int nb = min(kDirChunk, total - c0);
      for (int t = tid; t < nb * cap; t += nt) {
        const int e = t / cap;
        const int k = t % cap;
        const int flat = s.list[c0 + e];
        const size_t b = fbase + flat;
        const int live = min(counts[b], cap);
        if (k == 0) {
          s.ent_n[e] = live;
          s.ent_mask[e] = s.mask[flat];
        }
        if (k < live) {
          par::Box box = par::candidate_box(pos, ext, players,
                                            bins_ent[b * cap + k], f);
          if constexpr (kNearFar) {  // each axis's near corner first
            if ((ivx < 0.0f) != (box.lo.x > box.hi.x))
              swap_axis(box.lo.x, box.hi.x);
            if ((ivy < 0.0f) != (box.lo.y > box.hi.y))
              swap_axis(box.lo.y, box.hi.y);
            if ((ivz < 0.0f) != (box.lo.z > box.hi.z))
              swap_axis(box.lo.z, box.hi.z);
          }
          s.cand[2 * t] = box.lo;
          s.cand[2 * t + 1] = box.hi;
        }
      }
      __syncthreads();
      for (int r0 = 0; r0 < n_list; r0 += nt * kDirPixels) {
        float ox[kDirPixels], oy[kDirPixels], oz[kDirPixels];
        int self[kDirPixels];
        unsigned bit[kDirPixels];  // the pixel's key bit; 0 once done
#pragma unroll
        for (int p = 0; p < kDirPixels; ++p) {
          const int at = r0 + (warp * kDirPixels + p) * 32 + lane;
          const int q = at < n_list ? s.perm[at] : 0;
          ox[p] = oy[p] = oz[p] = 0.0f;
          self[p] = 0;
          bit[p] = 0u;
          if (at < n_list && !s.occ[q]) {
            const int row = static_cast<int>(udiv_bs(q, kf));
            const int i = i0 + q - row * bs;
            ox[p] = static_cast<float>(i);
            if constexpr (kFrames) {
              oy[p] = static_cast<float>(s.y[q]);
              oz[p] = static_cast<float>(s.z[q]);
              self[p] = s.self[q];
            } else {
              const size_t o = g.pixel(f, i, j0 + row);
              oy[p] = static_cast<float>(px.y[o]);
              oz[p] = static_cast<float>(px.z[o]);
              self[p] = px.self[o];
            }
            bit[p] = 1u << key_index(q);
          }
        }
        unsigned hit = 0u;
        for (int e = 0; e < nb; ++e) {
          unsigned marching = 0u;
          unsigned act = 0u;  // bit p: pixel p tests this entry
          const unsigned em = s.ent_mask[e];
#pragma unroll
          for (int p = 0; p < kDirPixels; ++p) {
            marching |= bit[p];
            act |= (em & bit[p]) != 0u ? 1u << p : 0u;
          }
          if (__ballot_sync(par::kFullWarp, marching != 0u) == 0u) break;
          if (__ballot_sync(par::kFullWarp, act != 0u) == 0u) continue;
          const int live = s.ent_n[e];
          for (int t = e * cap; t < e * cap + live; ++t) {
            const float4 a = s.cand[2 * t];
            const float4 z = s.cand[2 * t + 1];
            const int id = __float_as_int(a.w);
#pragma unroll
            for (int p = 0; p < kDirPixels; ++p) {
              if (((act >> p) & 1u) == 0u || id == self[p]) continue;
              ++tests;
              bool occluded;
              if constexpr (kNearFar) {
                occluded = near_far_hit(a, z, ox[p], oy[p], oz[p], ivx, ivy,
                                        ivz);
              } else {
                const par::Ray r{0, 0, 0, ox[p], oy[p], oz[p],
                                 ivx, ivy, ivz, self[p]};
                occluded = par::slab_hit(a.x, a.y, a.z, z.x, z.y, z.z, r);
              }
              if (occluded) {
                act &= ~(1u << p);
                bit[p] = 0u;
                hit |= 1u << p;
              }
            }
          }
        }
#pragma unroll
        for (int p = 0; p < kDirPixels; ++p)
          if ((hit >> p) & 1u)
            s.occ[s.perm[r0 + (warp * kDirPixels + p) * 32 + lane]] = 1;
      }
      __syncthreads();
    }
  };
  if (isfinite(ivx) && isfinite(ivy) && isfinite(ivz)) {
    march_chunks(std::true_type{});
  } else {
    march_chunks(std::false_type{});
  }

  // 5. Pixels off the list path march on their own (with frames, from
  //    their winners decoded again; a settled pixel does not march and is
  //    stored as occluded); every pixel's lit bit, or its colour.
  float t0 = 0.0f, t1 = 0.0f, t2 = 0.0f;  // with frames: the direction
  if constexpr (kFrames) {
    t0 = px.tl[3 * f];
    t1 = px.tl[3 * f + 1];
    t2 = px.tl[3 * f + 2];
  }
  int direct = 0;
  for (par::TilePixel p(bs); p.q < n_pix; p.next()) {
    const int sl = s.slot[p.q];
    if (sl == par::kNoPixel) continue;
    const int i = i0 + p.col;
    const int j = j0 + p.row;
    bool settles = false;
    if constexpr (kFrames) settles = sl == kDirSettled;
    bool occluded = settles || s.occ[p.q] != 0;
    bool hit = false;  // with frames: the pixel's surface, hit and texel
    int texel = 0;
    if (!settles && key_index(p.q) == par::kDirect) {
      int y, z, self;
      if constexpr (kFrames) {
        const Surface u = decode_winner(pos, ext, players, px.w, g, f, i, j);
        y = u.y;
        z = u.z;
        self = u.ent;
        hit = u.hit;
        texel = u.texel;
      } else {
        const size_t o = g.pixel(f, i, j);
        y = px.y[o];
        z = px.z[o];
        self = px.self[o];
      }
      const int hy = g.view_h - y - z;
      const par::Ray r{i / bs, hy / bs, z / bs, static_cast<float>(i),
                       static_cast<float>(y), static_cast<float>(z),
                       ivx, ivy, ivz, self};
      occluded = par::march_occluded<true>(
          pos, ext, players, bins_ent, counts, f, g, r,
          make_int3((i + kx) / bs, (hy - (ky + kz)) / bs, (z + kz) / bs),
          max_steps, &tests);
      ++direct;
    } else if constexpr (kFrames) {
      const int local = s.local[p.q];
      hit = local != kNoTexel;
      texel = px.w.sprite_id[s.self[p.q]] * px.w.sprite_h * px.w.sprite_w
              + local;
    }
    if constexpr (kFrames) {
      shade_directional_pixel(px, t0, t1, t2, i, j, hit, texel, occluded,
                              out + 3 * g.pixel(f, i, j));
    } else {
      out[g.pixel(f, i, j)] = occluded ? 0 : 1;
    }
  }
  if (direct > 0) atomicAdd(stats + par::kStatDirect, direct);
  tests = __reduce_add_sync(par::kFullWarp, tests);
  if (lane == 0 && tests > 0u)
    atomicAdd(reinterpret_cast<unsigned*>(s.ctl + 2), tests);
  if constexpr (kFrames) {
    // Each warp's direct pixels, in warp_n (phase 3 read it last).
    direct = __reduce_add_sync(par::kFullWarp, direct);
    if (lane == 0) s.warp_n[warp] = direct;
  }
  __syncthreads();
  if (tid == 0) {
    atomicMax(stats + par::kStatStarts, n + (inserted > kDirKeys ? 1 : 0));
    atomicMax(stats + par::kStatList, s.ctl[1]);
    atomicAdd(work + kWorkStaged, static_cast<unsigned long long>(total));
    atomicAdd(work + kWorkTests, static_cast<unsigned long long>(
                                     static_cast<unsigned>(s.ctl[2])));
    if constexpr (kFrames) {
      // The pixels marched: the list path's and the direct ones.
      int marched = n_list;
      for (int w = 0; w < nt / 32; ++w) marched += s.warp_n[w];
      atomicAdd(work + kWorkDirMarched,
                static_cast<unsigned long long>(marched));
    }
  }
}

size_t dir_smem(const par::Grid& g, bool frames) {
  return DirSmem::bytes(g, g.bin_size * g.bin_size, frames);
}

// The KeyFields of fields (10,) int32 on the host, each key field's lo then
// its bits (ops/shadow_dir.key_fields), for bins of bin_size.
KeyFields key_fields(const void* fields, int bin_size) {
  const int* fl = static_cast<const int*>(fields);
  KeyFields kf;
  int shift = 0;
  for (int a = 0; a < kKeyFields; ++a) {
    kf.lo[a] = fl[a];
    kf.bits[a] = fl[kKeyFields + a];
    kf.shift[a] = shift;
    shift += kf.bits[a];
  }
  bin_divisor(static_cast<unsigned>(bin_size), kf);
  return kf;
}

size_t shade_smem(const par::Grid& g, int chunk) {
  return par::ShadeSmem::bytes(g, g.band_pixels(), chunk);
}

// Let `kernel` take `smem` bytes of dynamic shared memory (an opt-in above
// 48 KB).  Returns the CUDA error code.
template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// Shared bytes of one block, the blocks one SM holds at `threads` threads,
// registers a thread and local (stack and spill) bytes a thread, into
// out[0..3].  Returns the CUDA error code.
template <class Kernel>
int occupancy(Kernel kernel, size_t smem, int threads, int* out) {
  out[0] = static_cast<int>(smem);
  const int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, kernel, threads, smem));
}

}  // namespace

// lit (F, rows, W) uint8 (0/1) for the window of bin rows row_bin0 ..
// row_bin0 + bin_rows - 1, as for par_trace_winners (the whole view for 0
// and hash_h).  The ten ray inputs are (F, rows, W): start bin x/y/z
// int32, origin x/y/z and inverse direction x/y/z float32, own entity
// int32; light_bin (F, 3) int32; tables as for par_trace_winners; stats
// (3,) int32 device counters (common.cuh MarchStat), added to; max_steps
// the step cap, < 0 for none.  One block of `threads` per (frame, bin
// column of the window, band of the Grid's band_rows rows); chunk >=
// kShadeKeys list entries staged at once.  Returns cudaGetLastError().
extern "C" int par_shadow_lit(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* rbx,
    const void* rby, const void* rbz, const void* ox, const void* oy,
    const void* oz, const void* ivx, const void* ivy, const void* ivz,
    const void* start_ent, const void* light_bin, void* lit, void* stats,
    int n_frames, int view_w, int view_h, int bin_size, int bin_cap,
    int hash_w, int hash_h, int hash_l, int row_bin0, int bin_rows,
    int max_steps, int chunk, int threads, void* stream) {
  const par::Grid g = par::Grid{view_w, view_h, bin_size, bin_cap, hash_w,
                                hash_h, hash_l}.window(row_bin0, bin_rows);
  const size_t smem = shade_smem(g, chunk);
  const auto kernel = shadow_shade_kernel<false, PixelRays>;
  const int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  const PixelRays rays{
      static_cast<const int*>(rbx),   static_cast<const int*>(rby),
      static_cast<const int*>(rbz),   static_cast<const float*>(ox),
      static_cast<const float*>(oy),  static_cast<const float*>(oz),
      static_cast<const float*>(ivx), static_cast<const float*>(ivy),
      static_cast<const float*>(ivz), static_cast<const int*>(start_ent),
      static_cast<const int*>(light_bin)};
  const dim3 grid(hash_w * bin_rows, n_frames, g.bands);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), rays, static_cast<unsigned char*>(lit),
      nullptr, static_cast<int*>(stats), nullptr, g,
      max_steps < 0 ? par::kNoStepCap : max_steps, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The winner-input point mode over the whole view.  winner (F, H, W)
// int32 (trace.cu's, -1 background); sprite_id (N,), atlas_depth and
// atlas_color (S, SH, SW) int32, atlas_normal (S, SH, SW, 3) float32,
// palette (P, 4) uint8, lights (F, 3) int32; the tables, players and stats
// as for par_shadow_lit; background bg_* and ambient as in RenderConfig.
// Writes rgb (F, H, W, 3) uint8, the shaded frames, where rgb is not null,
// else lit (F, H, W) uint8 (0/1).  work (7,) int64 (MarchWork), added to,
// or null: with it the launch counts its slab tests and pixels marched
// (shadow_shade_kernel<true, WinnerPixels>), without it it runs the kernel
// that does not count.  One block of
// `threads` per (frame, bin column, band of the Grid's band_rows rows);
// chunk >= kShadeKeys list entries staged at once.  Returns
// cudaGetLastError().
extern "C" int par_shadow_shade(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* winner,
    const void* sprite_id, const void* atlas_depth, const void* atlas_color,
    const void* atlas_normal, const void* palette, const void* lights,
    void* lit, void* rgb, void* stats, void* work, int n_frames, int view_w,
    int view_h, int bin_size, int bin_cap, int hash_w, int hash_h,
    int hash_l, int sprite_w, int sprite_h, int bg_r, int bg_g, int bg_b,
    float ambient, int chunk, int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = shade_smem(g, chunk);
  const auto kernel = work == nullptr
                          ? shadow_shade_kernel<false, WinnerPixels>
                          : shadow_shade_kernel<true, WinnerPixels>;
  const int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  const WinnerPixels px{static_cast<const int*>(winner),
                        static_cast<const int*>(sprite_id),
                        static_cast<const int*>(atlas_depth),
                        static_cast<const int*>(atlas_color),
                        static_cast<const float*>(atlas_normal),
                        static_cast<const unsigned char*>(palette),
                        static_cast<const int*>(lights),
                        sprite_w,
                        sprite_h,
                        bg_r,
                        bg_g,
                        bg_b,
                        ambient};
  const dim3 grid(hash_w * hash_h, n_frames, g.bands);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), px, static_cast<unsigned char*>(lit),
      static_cast<unsigned char*>(rgb), static_cast<int*>(stats),
      static_cast<unsigned long long*>(work), g, par::kNoStepCap, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The multi-light mode over the whole view: rgb (F, H, W, 3) uint8, the
// frames of lights (F, L, 3) int32, L = n_lights >= 1 point lights a frame
// whose diffuse adds in light order; sums (F, H, W) float32 scratch, or
// null where L is 1; work (7,) int64 (MarchWork), added to, or null (with
// it the counting kernel, shadow_shade_kernel<true, LightPixels>); the rest
// as for par_shadow_shade.  One launch: each block marches its band once a
// light.  Returns cudaGetLastError().
extern "C" int par_shadow_lights(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* winner,
    const void* sprite_id, const void* atlas_depth, const void* atlas_color,
    const void* atlas_normal, const void* palette, const void* lights,
    void* sums, void* rgb, void* stats, void* work, int n_frames,
    int n_lights, int view_w, int view_h, int bin_size, int bin_cap,
    int hash_w, int hash_h, int hash_l, int sprite_w, int sprite_h, int bg_r,
    int bg_g, int bg_b, float ambient, int chunk, int threads,
    void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = shade_smem(g, chunk);
  const auto kernel = work == nullptr
                          ? shadow_shade_kernel<false, LightPixels>
                          : shadow_shade_kernel<true, LightPixels>;
  const int rc = allow_smem(kernel, smem);
  if (rc != 0) return rc;
  const LightPixels px{WinnerPixels{static_cast<const int*>(winner),
                                    static_cast<const int*>(sprite_id),
                                    static_cast<const int*>(atlas_depth),
                                    static_cast<const int*>(atlas_color),
                                    static_cast<const float*>(atlas_normal),
                                    static_cast<const unsigned char*>(palette),
                                    static_cast<const int*>(lights),
                                    sprite_w,
                                    sprite_h,
                                    bg_r,
                                    bg_g,
                                    bg_b,
                                    ambient},
                       n_lights, static_cast<float*>(sums)};
  const dim3 grid(hash_w * hash_h, n_frames, g.bands);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), px, nullptr,
      static_cast<unsigned char*>(rgb), static_cast<int*>(stats),
      static_cast<unsigned long long*>(work), g, par::kNoStepCap, chunk);
  return static_cast<int>(cudaGetLastError());
}

// The directional mode.  lit (F, H, W) uint8 (0/1); y, z, start_ent
// (F, H, W) int32 (the G-buffer's surface point and entity); inv (F, 3)
// float32 the reciprocal direction and offsets (F, 3) int32 the far-light
// offsets K of each frame (ops/shadow_dir.direction_constants); stats as
// for par_shadow_lit and work (7,) int64 (MarchWork), added to; max_steps
// >= 0 the step cap; fields (10,) int32 on the host, each key field's lo
// then its bits (ops/shadow_dir.key_fields); the rest as for
// par_shadow_lit.  Returns cudaGetLastError().
extern "C" int par_shadow_dir_lit(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* y, const void* z,
    const void* start_ent, const void* inv, const void* offsets, void* lit,
    void* stats, void* work, int n_frames, int view_w, int view_h,
    int bin_size, int bin_cap, int hash_w, int hash_h, int hash_l,
    int max_steps, const void* fields, int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = dir_smem(g, false);
  const int rc = allow_smem(shadow_dir_kernel<SurfacePixels>, smem);
  if (rc != 0) return rc;
  const SurfacePixels px{static_cast<const int*>(y),
                         static_cast<const int*>(z),
                         static_cast<const int*>(start_ent)};
  const dim3 grid(hash_w * hash_h, n_frames);
  shadow_dir_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), px, static_cast<const float*>(inv),
      static_cast<const int*>(offsets), static_cast<unsigned char*>(lit),
      static_cast<int*>(stats), static_cast<unsigned long long*>(work), g,
      max_steps, key_fields(fields, bin_size));
  return static_cast<int>(cudaGetLastError());
}

// The winner-input directional mode: rgb (F, H, W, 3) uint8, the frames.
// winner, sprite_id, atlas_*, palette as for par_shadow_shade; tl, inv
// (F, 3) float32 and offsets (F, 3) int32 of each frame
// (ops/shadow_dir.direction_constants); palette_luma (P,) float32 the
// palette's ops/dither.luminance and bg_luma the background colour's (read
// with dithered != 0 only, which dithers with ops/dither.bayer_matrix(4));
// stats, work, max_steps, fields and the rest as for par_shadow_dir_lit,
// and the launch adds its pixels marched (not settled) to
// work[kWorkDirMarched].  Returns cudaGetLastError().
extern "C" int par_shadow_dir_shade(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* winner,
    const void* sprite_id, const void* atlas_depth, const void* atlas_color,
    const void* atlas_normal, const void* palette, const void* palette_luma,
    const void* tl, const void* inv, const void* offsets, void* rgb,
    void* stats, void* work, int n_frames, int view_w, int view_h,
    int bin_size, int bin_cap, int hash_w, int hash_h, int hash_l,
    int max_steps, int sprite_w, int sprite_h, int bg_r, int bg_g, int bg_b,
    int n_palette, int dithered, float ambient, float bg_luma,
    const void* fields, int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = dir_smem(g, true);
  const int rc = allow_smem(shadow_dir_kernel<DirFrames>, smem);
  if (rc != 0) return rc;
  const DirFrames px{WinnerPixels{static_cast<const int*>(winner),
                                  static_cast<const int*>(sprite_id),
                                  static_cast<const int*>(atlas_depth),
                                  static_cast<const int*>(atlas_color),
                                  static_cast<const float*>(atlas_normal),
                                  static_cast<const unsigned char*>(palette),
                                  nullptr,
                                  sprite_w,
                                  sprite_h,
                                  bg_r,
                                  bg_g,
                                  bg_b,
                                  ambient},
                     static_cast<const float*>(tl),
                     static_cast<const float*>(palette_luma),
                     n_palette,
                     bg_luma,
                     dithered != 0};
  const dim3 grid(hash_w * hash_h, n_frames);
  shadow_dir_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), px, static_cast<const float*>(inv),
      static_cast<const int*>(offsets), static_cast<unsigned char*>(rgb),
      static_cast<int*>(stats), static_cast<unsigned long long*>(work), g,
      max_steps, key_fields(fields, bin_size));
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes of one block, the blocks one SM holds at `threads` threads,
// registers a thread and local (stack and spill) bytes a thread, into
// out[0..3], of the G-buffer point mode with chunks of `chunk` list
// entries.  Returns the CUDA error code.
extern "C" int par_shadow_occupancy(int view_w, int view_h, int bin_size,
                                    int bin_cap, int hash_w, int hash_h,
                                    int hash_l, int threads, int chunk,
                                    int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(shadow_shade_kernel<false, PixelRays>,
                   shade_smem(g, chunk), threads, out);
}

// The same for the winner-input point mode: the kernel that counts its
// work where `count` is not 0, else the one that does not.
extern "C" int par_shadow_shade_occupancy(int view_w, int view_h,
                                          int bin_size, int bin_cap,
                                          int hash_w, int hash_h, int hash_l,
                                          int threads, int chunk, int count,
                                          int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(count != 0 ? shadow_shade_kernel<true, WinnerPixels>
                              : shadow_shade_kernel<false, WinnerPixels>,
                   shade_smem(g, chunk), threads, out);
}

// The same for the multi-light mode.
extern "C" int par_shadow_lights_occupancy(int view_w, int view_h,
                                           int bin_size, int bin_cap,
                                           int hash_w, int hash_h,
                                           int hash_l, int threads,
                                           int chunk, int count, int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(count != 0 ? shadow_shade_kernel<true, LightPixels>
                              : shadow_shade_kernel<false, LightPixels>,
                   shade_smem(g, chunk), threads, out);
}

// The same for the directional mode.
extern "C" int par_shadow_dir_occupancy(int view_w, int view_h, int bin_size,
                                        int bin_cap, int hash_w, int hash_h,
                                        int hash_l, int threads, int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(shadow_dir_kernel<SurfacePixels>, dir_smem(g, false),
                   threads, out);
}

// The same for the winner-input directional mode.
extern "C" int par_shadow_dir_shade_occupancy(int view_w, int view_h,
                                              int bin_size, int bin_cap,
                                              int hash_w, int hash_h,
                                              int hash_l, int threads,
                                              int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(shadow_dir_kernel<DirFrames>, dir_smem(g, true), threads,
                   out);
}

#ifdef PAR_SHADE_PHASES
// Copies this file's g_shade_phase (kShadePhases cycle sums, then the
// blocks) to `out` and clears it.  Returns cudaGetLastError().
extern "C" int par_shade_phases(void* out) {
  unsigned long long zero[par::kShadePhases + 1] = {};
  cudaMemcpyFromSymbol(out, par::g_shade_phase, sizeof zero);
  cudaMemcpyToSymbol(par::g_shade_phase, zero, sizeof zero);
  return static_cast<int>(cudaGetLastError());
}
#endif
