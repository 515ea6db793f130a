// Shared definitions of the port's CUDA kernels.
//
// Build flags (runtime/kernels.py): -fmad=false so no multiply-add contracts
// into an FMA, and nvcc's defaults -prec-div=true -ftz=false so `/` is the
// IEEE correctly-rounded quotient and subnormals survive, as in the C++
// reference and in the plain PyTorch versions the kernels are checked
// against.
//
// The bodies live here as __device__ functions: the bin-column walk of
// primary visibility, which draws a column's candidates in walk order into
// per-pixel state in shared memory (trace.cu), the slab test, the 7-phase
// DDA and the tile march over per-start-bin visit lists of a point light's
// shadow rays (shadow.cu's point mode), and both in sequence (fused.cu).
// shadow.cu's directional mode marches on the same slab test and DDA
// rounds.  The kernels call the same code, so they agree by construction.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace par {

// std::min(a, b) == (b < a ? b : a): keeps `a` when the pair is unordered
// (NaN), unlike fminf.  Same for std::max.
__device__ __forceinline__ float c_min(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float c_max(float a, float b) { return a < b ? b : a; }

constexpr unsigned kFullWarp = 0xFFFFFFFFu;

// The walk covers a bin-column tile in row bands: a band is the most rows
// whose pixels fit kBandPixels (at least one row), so its per-pixel state
// takes at most 12 * kBandPixels bytes of shared memory whatever the bin
// size.  A 40-pixel bin is one band; an 80-pixel bin 4 bands of 20 rows, a
// 160-pixel bin 16 of 10.  A pixel's walk reads only its own state, so
// bands split it exactly.
constexpr int kBandPixels = 1600;

// The spatial hash and view geometry of RenderConfig, built on the host
// from its first seven fields; the band geometry follows from them there,
// so no block divides for it.
struct Grid {
  int view_w, view_h;
  int bin_size, bin_cap;
  int hash_w, hash_h, hash_l;
  int band_rows = kBandPixels / bin_size < 1 ? 1
                  : kBandPixels / bin_size > bin_size ? bin_size
                  : kBandPixels / bin_size;
  int bands = (bin_size + band_rows - 1) / band_rows;  // bands a tile
  // The launch's window: tiles of bin rows row_bin0 .. row_bin0 +
  // bin_rows - 1, whose per-pixel arrays hold pixel rows row0 ..
  // row0 + rows - 1 of the view (set by window(); all of them by default).
  int row_bin0 = 0, bin_rows = hash_h;
  int row0 = 0, rows = view_h;

  // This grid with the window of bin rows first_bin_row .. + n_bin_rows - 1.
  __host__ Grid window(int first_bin_row, int n_bin_rows) const {
    Grid w = *this;
    w.row_bin0 = first_bin_row;
    w.bin_rows = n_bin_rows;
    w.row0 = first_bin_row * bin_size;
    const int end = (first_bin_row + n_bin_rows) * bin_size;
    w.rows = (end < view_h ? end : view_h) - w.row0;
    return w;
  }
  // Index of pixel (i, j) of frame f in the window's (F, rows, view_w)
  // per-pixel arrays; j is the view's row.
  __host__ __device__ size_t pixel(int f, int i, int j) const {
    return (static_cast<size_t>(f) * rows + (j - row0)) * view_w + i;
  }
  __host__ __device__ int volume() const { return hash_w * hash_h * hash_l; }
  // Pixels of the largest band: what a block's per-pixel buffers hold.
  __host__ __device__ int band_pixels() const { return band_rows * bin_size; }
  __host__ __device__ int flat(int x, int y, int z) const {
    return (x * hash_h + y) * hash_l + z;
  }
};

// Position of entity `e` in frame `f`: entity 0 (the player, the only
// dynamic entity of the batched path) takes its per-frame position.
__device__ __forceinline__ const int* entity_pos(const int* pos,
                                                const int* players, int f,
                                                int e) {
  return e == 0 ? players + 3 * f : pos + 3 * static_cast<size_t>(e);
}

// ---------------------------------------------------------------------------
// Primary visibility (kernels 1 and 3; ops/trace.py::trace_winner).
// ---------------------------------------------------------------------------

// A thread's pixels q = threadIdx.x, + blockDim.x, ... of a bs x bs tile,
// with their column q % bs and row q / bs stepped without a division.
struct TilePixel {
  int q, col, row;
  int dcol, drow, bs;
  __device__ explicit TilePixel(int tile_bs)
      : q(threadIdx.x), col(threadIdx.x % tile_bs), row(threadIdx.x / tile_bs),
        dcol(blockDim.x % tile_bs), drow(blockDim.x / tile_bs), bs(tile_bs) {}
  __device__ void next() {
    q += blockDim.x;
    col += dcol;
    row += drow;
    if (col >= bs) {
      col -= bs;
      ++row;
    }
  }
};

// One block's pixels: rows row0 .. row0 + rows - 1 of tile (bin_x, bin_y),
// all bs columns; pixel q = (row - row0) * bs + col.
struct Band {
  int bin_x, bin_y, row0, rows;

  // This block's band in a grid of (hash_w * g.bin_rows, frames, g.bands)
  // blocks: blockIdx.x the bin column of the window, blockIdx.z the band.
  __device__ static Band of_block(const Grid& g) {
    const int row0 = blockIdx.z * g.band_rows;
    return Band{static_cast<int>(blockIdx.x) / g.bin_rows,
                g.row_bin0 + static_cast<int>(blockIdx.x) % g.bin_rows, row0,
                min(g.band_rows, g.bin_size - row0)};
  }
  // The whole tile of bin column `column` of the window as one band.
  __device__ static Band tile(const Grid& g, int column) {
    return Band{column / g.bin_rows, g.row_bin0 + column % g.bin_rows, 0,
                g.bin_size};
  }
  __device__ int i0(const Grid& g) const { return bin_x * g.bin_size; }
  __device__ int j0(const Grid& g) const {
    return bin_y * g.bin_size + row0;
  }
  __device__ int pixels(const Grid& g) const { return rows * g.bin_size; }
};

constexpr int kFields = 8;  // entity, px, py, pz, ex, ey, ez, sprite id
// A draw-list entry: four int4 of one live slot and its footprint in the
// band (DrawEntry).
constexpr int kDrawFields = 16;

// Shared ints a bin column's staged candidates take: the bins' counts and
// each slot's fields.
__host__ __device__ inline int column_ints(const Grid& g) {
  return g.hash_l + g.hash_l * g.bin_cap * kFields;
}

// Shared ints of a column's draw list: its length (padded to an int4),
// then one entry a slot.  The list's base is 16-byte aligned.
__host__ __device__ inline int draw_ints(const Grid& g) {
  return 4 + g.hash_l * g.bin_cap * kDrawFields;
}

// A draw-list entry, as draw_slots reads it: the slot's footprint in the
// band is `w` tile columns from x0 by area / w band rows from r0, and
// pixel (r, c) of it is band pixel q0 + r * bs + c, at depth-key row
// row0 + r and texel column col0 + c.
struct __align__(16) DrawEntry {
  int slot, bz, last_empty, x0;  // last_empty: the last empty bin before
                                 // bz, -1 if none
  int w, r0, area, inv_w;        // inv_w: 1 / w as float bits
  int key0, row0, ey, col0;      // key0 = py - pz; row0 = top - world_j of
                                 // row r0; col0 = i - px of column x0
  int tex0, q0, pad0, pad1;      // tex0 = sprite id * sprite_h
};

// The shared memory walk_column works in.
struct WalkSmem {
  int* cnt;    // (hash_l,) the bins' counts
  int* fld;    // (hash_l * cap, kFields) each live slot's fields
  int* draw;   // (draw_ints,) the draw list
  int* best;   // (band pixels,) each pixel's best depth key, INT_MIN for
               // none
  int* slot;   // (band pixels,) the slot that set it, -1 for none
  int* hits;   // (band pixels,) (adjacent-hit count << 16) | (the last bin
               // with an improving candidate + 1)
};

// Stage bin column `column` (bin_x * hash_h + bin_y) of frame f, with all
// threads of the block: s_cnt (hash_l) the bins' counts, s_fld (hash_l * cap,
// kFields) each live slot's candidate fields.  The caller synchronises.
__device__ inline void stage_column(const int* pos, const int* ext,
                                    const int* sprite_id, const int* bins_ent,
                                    const int* counts, const int* players,
                                    int f, int column, const Grid& g,
                                    int* s_cnt, int* s_fld) {
  const int cap = g.bin_cap;
  // Flat index of bin (bin_x, bin_y, 0) in frame f's tables.
  const size_t base = static_cast<size_t>(f) * g.volume()
                      + static_cast<size_t>(column) * g.hash_l;
  for (int s = threadIdx.x; s < g.hash_l * cap; s += blockDim.x) {
    const int bz = s / cap;
    const int k = s % cap;
    const int cnt = counts[base + bz];
    if (k == 0) s_cnt[bz] = cnt;
    int* d = s_fld + s * kFields;
    if (k < cnt) {
      const int e = bins_ent[(base + bz) * cap + k];
      const int* p = entity_pos(pos, players, f, e);
      const int* x = ext + 3 * static_cast<size_t>(e);
      d[0] = e;
      d[1] = p[0];
      d[2] = p[1];
      d[3] = p[2];
      d[4] = x[0];
      d[5] = x[1];
      d[6] = x[2];
      d[7] = sprite_id[e];
    }
  }
}

// The draw list of the staged column for band b: every live slot
// (k < min(count, cap)) in walk order (bz, then k) whose footprint in the
// band is not empty, written by warp 0 (blockDim.x >= 32).  The footprint
// is the reference's interval test (alternative.cpp:310-317) solved for
// the pixel: columns px <= i < px + ex, rows j with
// py + pz < view_h - j <= py + ey + pz + ez, clipped to the band's rows
// and columns and the view.  The caller synchronises.
__device__ inline void list_draws(const WalkSmem& s, const Grid& g,
                                  const Band& b, int sprite_h) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  const int cap = g.bin_cap;
  const int i0 = b.i0(g);
  const int j0 = b.j0(g);
  const int i1 = min(i0 + g.bin_size, g.view_w);
  const int j1 = min(j0 + b.rows, g.view_h);
  auto* list = reinterpret_cast<DrawEntry*>(s.draw + 4);
  int m = 0;
  for (int s0 = 0; s0 < g.hash_l * cap; s0 += 32) {
    const int slot = s0 + lane;
    const int bz = slot / cap;
    const int* d = s.fld + slot * kFields;
    int xa = 0, xb = 0, ja = 0, jb = 0;
    if (slot < g.hash_l * cap && slot % cap < min(s.cnt[bz], cap)) {
      const int px = d[1], py = d[2], pz = d[3];
      const int ex = d[4], ey = d[5], ez = d[6];
      xa = max(px, i0);
      xb = min(px + ex, i1);
      ja = max(g.view_h - (py + ey + pz + ez), j0);
      jb = min(g.view_h - (py + pz), j1);
    }
    const bool live = xa < xb && ja < jb;
    const unsigned lanes = __ballot_sync(kFullWarp, live);
    if (live) {
      int last_empty = -1;
      for (int z = bz - 1; z >= 0 && last_empty < 0; --z)
        if (s.cnt[z] == 0) last_empty = z;
      const int px = d[1], py = d[2], pz = d[3];
      const int ey = d[5], ez = d[6];
      const int w = xb - xa;
      DrawEntry& e = list[m + __popc(lanes & ((1u << lane) - 1u))];
      e.slot = slot;
      e.bz = bz;
      e.last_empty = last_empty;
      e.x0 = xa - i0;
      e.w = w;
      e.r0 = ja - j0;
      e.area = w * (jb - ja);
      e.inv_w = __float_as_int(1.0f / static_cast<float>(w));
      e.key0 = py - pz;
      e.row0 = py + ey + pz + ez - (g.view_h - ja);
      e.ey = ey;
      e.col0 = xa - px;
      e.tex0 = d[7] * sprite_h;
      e.q0 = (ja - j0) * g.bin_size + xa - i0;
    }
    m += __popc(lanes);
  }
  if (lane == 0) s.draw[0] = m;
}

// Clipped texel address into the flattened atlas (alternative.cpp:324-341),
// from tex0 = sprite id * sprite_h.
__device__ __forceinline__ int texel_at(int tex0, int row, int col,
                                        int sprite_w, int sprite_h) {
  return (tex0 + min(max(row, 0), sprite_h - 1)) * sprite_w
         + min(max(col, 0), sprite_w - 1);
}

// Draw the list's entries in order into the per-pixel state, all threads
// of the block striding over each entry's footprint.  Within one entry
// every pixel is touched once; the block synchronises between entries, and
// once more when there is none, so the state is complete on return.  The
// atlas is read through the read-only cache, where it stays (staging it in
// shared memory measured no faster).
__device__ inline void draw_slots(const WalkSmem& s, const Grid& g,
                                  const int* atlas_depth, int sprite_w,
                                  int sprite_h, int early_exit) {
  const int bs = g.bin_size;
  const int n = s.draw[0];
  const auto* list = reinterpret_cast<const DrawEntry*>(s.draw + 4);
  for (int k = 0; k < n; ++k) {
    const DrawEntry e = list[k];
    const float inv_w = __int_as_float(e.inv_w);
    for (int t = threadIdx.x; t < e.area; t += blockDim.x) {
      // t / w: (t + 0.5) / w lies at least 0.5 / w from an integer, which
      // the two float roundings cannot cross for t < 2**22.
      const int r = static_cast<int>((static_cast<float>(t) + 0.5f) * inv_w);
      const int c = t - r * e.w;
      const int q = e.q0 + r * bs + c;
      int h = 0;
      if (early_exit) {
        h = s.hits[q];
        // Two adjacent hits and a last improving bin before bz: the
        // reference has stopped after that bin (quirk Q5).
        if ((h >> 16) >= 2 && (h & 0xFFFF) <= e.bz) continue;
      }
      const int row = e.row0 + r;
      const int depth = e.key0 + min(0, e.ey - row)
                        - __ldg(atlas_depth + texel_at(e.tex0, row,
                                                       e.col0 + c, sprite_w,
                                                       sprite_h));
      if (depth > s.best[q]) {  // strictly greater: ties keep the first
        s.best[q] = depth;
        s.slot[q] = e.slot;
        const int last = (h & 0xFFFF) - 1;
        if (early_exit && last != e.bz) {
          const int count = e.last_empty > last ? 0 : h >> 16;
          s.hits[q] = ((count + 1) << 16) | (e.bz + 1);
        }
      }
    }
    __syncthreads();
  }
  if (n == 0) __syncthreads();
}

// Primary visibility of band b of frame f, into s.best and s.slot of its
// b.rows * bs pixels (q = (row - b.row0) * bs + col); pixels outside the
// view keep INT_MIN and -1.  All threads of the block call it; blockDim.x
// is a multiple of 32.
//
// 1. Stage the column's candidates in shared memory and reset every
//    pixel's state.
// 2. List the live slots whose footprint in the band is not empty, in the
//    reference's walk order, with each slot's rectangle and its bin's last
//    empty bin (list_draws).
// 3. Draw the entries in order (draw_slots): every pixel of an entry's
//    rectangle passes the interval test, so it computes the depth key and
//    keeps it where it is strictly greater than the pixel's best.
//
// Exact, the early exit included.  The reference walks bins 0..hash_l-1,
// resets its adjacent-hit counter on an empty bin, adds one after each bin
// in which the pixel's best improved, and stops once the counter reaches
// 2.  The draw keeps the counter lazily, with the last bin that improved:
// a pixel's counter changes only in a bin with an improving candidate or
// at an empty bin, and an empty bin holds no candidate, so when bin bz next
// improves the pixel the reference's counter is 0 if an empty bin lies
// after the last improving bin (last_empty > last), and the count kept
// otherwise; then it adds one.  The reference stops only after a bin that
// raised the counter to 2, so a pixel whose count is 2 with a last bin
// before bz is one the reference no longer walks in bz.  Candidates that
// miss the pixel, and bins without an improving candidate, change nothing
// the reference keeps.  A band's walk is the tile's walk of its pixels:
// each pixel reads and writes only its own state, and the draw list's
// last empty bins are the column's.
__device__ inline void walk_column(const int* pos, const int* ext,
                                   const int* sprite_id,
                                   const int* atlas_depth,
                                   const int* bins_ent, const int* counts,
                                   const int* players, int f, const Band& b,
                                   const Grid& g, int sprite_w, int sprite_h,
                                   int early_exit, const WalkSmem& s) {
  const int n_pix = b.pixels(g);
  stage_column(pos, ext, sprite_id, bins_ent, counts, players, f,
               b.bin_x * g.hash_h + b.bin_y, g, s.cnt, s.fld);
  for (int q = threadIdx.x; q < n_pix; q += blockDim.x) {
    s.best[q] = INT_MIN;
    s.slot[q] = -1;
    s.hits[q] = 0;
  }
  __syncthreads();
  list_draws(s, g, b, sprite_h);
  __syncthreads();
  draw_slots(s, g, atlas_depth, sprite_w, sprite_h, early_exit);
}

// ---------------------------------------------------------------------------
// Shadow occlusion (kernel 2; ops/shadow.py::trace_light_dynamic).
// ---------------------------------------------------------------------------

// The step cap of a march without one: 7 * min(int(largest), kNoStepCap)
// phases are the reference's 7 * int(largest).
constexpr int kNoStepCap = INT_MAX;

// A shadow ray: start bin, float origin, reciprocal direction, own entity.
struct Ray {
  int rbx, rby, rbz;
  float ox, oy, oz;
  float ivx, ivy, ivz;
  int self;
};

// Slab test of the box with float corners lo, hi, in the reference's
// std::min/std::max order (alternative.cpp:40-83).  The corners are the
// reference's conversions float(p) and float(p + x) of the int box.
__device__ __forceinline__ bool slab_hit(float lo_x, float lo_y, float lo_z,
                                         float hi_x, float hi_y, float hi_z,
                                         const Ray& r) {
  const float x1 = (lo_x - r.ox) * r.ivx;
  const float x2 = (hi_x - r.ox) * r.ivx;
  float lo = c_min(x1, x2);
  float hi = c_max(x1, x2);
  const float y1 = (lo_y - r.oy) * r.ivy;
  const float y2 = (hi_y - r.oy) * r.ivy;
  lo = c_max(lo, c_min(y1, y2));
  hi = c_min(hi, c_max(y1, y2));
  const float z1 = (lo_z - r.oz) * r.ivz;
  const float z2 = (hi_z - r.oz) * r.ivz;
  lo = c_max(lo, c_min(z1, z2));
  hi = c_min(hi, c_max(z1, z2));
  return hi >= lo;
}

// Walk the reference's 7-phase thick DDA (x, y, z, xy, xz, yz, advance)
// from start bin (sbx, sby, sbz) toward light bin (lbx, lby, lbz) for
// 7 * min(int(largest), max_steps) phases (alternative.cpp:399-500; the cap
// is shade_directional's), calling visit(flat) for every probe that lands
// on an in-range flat bin other than the start bin's flat (aliased flats
// are compared and used as they are).  Stops and returns true as soon as
// visit returns true.
template <class Visit>
__device__ inline bool dda_walk(int sbx, int sby, int sbz, int lbx, int lby,
                                int lbz, const Grid& g, int max_steps,
                                Visit visit) {
  const int V = g.volume();
  const float sx = static_cast<float>(sbx);
  const float sy = static_cast<float>(sby);
  const float sz = static_cast<float>(sbz);
  const float dx = static_cast<float>(lbx) - sx;
  const float dy = static_cast<float>(lby) - sy;
  const float dz = static_cast<float>(lbz) - sz;
  const float largest = c_max(c_max(fabsf(dx), fabsf(dy)), fabsf(dz));
  const float stx = dx / largest;
  const float sty = dy / largest;
  const float stz = dz / largest;
  const int n_phases = 7 * min(static_cast<int>(largest), max_steps);
  const int start_flat = g.flat(sbx, sby, sbz);

  float tx = sx, ty = sy, tz = sz;
  for (int t = 0; t < n_phases; ++t) {
    const int phase = t % 7;
    const bool ax = phase == 0 || phase == 3 || phase == 4 || phase == 6;
    const bool ay = phase == 1 || phase == 3 || phase == 5 || phase == 6;
    const bool az = phase == 2 || phase == 4 || phase == 5 || phase == 6;
    const float cx = tx + (ax ? stx : 0.0f);
    const float cy = ty + (ay ? sty : 0.0f);
    const float cz = tz + (az ? stz : 0.0f);
    if (phase == 6) {
      tx = cx;
      ty = cy;
      tz = cz;
    }
    const int flat = g.flat(static_cast<int>(cx), static_cast<int>(cy),
                            static_cast<int>(cz));
    if (flat < 0 || flat >= V || flat == start_flat) continue;
    if (visit(flat)) return true;
  }
  return false;
}

// March ray `r` toward light bin l under step cap max_steps: every probed
// bin tests its first `count` slots of frame f's table (bins_ent, counts in
// global memory), skipping the ray's own entity.  Returns true at the first
// occluder.  The per-pixel march of the reference, kept for the pixels
// whose key does not fit their tile's table (march_tile).  With kCount,
// each slab test adds 1 to *tests; without, tests is not read.
template <bool kCount = false>
__device__ inline bool march_occluded(const int* pos, const int* ext,
                                      const int* players,
                                      const int* bins_ent, const int* counts,
                                      int f, const Grid& g, const Ray& r,
                                      int3 l, int max_steps,
                                      unsigned* tests = nullptr) {
  const int cap = g.bin_cap;
  const size_t base = static_cast<size_t>(f) * g.volume();
  return dda_walk(r.rbx, r.rby, r.rbz, l.x, l.y, l.z, g, max_steps,
                  [&](int flat) {
    const int n = min(counts[base + flat], cap);
    for (int k = 0; k < n; ++k) {
      const int e = bins_ent[(base + flat) * cap + k];
      if (e == r.self) continue;
      if constexpr (kCount) ++*tests;
      const int es = e >= 0 ? e : 0;
      const int* p = entity_pos(pos, players, f, es);
      const int* x = ext + 3 * static_cast<size_t>(es);
      if (slab_hit(static_cast<float>(p[0]), static_cast<float>(p[1]),
                   static_cast<float>(p[2]), static_cast<float>(p[0] + x[0]),
                   static_cast<float>(p[1] + x[1]),
                   static_cast<float>(p[2] + x[2]), r))
        return true;
    }
    return false;
  });
}

// ---------------------------------------------------------------------------
// The march of one tile's pixels over per-key visit lists (kernels 2 and 3).
// ---------------------------------------------------------------------------

constexpr int kChunkBins = 64;   // list entries staged in shared memory
// Threads of a march block at most, and the blocks an SM should hold: 4
// blocks of 320 threads leave 51 registers a thread (48 used), which
// measured faster than 3 blocks at 64 registers.
constexpr int kMarchThreads = 320;
constexpr int kMarchBlocksPerSM = 4;
constexpr int kMarchWarps = kMarchThreads / 32;
constexpr unsigned char kDirect = 0xFE;  // pixel marched by march_occluded
constexpr unsigned char kNoPixel = 0xFF;  // outside the view

// A tile's table of march keys: up to kKeys distinct keys of kKeyInts ints.
// A ray's probed bins depend only on its start bin, its light bin and the
// step cap, so under a point light (one light bin a frame) the key is the
// start bin.
template <int kKeys_, int kKeyInts_>
struct MarchTable {
  static constexpr int kKeys = kKeys_;
  static constexpr int kKeyInts = kKeyInts_;
  struct Key {
    int v[kKeyInts_];
  };
};
// Point lights: graybox tiles hold at most 2 start bins.
using PointTable = MarchTable<4, 3>;

// Counters of the list path, one (3,) int32 array per launch's caller:
// pixels marched directly, the most keys one tile held (kKeys + 1 where
// some did not fit), the longest visit list.
enum MarchStat { kStatDirect = 0, kStatStarts = 1, kStatList = 2 };

// The probes of dda_walk from start bin (sbx, sby, sbz) toward light bin
// (lbx, lby, lbz) under step cap max_steps, four steps a round: all 32
// lanes of a warp call it, and it calls round(flat) once a round in every
// lane, with the lane's probe (an in-range flat bin other than the start
// bin's) or a negative value unique to the lane.
//
// The walk's only serial dependence is the anchor, which advances by one
// float add of the step per 7 phases.  Each round covers 4 steps: lane
// 7 * d + p (d < 4, p < 7; lanes 28-31 idle) takes phase p of step
// k0 + d from the anchor reached by the same sequence of adds as dda_walk,
// so it probes the same bin, and lane order within a round is visiting
// order.
template <class Round>
__device__ inline void dda_rounds(int sbx, int sby, int sbz, int lbx,
                                  int lby, int lbz, const Grid& g,
                                  int max_steps, Round round) {
  const int V = g.volume();
  const int lane = threadIdx.x & 31;
  const float sx = static_cast<float>(sbx);
  const float sy = static_cast<float>(sby);
  const float sz = static_cast<float>(sbz);
  const float dx = static_cast<float>(lbx) - sx;
  const float dy = static_cast<float>(lby) - sy;
  const float dz = static_cast<float>(lbz) - sz;
  const float largest = c_max(c_max(fabsf(dx), fabsf(dy)), fabsf(dz));
  const float stx = dx / largest;
  const float sty = dy / largest;
  const float stz = dz / largest;
  // 7 * n_steps phases.
  const int n_steps = min(static_cast<int>(largest), max_steps);
  const int start_flat = g.flat(sbx, sby, sbz);
  const int d = lane / 7;
  const int phase = lane % 7;
  const bool ax = phase == 0 || phase == 3 || phase == 4 || phase == 6;
  const bool ay = phase == 1 || phase == 3 || phase == 5 || phase == 6;
  const bool az = phase == 2 || phase == 4 || phase == 5 || phase == 6;

  float bx = sx, by = sy, bz = sz;  // the anchor of step k0
  for (int k0 = 0; k0 < n_steps; k0 += 4) {
    float tx = bx, ty = by, tz = bz;
    for (int a = 0; a < d && a < 4; ++a) {
      tx = tx + stx;
      ty = ty + sty;
      tz = tz + stz;
    }
    int flat = -1 - lane;  // never a bin, and unique to the lane
    if (d < 4 && k0 + d < n_steps) {
      const int v = g.flat(static_cast<int>(tx + (ax ? stx : 0.0f)),
                           static_cast<int>(ty + (ay ? sty : 0.0f)),
                           static_cast<int>(tz + (az ? stz : 0.0f)));
      if (v >= 0 && v < V && v != start_flat) flat = v;
    }
    round(flat);
    for (int a = 0; a < 4; ++a) {
      bx = bx + stx;
      by = by + sty;
      bz = bz + stz;
    }
    __syncwarp();
  }
}

// The distinct flat bins that dda_walk visits from start bin
// (sbx, sby, sbz) toward light bin (lbx, lby, lbz) under step cap
// max_steps, appended to `list` in first-visit order, with bit v of `seen`
// (cleared by the caller) marking bin v.  Returns the list's length.  All
// 32 lanes of a warp call it.  In each round of dda_rounds the lowest lane
// of equal bins that is not yet in `seen` appends it, in lane order.
__device__ inline int dda_visit_list(int sbx, int sby, int sbz, int lbx,
                                     int lby, int lbz, const Grid& g,
                                     int max_steps, unsigned* seen,
                                     int* list) {
  const int lane = threadIdx.x & 31;
  int m = 0;
  dda_rounds(sbx, sby, sbz, lbx, lby, lbz, g, max_steps, [&](int flat) {
    const unsigned same = __match_any_sync(kFullWarp, flat);
    const bool fresh = flat >= 0 && __ffs(same) - 1 == lane
                       && (seen[flat >> 5] & (1u << (flat & 31))) == 0u;
    const unsigned fresh_lanes = __ballot_sync(kFullWarp, fresh);
    if (fresh) {
      atomicOr(seen + (flat >> 5), 1u << (flat & 31));
      list[m + __popc(fresh_lanes & ((1u << lane) - 1u))] = flat;
    }
    m += __popc(fresh_lanes);
  });
  return m;
}

// A candidate box as the march stages it: float corners lo xyz with the
// raw entity id (as int bits), then corners hi xyz.
struct Box {
  float4 lo, hi;
};

// The candidate box of raw entity id `id` (a slot of frame f's table):
// entity 0 sits at players[f], and an id < 0 reads entity 0's box.
__device__ __forceinline__ Box candidate_box(const int* pos, const int* ext,
                                             const int* players, int id,
                                             int f) {
  const int es = id >= 0 ? id : 0;
  const int* p = entity_pos(pos, players, f, es);
  const int* x = ext + 3 * static_cast<size_t>(es);
  return Box{make_float4(static_cast<float>(p[0]), static_cast<float>(p[1]),
                         static_cast<float>(p[2]), __int_as_float(id)),
             make_float4(static_cast<float>(p[0] + x[0]),
                         static_cast<float>(p[1] + x[1]),
                         static_cast<float>(p[2] + x[2]), 0.0f)};
}

// The shared memory march_tile works in; the base must be 16-byte aligned.
template <class Table>
struct MarchSmem {
  static constexpr int kKeys = Table::kKeys;
  static constexpr int kKeyInts = Table::kKeyInts;

  float4* cand;      // (kChunkBins * cap, 2) corners lo xyz + raw entity id
                     // (as int bits), corners hi xyz
  int* cand_n;       // (kChunkBins,) live slots of each staged list entry
  int* key;          // (kKeys, kKeyInts) the tile's distinct keys
  int* len;          // (kKeys,) visit list lengths
  int* table;        // [0] keys in `key`, [1] 1 if one did not fit
  int* warp_key;     // (kMarchWarps, kKeys, kKeyInts) each warp's keys
  int* warp_n;       // (kMarchWarps,) keys in warp_key
  int* warp_slot;    // (kMarchWarps, kKeys) their index in `key`, or kDirect
  unsigned* seen;    // (kKeys, words) bins already in each list
  int* list;         // (kKeys, list_cap) distinct flats in first-visit order
  unsigned char* slot;  // (n_pix,) index in the warp's warp_key, kDirect
                        // or kNoPixel
  unsigned char* occ;   // (n_pix,) occluded by a list entry so far
  int list_cap;

  __host__ __device__ static int words(const Grid& g) {
    return (g.volume() + 31) / 32;
  }
  // The entries a visit list can hold: its distinct bins, at most the
  // grid's volume, and at most 7 a step under a step cap.
  __host__ __device__ static int list_capacity(const Grid& g, int max_steps) {
    return max_steps <= g.volume() / 7 ? 7 * max_steps : g.volume();
  }
  // Shared ints the layout takes for n_pix pixels.
  __host__ __device__ static int ints(const Grid& g, int n_pix,
                                      int max_steps) {
    return 8 * kChunkBins * g.bin_cap + kChunkBins + kKeys * kKeyInts
           + kKeys + 2 + kMarchWarps * (kKeys * kKeyInts + 1 + kKeys)
           + kKeys * words(g) + kKeys * list_capacity(g, max_steps)
           + (2 * n_pix + 3) / 4;
  }
  __device__ MarchSmem(int* p, const Grid& g, int n_pix, int max_steps) {
    list_cap = list_capacity(g, max_steps);
    cand = reinterpret_cast<float4*>(p);
    cand_n = p + 8 * kChunkBins * g.bin_cap;
    key = cand_n + kChunkBins;
    len = key + kKeys * kKeyInts;
    table = len + kKeys;
    warp_key = table + 2;
    warp_n = warp_key + kMarchWarps * kKeys * kKeyInts;
    warp_slot = warp_n + kMarchWarps;
    seen = reinterpret_cast<unsigned*>(warp_slot + kMarchWarps * kKeys);
    list = reinterpret_cast<int*>(seen + kKeys * words(g));
    slot = reinterpret_cast<unsigned char*>(list + kKeys * list_cap);
    occ = slot + n_pix;
  }
};

// Whether the key of kKeyInts ints at `a` equals k.
template <class Table>
__device__ __forceinline__ bool same_key(const int* a,
                                         const typename Table::Key& k) {
  bool same = true;
#pragma unroll
  for (int c = 0; c < Table::kKeyInts; ++c) same = same && a[c] == k.v[c];
  return same;
}

// The index of key k among the first n entries of keys (kKeys, kKeyInts),
// or -1.
template <class Table>
__device__ __forceinline__ int find_key(const int* keys, int n,
                                        const typename Table::Key& k) {
  for (int i = 0; i < n; ++i)
    if (same_key<Table>(keys + Table::kKeyInts * i, k)) return i;
  return -1;
}

// off[k] for a k known only at run time, off[] kept in registers.
template <int kKeys>
__device__ __forceinline__ int pick(const int (&off)[kKeys + 1], int k) {
  int r = 0;
#pragma unroll
  for (int a = 0; a <= kKeys; ++a) r = a == k ? off[a] : r;
  return r;
}

// march_tile's store of a lit mask: lit (F, g.rows, W) uint8, 1 where the
// light is reachable, at g.pixel().
struct LitStore {
  unsigned char* lit;
  const Grid& g;
  int f;
  __device__ void operator()(int, int i, int j, bool is_lit) const {
    lit[g.pixel(f, i, j)] = is_lit ? 1 : 0;
  }
};

// The lit bit of every pixel in the view of band b of frame f (a whole
// tile or some of its rows), handed to store(q, i, j, lit) once a pixel.
// The band's pixels are q = 0..b.rows*bs-1 at column i = b.i0(g) + q % bs
// and row j = b.j0(g) + q / bs; key_of(q, i, j) gives pixel q's key
// (Table::Key) and ray_of(q, i, j) its Ray.  LitStore writes the lit mask;
// shadow.cu's winner-input mode shades the pixel there instead.
// frame_light is the frame's light bin and max_steps the step cap
// (kNoStepCap for none).  All threads of the block call it; blockDim.x is
// a multiple of 32 and at most kMarchThreads.
//
// 1. Collect the tile's distinct keys, up to Table::kKeys: each warp lists
//    the distinct keys of its pixels (up to kKeys; a key missing from the
//    list is added by the lowest lane that has it), then one thread merges
//    the warps' lists into the tile's table.  Pixels whose key did not fit
//    take the direct march.
// 2. One warp per key walks the DDA once (dda_visit_list, the same float
//    stepping and cap as the per-pixel march) and lists the distinct flats
//    in first-visit order.
// 3. The lists are read as one sequence, kChunkBins entries at a time: all
//    threads stage each entry's first min(count, cap) slots (raw entity id
//    and float corners, entity 0 at players[f]), then every pixel not yet
//    occluded tests the staged entries of its own list in order, skipping
//    its own entity and stopping at its first hit.
// 4. Leftover pixels march on their own (march_occluded, tables in global
//    memory), and every pixel's lit bit is stored.
//
// Exact: a ray's probed bins depend only on (start bin, light bin, step
// cap), which its key and the launch fix, and its occlusion is an OR over
// them of a test of the ray and a box, which ignores order and repeats.
// So any set of pixels marches exactly, a band as well as a tile; the
// counters' "tile" is the band.
template <class Table, class KeyFn, class RayFn, class StoreFn>
__device__ void march_tile(const int* pos, const int* ext, const int* players,
                           const int* bins_ent, const int* counts, int f,
                           const Grid& g, const Band& b, int3 frame_light,
                           int max_steps, const MarchSmem<Table>& s,
                           KeyFn key_of, RayFn ray_of, StoreFn store,
                           int* stats) {
  constexpr int kKeys = Table::kKeys;
  constexpr int kKeyInts = Table::kKeyInts;
  using Key = typename Table::Key;
  const int bs = g.bin_size;
  const int n_pix = b.pixels(g);
  const int cap = g.bin_cap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int i0 = b.i0(g);
  const int j0 = b.j0(g);

  // 1. Distinct keys.
  const int lane = tid & 31;
  const int warp = tid / 32;
  int* wkey = s.warp_key + warp * kKeys * kKeyInts;
  int wn = 0;  // entries of wkey, the same in every lane
  for (TilePixel p(bs); p.q - lane < n_pix; p.next()) {
    const int q = p.q;
    const bool live = q < n_pix && i0 + p.col < g.view_w
                      && j0 + p.row < g.view_h;
    Key k{};
    if (live) k = key_of(q, i0 + p.col, j0 + p.row);
    int slot = live ? find_key<Table>(wkey, wn, k) : kNoPixel;
    unsigned missing = __ballot_sync(kFullWarp, slot < 0);
    while (missing != 0u) {
      const int leader = __ffs(missing) - 1;
      Key lk;
#pragma unroll
      for (int c = 0; c < kKeyInts; ++c)
        lk.v[c] = __shfl_sync(kFullWarp, k.v[c], leader);
      const int added = wn < kKeys ? wn : kDirect;
      if (lane == leader && wn < kKeys) {
#pragma unroll
        for (int c = 0; c < kKeyInts; ++c) wkey[kKeyInts * wn + c] = lk.v[c];
      }
      wn += wn < kKeys ? 1 : 0;
      if (slot < 0 && same_key<Table>(lk.v, k)) slot = added;
      missing = __ballot_sync(kFullWarp, slot < 0);
      __syncwarp();
    }
    if (q < n_pix) {
      s.slot[q] = static_cast<unsigned char>(slot);
      s.occ[q] = 0;
    }
  }
  if (lane == 0) s.warp_n[warp] = wn;
  __syncthreads();
  if (tid == 0) {
    int n_keys = 0;
    int full = 0;
    for (int w = 0; w < nt / 32; ++w) {
      for (int e = 0; e < s.warp_n[w]; ++e) {
        const int* wk = s.warp_key + (w * kKeys + e) * kKeyInts;
        Key k;
#pragma unroll
        for (int c = 0; c < kKeyInts; ++c) k.v[c] = wk[c];
        int i = find_key<Table>(s.key, n_keys, k);
        if (i < 0 && n_keys < kKeys) {
#pragma unroll
          for (int c = 0; c < kKeyInts; ++c)
            s.key[kKeyInts * n_keys + c] = k.v[c];
          i = n_keys++;
        }
        full |= i < 0 ? 1 : 0;
        s.warp_slot[w * kKeys + e] = i >= 0 ? i : kDirect;
      }
    }
    s.table[0] = n_keys;
    s.table[1] = full;
  }
  __syncthreads();
  const int n = s.table[0];
  const bool overflow = s.table[1] != 0;
  // Pixel q's index in the tile's table, kDirect or kNoPixel.
  auto start_of = [&](int q) {
    const int e = s.slot[q];
    return e < kKeys ? s.warp_slot[warp * kKeys + e] : e;
  };

  // 2. One visit list per key, a warp each.
  const int words = MarchSmem<Table>::words(g);
  for (int w = tid; w < n * words; w += nt) s.seen[w] = 0u;
  __syncthreads();
  for (int k = tid / 32; k < n; k += nt / 32) {
    const int* kp = s.key + kKeyInts * k;
    const int m = dda_visit_list(kp[0], kp[1], kp[2], frame_light.x,
                                 frame_light.y, frame_light.z, g, max_steps,
                                 s.seen + k * words, s.list + k * s.list_cap);
    if ((tid & 31) == 0) s.len[k] = m;
  }
  __syncthreads();
  int off[kKeys + 1];
  int longest = 0;
  off[0] = 0;
#pragma unroll
  for (int k = 0; k < kKeys; ++k) {
    const int m = k < n ? s.len[k] : 0;
    off[k + 1] = off[k] + m;
    longest = max(longest, m);
  }
  const int total = pick<kKeys>(off, n);

  // 3. Stage the lists' candidates chunk by chunk; test each pixel's own.
  const size_t fbase = static_cast<size_t>(f) * g.volume();
  for (int c0 = 0; c0 < total; c0 += kChunkBins) {
    const int nb = min(kChunkBins, total - c0);
    for (int t = tid; t < nb * cap; t += nt) {
      const int e = c0 + t / cap;
      const int k = t % cap;
      int li = 0;
#pragma unroll
      for (int a = 1; a < kKeys; ++a) li += e >= off[a] ? 1 : 0;
      const size_t b =
          fbase + s.list[li * s.list_cap + e - pick<kKeys>(off, li)];
      const int live = min(counts[b], cap);
      if (k == 0) s.cand_n[t / cap] = live;
      if (k < live) {
        const Box box = candidate_box(pos, ext, players,
                                      bins_ent[b * cap + k], f);
        s.cand[2 * t] = box.lo;
        s.cand[2 * t + 1] = box.hi;
      }
    }
    __syncthreads();
    for (TilePixel p(bs); p.q < n_pix; p.next()) {
      const int li = start_of(p.q);
      if (li >= n || s.occ[p.q]) continue;
      const int e0 = max(c0, pick<kKeys>(off, li));
      const int e1 = min(c0 + nb, pick<kKeys>(off, li + 1));
      if (e0 >= e1) continue;
      const Ray r = ray_of(p.q, i0 + p.col, j0 + p.row);
      bool hit = false;
      for (int e = e0 - c0; e < e1 - c0 && !hit; ++e) {
        const int live = s.cand_n[e];
        for (int t = e * cap; t < e * cap + live; ++t) {
          const float4 lo = s.cand[2 * t];
          if (__float_as_int(lo.w) == r.self) continue;
          const float4 hi = s.cand[2 * t + 1];
          if (slab_hit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r)) {
            hit = true;
            break;
          }
        }
      }
      if (hit) s.occ[p.q] = 1;
    }
    __syncthreads();
  }

  // 4. Leftover pixels, and every pixel's lit bit.
  int direct = 0;
  for (TilePixel p(bs); p.q < n_pix; p.next()) {
    const int li = start_of(p.q);
    if (li == kNoPixel) continue;
    const int i = i0 + p.col;
    const int j = j0 + p.row;
    bool occluded = s.occ[p.q] != 0;
    if (li == kDirect) {
      occluded = march_occluded(pos, ext, players, bins_ent, counts, f, g,
                                ray_of(p.q, i, j), frame_light, max_steps);
      ++direct;
    }
    store(p.q, i, j, !occluded);
  }
  if (direct > 0) atomicAdd(stats + kStatDirect, direct);
  if (tid == 0) {
    atomicMax(stats + kStatStarts, n + (overflow ? 1 : 0));
    atomicMax(stats + kStatList, longest);
  }
}

}  // namespace par
