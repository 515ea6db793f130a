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
// DDA, and march_band, the one march of a point light's shadow rays over
// a band's streamed per-start-bin visit lists, whose pixels come from
// trace.cu's winners or from ray buffers (shadow.cu) or from the walk
// (fused.cu).  shadow.cu's directional mode marches on the same slab test
// and DDA rounds.  The kernels call the same code, so they agree by
// construction.
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
// whose key does not fit their band's or tile's table.  With kCount,
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
// The shadow marches' shared parts, and the point-light march of one band
// of a tile (kernels 2 and 3).
// ---------------------------------------------------------------------------

// Threads of a march block at most, and the blocks an SM should hold: 4
// blocks of 320 threads leave 51 registers a thread (48 used), which
// measured faster than 3 blocks at 64 registers.
constexpr int kMarchThreads = 320;
constexpr int kMarchBlocksPerSM = 4;
constexpr int kMarchWarps = kMarchThreads / 32;
constexpr unsigned char kDirect = 0xFE;  // pixel marched by march_occluded
constexpr unsigned char kNoPixel = 0xFF;  // outside the view

// Counters of the list path, one (3,) int32 array per launch's caller:
// pixels marched directly, the most keys one band (directional mode: one
// tile) held (the table's size + 1 where some did not fit), the longest
// visit list.
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

// off[k] for a k known only at run time, off[] kept in registers.
template <int kKeys>
__device__ __forceinline__ int pick(const int (&off)[kKeys + 1], int k) {
  int r = 0;
#pragma unroll
  for (int a = 0; a <= kKeys; ++a) r = a == k ? off[a] : r;
  return r;
}

// Start bins a band's table holds: a graybox tile has at most 2.
constexpr int kShadeKeys = 4;
// Pixels a thread loads at once, so that their gathers overlap: a band of
// 1,600 pixels is one round of 320 threads.
constexpr int kShadePixels = 5;
// A pixel's state byte: its key's index in the band's table, kShadeDirect
// (its key did not fit: it marches on its own), kShadeSettled (its colour
// is the same lit or occluded: it takes no key and no march) or kShadeNone
// (outside the view), with kShadeOccluded set once a staged box hits it.
constexpr unsigned char kShadeSettled = 0x7D;
constexpr unsigned char kShadeDirect = 0x7E;
constexpr unsigned char kShadeNone = 0x7F;
constexpr unsigned char kShadeOccluded = 0x80;

// The phases of march_band that shade_phases.py times: load, merge, key
// set-up, listing, staging, march, direct march and store.
constexpr int kShadePhases = 7;
#ifdef PAR_SHADE_PHASES
// Built with -DPAR_SHADE_PHASES (shade_phases.py only): thread 0 of every
// block reads clock64() at each mark, and at the end adds each phase's
// cycles, and 1 for the block, to its source file's g_shade_phase, which
// shadow.cu's par_shade_phases copies out and clears.
static __device__ unsigned long long g_shade_phase[kShadePhases + 1];
struct ShadePhaseClock {
  long long cycles[kShadePhases] = {};
  long long last;
  // (Set in the body: nvcc's host pass keeps an initializer list.)
  __device__ ShadePhaseClock() { last = clock64(); }
  // Phase a ends here.
  __device__ void mark(int a) {
    if (threadIdx.x != 0) return;
    const long long now = clock64();
    cycles[a] += now - last;
    last = now;
  }
  // The last phase ends here, once every thread has stored.
  __device__ void end() {
    __syncthreads();
    mark(kShadePhases - 1);
    if (threadIdx.x != 0) return;
    for (int a = 0; a < kShadePhases; ++a)
      atomicAdd(g_shade_phase + a,
                static_cast<unsigned long long>(cycles[a]));
    atomicAdd(g_shade_phase + kShadePhases, 1ull);
  }
};
#else
// Otherwise the marks compile to nothing.
struct ShadePhaseClock {
  __device__ void mark(int) {}
  __device__ void end() {}
};
#endif

// A key's DDA toward the frame's light bin (the rounds of dda_rounds),
// kept in shared memory from one chunk to the next.
struct ShadeKey {
  float ax, ay, az;     // the anchor: the start bin plus k0 steps, by the
                        // same float adds as dda_rounds
  float stx, sty, stz;  // the step
  int sby, sbz;         // the start bin's y and z
  int n_steps;          // min(int(largest), step cap): 7 * n_steps phases
  int start_flat;
  int k0;               // the next round's first step, a multiple of 4
  int skip;             // lanes of round k0 already listed
  int len;              // entries listed in this chunk
  int total;            // entries listed so far: the visit list's length
  int left_at;          // the last chunk after whose march a pixel of the
                        // key was left unoccluded (a source that settles)
  int pad1;
};

// The shared memory march_band works in for a band of n_pix pixels and
// chunks of `chunk` list entries; the base must be 16-byte aligned.  The
// per-pixel arrays start after the march's own head, or at `reserve` bytes
// where that is more (fused.cu's walk keeps its draw list there).
struct ShadeSmem {
  float4* cand;                  // (chunk * cap, 2) staged boxes (Box)
  unsigned long long* warp_key;  // (kMarchWarps, kShadeKeys) each warp's
                                 // start bins (the source's keys)
  unsigned long long* key_id;    // (kShadeKeys,) the band's start bins
  ShadeKey* key;                 // (kShadeKeys,) their DDAs
  int* cand_n;                   // (chunk,) live slots of a staged entry
  int* flat;                     // (chunk,) each active key's share of
                                 // the chunk's listed bins
  int* warp_n;                   // (kMarchWarps,) keys in warp_key
  int* warp_slot;                // (kMarchWarps, kShadeKeys) their index
                                 // in key_id, or kShadeDirect
  int* ctl;                      // [0] keys in the table, [1] 1 if one did
                                 // not fit
  unsigned* seen;                // (kShadeKeys, words) bins each key has
                                 // listed
  int* y;                        // (n_pix,) the ray origin's y
  int* z;                        // (n_pix,) and z
  int* self;                     // (n_pix,) the pixel's entity
  int* texel;                    // (n_pix,) its atlas texel, -1 for
                                 // background (what the source keeps)
  float* ivx;                    // (n_pix,) the reciprocal direction
  float* ivy;
  float* ivz;
  unsigned char* state;          // (n_pix,) key index and occluded bit

  __host__ __device__ static int words(const Grid& g) {
    return (g.volume() + 31) / 32;
  }
  __host__ __device__ static size_t bytes(const Grid& g, int n_pix,
                                          int chunk, size_t reserve = 0) {
    const size_t head =
        static_cast<size_t>(32 * chunk * g.bin_cap
                            + 8 * (kMarchWarps + 1) * kShadeKeys)
        + sizeof(ShadeKey) * kShadeKeys
        + static_cast<size_t>(4 * (2 * chunk + kMarchWarps
                                   + kMarchWarps * kShadeKeys + 2)
                              + 4 * kShadeKeys * words(g));
    return (head > reserve ? head : reserve) + 29 * static_cast<size_t>(n_pix);
  }
  __device__ ShadeSmem(int* base, const Grid& g, int n_pix, int chunk,
                       size_t reserve = 0) {
    char* p = reinterpret_cast<char*>(base);
    cand = reinterpret_cast<float4*>(p);
    p += 32 * chunk * g.bin_cap;
    warp_key = reinterpret_cast<unsigned long long*>(p);
    key_id = warp_key + kMarchWarps * kShadeKeys;
    key = reinterpret_cast<ShadeKey*>(key_id + kShadeKeys);
    cand_n = reinterpret_cast<int*>(key + kShadeKeys);
    flat = cand_n + chunk;
    warp_n = flat + chunk;
    warp_slot = warp_n + kMarchWarps;
    ctl = warp_slot + kMarchWarps * kShadeKeys;
    seen = reinterpret_cast<unsigned*>(ctl + 2);
    y = reinterpret_cast<int*>(seen + kShadeKeys * words(g));
    const size_t head = reinterpret_cast<char*>(y)
                        - reinterpret_cast<char*>(base);
    if (reserve > head)
      y = reinterpret_cast<int*>(reinterpret_cast<char*>(base) + reserve);
    z = y + n_pix;
    self = z + n_pix;
    texel = self + n_pix;
    ivx = reinterpret_cast<float*>(texel + n_pix);
    ivy = ivx + n_pix;
    ivz = ivy + n_pix;
    state = reinterpret_cast<unsigned char*>(ivz + n_pix);
  }
};

// A start bin's y and z in one word: equal words, equal bins.
__device__ __forceinline__ unsigned long long pack_start(int sby, int sbz) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(sby)) << 32)
         | static_cast<unsigned>(sbz);
}

// The towards-light direction of ops/shade.py::light_geometry from origin
// (i, y, z) to light l: d / length with length = (|dx| + |dy|) + |dz|,
// IEEE divisions (NaN for a light on the surface point).
__device__ __forceinline__ float3 towards_light(int i, int y, int z,
                                                int3 l) {
  const float dx = static_cast<float>(l.x) - static_cast<float>(i);
  const float dy = static_cast<float>(l.y) - static_cast<float>(y);
  const float dz = static_cast<float>(l.z) - static_cast<float>(z);
  const float length = fabsf(dx) + fabsf(dy) + fabsf(dz);
  return make_float3(dx / length, dy / length, dz / length);
}

// The bin of point light l, C's `/`.
__device__ __forceinline__ int3 light_bin(int3 l, const Grid& g) {
  return make_int3(l.x / g.bin_size, (g.view_h - l.y - l.z) / g.bin_size,
                   l.z / g.bin_size);
}

// The rays of surface points of the view, as march_band's sources from
// winners (shadow.cu) and from the walk (fused.cu) load them: s.y and s.z
// hold pixel (i, j)'s surface point, the ray starts at (i, y, z) in bin
// (i / bs, (view_h - y - z) / bs, z / bs), and i / bs is the band's bin
// column, so a key is the start bin's y and z (pack_start).  Their stores
// write the lit bit, so no pixel settles.
struct SurfaceRays {
  static constexpr bool kSettles = false;
  __device__ static bool key(const ShadeSmem& s, const Grid& g, int q, int,
                             int, unsigned long long& k) {
    const int y = s.y[q];
    const int z = s.z[q];
    k = pack_start((g.view_h - y - z) / g.bin_size, z / g.bin_size);
    return true;
  }
  __device__ static int3 start(unsigned long long k, const Band& b) {
    return make_int3(b.bin_x, static_cast<int>(static_cast<unsigned>(k >> 32)),
                     static_cast<int>(static_cast<unsigned>(k)));
  }
  __device__ static float3 origin(const ShadeSmem& s, int q, int i) {
    return make_float3(static_cast<float>(i), static_cast<float>(s.y[q]),
                       static_cast<float>(s.z[q]));
  }
  __device__ static Ray direct(const ShadeSmem& s, const Grid& g,
                               const Band& b, int q, int i, int) {
    const int y = s.y[q];
    const int z = s.z[q];
    return Ray{b.bin_x, (g.view_h - y - z) / g.bin_size, z / g.bin_size,
               static_cast<float>(i), static_cast<float>(y),
               static_cast<float>(z), s.ivx[q], s.ivy[q], s.ivz[q],
               s.self[q]};
  }
};

// List key K's next distinct bins, at most `room`, into out[0..) in
// first-visit order: the rounds of dda_rounds from the anchor where the
// last call stopped, the lowest lane of equal bins not yet in `seen`
// listing it, in lane order.  Where a round holds more fresh bins than the
// room left, its lanes up to the first fresh one that does not fit are
// listed and the next call resumes the round from that lane (K.skip): the
// bins the lanes before it probed are all in `seen` by then.  All 32
// lanes of a warp call it; it sets K.len to the entries listed.
__device__ inline void list_next(ShadeKey& K, const Grid& g, unsigned* seen,
                                 int* out, int room) {
  const int V = g.volume();
  const int lane = threadIdx.x & 31;
  const int d = lane / 7;
  const int phase = lane % 7;
  const bool ax = phase == 0 || phase == 3 || phase == 4 || phase == 6;
  const bool ay = phase == 1 || phase == 3 || phase == 5 || phase == 6;
  const bool az = phase == 2 || phase == 4 || phase == 5 || phase == 6;
  const float stx = K.stx, sty = K.sty, stz = K.stz;
  const int n_steps = K.n_steps;
  const int start_flat = K.start_flat;
  float bx = K.ax, by = K.ay, bz = K.az;
  int k0 = K.k0;
  int skip = K.skip;
  int m = 0;
  while (k0 < n_steps && m < room) {
    float tx = bx, ty = by, tz = bz;
    for (int a = 0; a < d && a < 4; ++a) {
      tx = tx + stx;
      ty = ty + sty;
      tz = tz + stz;
    }
    int flat = -1 - lane;  // never a bin, and unique to the lane
    if (d < 4 && k0 + d < n_steps && lane >= skip) {
      const int v = g.flat(static_cast<int>(tx + (ax ? stx : 0.0f)),
                           static_cast<int>(ty + (ay ? sty : 0.0f)),
                           static_cast<int>(tz + (az ? stz : 0.0f)));
      if (v >= 0 && v < V && v != start_flat) flat = v;
    }
    const unsigned same = __match_any_sync(kFullWarp, flat);
    const bool fresh = flat >= 0 && __ffs(same) - 1 == lane
                       && (seen[flat >> 5] & (1u << (flat & 31))) == 0u;
    const unsigned fresh_lanes = __ballot_sync(kFullWarp, fresh);
    const int rank = __popc(fresh_lanes & ((1u << lane) - 1u));
    const int left = room - m;
    if (fresh && rank < left) {
      atomicOr(seen + (flat >> 5), 1u << (flat & 31));
      out[m + rank] = flat;
    }
    if (__popc(fresh_lanes) > left) {
      skip = __ffs(__ballot_sync(kFullWarp, fresh && rank == left)) - 1;
      m = room;
      break;
    }
    m += __popc(fresh_lanes);
    for (int a = 0; a < 4; ++a) {
      bx = bx + stx;
      by = by + sty;
      bz = bz + stz;
    }
    k0 += 4;
    skip = 0;
    __syncwarp();
  }
  __syncwarp();
  if (lane == 0) {
    K.ax = bx;
    K.ay = by;
    K.az = bz;
    K.k0 = k0;
    K.skip = skip;
    K.len = m;
    K.total += m;
  }
}

// The lit bit of every pixel in the view of band b of frame f under a
// point light in bin lb, each pixel's ray probing 7 * min(int(largest),
// max_steps) phases (kNoStepCap for none), handed with the pixel to
// src.store.  The pixels come from `src` (Src), which loads each into the
// band's shared memory and says how its ray starts:
//   load(s, g, q, i, j)   pixel q at view column i, row j: its ray's
//                         origin y and z, entity and reciprocal direction
//                         (and what its store reads) into s's arrays; a
//                         source that settles returns whether pixel q
//                         settles: its store writes the same whether its
//                         ray is occluded or not;
//   key(s, g, q, i, j, k) its start bin's key; false where it has none
//                         that fits (the pixel marches on its own);
//   start(k, b)           the start bin of key k;
//   origin(s, q, i)       the ray's origin;
//   direct(s, g, b, q, i, j)  the Ray of a pixel that marches on its own;
//   store(s, g, q, i, j, occluded);
//   kSettles              whether the source settles pixels; then
//   settles()             whether it may in this launch.
// All threads of the block call it; blockDim.x is a multiple of 32, at
// least 32 * kShadeKeys and at most kMarchThreads, and chunk >= kShadeKeys.
// With kCount the block adds its slab tests to work_out[0] and the pixels
// it marched (on a key's list or on their own) to work_out[1]; without,
// work_out is not read.
//
// 1. Each pixel is loaded once, kShadePixels a thread at a time so that
//    their gathers overlap; then, unless it is settled (kShadeSettled: no
//    key, no march, stored as occluded), its key goes into its warp's list
//    of distinct keys (a key missing from the list is added by the lowest
//    lane that has it), or the pixel takes kShadeDirect past kShadeKeys.
// 2. Warp 0 merges the warps' lists into the band's table.
// 3. Each pixel takes its index in the table, and each key's DDA is set up
//    as dda_rounds sets it up.
// 4. The visit lists are streamed: each key keeps its DDA where it stopped
//    (ShadeKey, and a V-bit mask of the bins listed), and each chunk its
//    warp lists the key's next distinct bins, in first-visit order, into
//    its share of `chunk` entries; the staged entries' boxes are tested by
//    every pixel of the key not yet occluded, in that order (a ray meets
//    its occluder sooner among the bins near its start).  Where pixels
//    settle, a key whose pixels are all occluded after a chunk retires
//    from the next, whatever steps its DDA has left.
// 5. The pixels whose key did not fit march on their own (march_occluded),
//    and every pixel is stored.
//
// Exact: a ray's probed bins depend only on (start bin, light bin, step
// cap), which its key and the launch fix, and its occlusion is an OR over
// them of a test of the ray and a box, which ignores order and repeats.
// So any set of pixels marches exactly, a band as well as a tile.  A
// settled pixel's store is the same either way, and a retired key has no
// pixel whose answer could still change.
template <bool kCount, class Src>
__device__ __forceinline__ void march_band(
    const int* pos, const int* ext, const int* players, const int* bins_ent,
    const int* counts, int f, const Grid& g, const Band& b, int3 lb,
    int max_steps, const ShadeSmem& s, int chunk, const Src& src,
    int* stats, unsigned long long* work_out) {
  ShadePhaseClock phases;
  const int bs = g.bin_size;
  const int cap = g.bin_cap;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid / 32;
  const int n_pix = b.pixels(g);
  const int i0 = b.i0(g);
  const int j0 = b.j0(g);
  const int words = ShadeSmem::words(g);
  unsigned tests = 0u;  // this thread's slab tests (kCount)
  // Whether pixels settle and keys retire in this launch.
  bool settling = false;
  if constexpr (Src::kSettles) settling = src.settles();

  for (int w = tid; w < kShadeKeys * words; w += nt) s.seen[w] = 0u;

  // 1. Load each pixel; its key into its warp's list.
  unsigned long long* wkey = s.warp_key + warp * kShadeKeys;
  int wn = 0;  // entries of wkey, the same in every lane
  TilePixel tp(bs);
  for (int r0 = 0; r0 < n_pix; r0 += nt * kShadePixels) {
    unsigned in_view = 0u;  // bit p: the round's pixel p is in the view
    unsigned settled = 0u;  // bit p: it is settled
    TilePixel dp = tp;
#pragma unroll
    for (int p = 0; p < kShadePixels; ++p) {
      const int i = i0 + dp.col;
      const int j = j0 + dp.row;
      if (dp.q < n_pix && i < g.view_w && j < g.view_h) {
        if constexpr (Src::kSettles)
          settled |= src.load(s, g, dp.q, i, j) ? 1u << p : 0u;
        else
          src.load(s, g, dp.q, i, j);
        in_view |= 1u << p;
      }
      dp.next();
    }
#pragma unroll
    for (int p = 0; p < kShadePixels; ++p) {
      const int q = tp.q;
      unsigned long long key = 0ull;
      int slot = kShadeNone;
      if ((settled >> p) & 1u) {
        slot = kShadeSettled;
      } else if ((in_view >> p) & 1u) {
        slot = kShadeDirect;
        if (src.key(s, g, q, i0 + tp.col, j0 + tp.row, key)) {
          slot = -1;
          for (int a = 0; a < wn; ++a)
            if (wkey[a] == key) slot = a;
        }
      }
      unsigned missing = __ballot_sync(kFullWarp, slot < 0);
      while (missing != 0u) {
        const int leader = __ffs(missing) - 1;
        const unsigned long long lk = __shfl_sync(kFullWarp, key, leader);
        const int added = wn < kShadeKeys ? wn : kShadeDirect;
        if (lane == leader && wn < kShadeKeys) wkey[wn] = lk;
        wn += wn < kShadeKeys ? 1 : 0;
        if (slot < 0 && key == lk) slot = added;
        missing = __ballot_sync(kFullWarp, slot < 0);
        __syncwarp();
      }
      if (q < n_pix) s.state[q] = static_cast<unsigned char>(slot);
      tp.next();
    }
  }
  if (lane == 0) s.warp_n[warp] = wn;
  __syncthreads();
  phases.mark(0);

  // 2. Warp 0 merges the warps' lists into the band's table, 32 entries at
  //    a time: an entry already in the table takes its index; the lowest
  //    lane of each new key (__match_any_sync) adds it, in lane order, up
  //    to kShadeKeys.
  if (warp == 0) {
    const int nc = nt / 32 * kShadeKeys;
    int n = 0;
    bool over = false;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int c = c0 + lane;
      const bool valid = c < nc && c % kShadeKeys < s.warp_n[c / kShadeKeys];
      const unsigned long long k = valid ? s.warp_key[c] : 0ull;
      int idx = -1;
      for (int a = 0; a < n; ++a)
        if (valid && s.key_id[a] == k) idx = a;
      const bool fresh = valid && idx < 0;
      const unsigned fresh_lanes = __ballot_sync(kFullWarp, fresh);
      const unsigned same = __match_any_sync(kFullWarp, k) & fresh_lanes;
      const int leader = fresh ? __ffs(same) - 1 : lane;
      const unsigned leaders =
          __ballot_sync(kFullWarp, fresh && leader == lane);
      const int at = n + __popc(leaders & ((1u << lane) - 1u));
      if (fresh && leader == lane && at < kShadeKeys) s.key_id[at] = k;
      const int got = __shfl_sync(kFullWarp, at, leader);
      if (fresh) idx = got < kShadeKeys ? got : kShadeDirect;
      if (c < nc) s.warp_slot[c] = idx;
      over = over || n + __popc(leaders) > kShadeKeys;
      n = min(n + __popc(leaders), kShadeKeys);
      __syncwarp();
    }
    if (lane == 0) {
      s.ctl[0] = n;
      s.ctl[1] = over ? 1 : 0;
    }
  }
  __syncthreads();
  phases.mark(1);
  const int n = s.ctl[0];

  // 3. Each pixel's index in the table (the thread that loaded it reads
  //    it), and each key's DDA from its start bin.
  for (TilePixel p(bs); p.q < n_pix; p.next()) {
    const int st = s.state[p.q];
    if (st < kShadeKeys)
      s.state[p.q] = static_cast<unsigned char>(
          s.warp_slot[warp * kShadeKeys + st]);
  }
  if (tid < n) {
    ShadeKey& K = s.key[tid];
    const int3 sb = src.start(s.key_id[tid], b);
    K.sby = sb.y;
    K.sbz = sb.z;
    const float sx = static_cast<float>(sb.x);
    const float sy = static_cast<float>(sb.y);
    const float sz = static_cast<float>(sb.z);
    const float dx = static_cast<float>(lb.x) - sx;
    const float dy = static_cast<float>(lb.y) - sy;
    const float dz = static_cast<float>(lb.z) - sz;
    const float largest = c_max(c_max(fabsf(dx), fabsf(dy)), fabsf(dz));
    K.stx = dx / largest;
    K.sty = dy / largest;
    K.stz = dz / largest;
    K.n_steps = min(static_cast<int>(largest), max_steps);
    K.start_flat = g.flat(sb.x, sb.y, sb.z);
    K.ax = sx;
    K.ay = sy;
    K.az = sz;
    K.k0 = 0;
    K.skip = 0;
    K.len = 0;
    K.total = 0;
    K.left_at = -1;
  }
  __syncthreads();
  phases.mark(2);

  // 4. The lists in chunks: each active key's warp lists its next bins
  //    into its share of the chunk; the entries, compacted in key order
  //    (key k's from off[k]), have their first min(count, cap) slots staged
  //    as boxes (entity 0 at players[f]); every pixel of a key, not yet
  //    occluded, tests its key's entries in order, skipping its own entity
  //    and stopping at its first hit.  Where pixels settle, a key none of
  //    whose pixels is left unoccluded (K.left_at not this chunk's) retires.
  const size_t fbase = static_cast<size_t>(f) * g.volume();
  // Keys whose DDA has steps left: at first those with any (n_steps, which
  // no warp writes again, unlike k0).
  unsigned active = 0u;
  for (int k = 0; k < n; ++k) active |= s.key[k].n_steps > 0 ? 1u << k : 0u;
  for (int round = 0; active != 0u; ++round) {
    const int share = chunk / __popc(active);
    if (warp < n && ((active >> warp) & 1u))
      list_next(s.key[warp], g, s.seen + warp * words,
                s.flat + __popc(active & ((1u << warp) - 1u)) * share,
                share);
    __syncthreads();
    phases.mark(3);
    int off[kShadeKeys + 1];
    unsigned next = 0u;
    off[0] = 0;
#pragma unroll
    for (int k = 0; k < kShadeKeys; ++k) {
      const bool on = ((active >> k) & 1u) != 0u;
      off[k + 1] = off[k] + (on ? s.key[k].len : 0);
      next |= on && s.key[k].k0 < s.key[k].n_steps ? 1u << k : 0u;
    }
    const int total = off[kShadeKeys];
    for (int t = tid; t < total * cap; t += nt) {
      const int e = t / cap;
      const int slot = t - e * cap;
      int k = 0;
#pragma unroll
      for (int a = 1; a < kShadeKeys; ++a) k += e >= off[a] ? 1 : 0;
      const size_t bb = fbase + s.flat[__popc(active & ((1u << k) - 1u))
                                       * share
                                       + e - pick<kShadeKeys>(off, k)];
      const int live = min(counts[bb], cap);
      if (slot == 0) s.cand_n[e] = live;
      if (slot < live) {
        const Box box = candidate_box(pos, ext, players,
                                      bins_ent[bb * cap + slot], f);
        s.cand[2 * t] = box.lo;
        s.cand[2 * t + 1] = box.hi;
      }
    }
    __syncthreads();
    phases.mark(4);
    for (TilePixel p(bs); p.q < n_pix; p.next()) {
      const int st = s.state[p.q];
      if (st >= kShadeKeys) continue;  // occluded, direct or no pixel
      const int e0 = pick<kShadeKeys>(off, st);
      const int e1 = pick<kShadeKeys>(off, st + 1);
      if (e0 >= e1) continue;
      const float3 o = src.origin(s, p.q, i0 + p.col);
      const Ray r{0, 0, 0, o.x, o.y, o.z,
                  s.ivx[p.q], s.ivy[p.q], s.ivz[p.q], s.self[p.q]};
      bool hit = false;
      for (int e = e0; e < e1 && !hit; ++e) {
        const int live = s.cand_n[e];
        for (int t = e * cap; t < e * cap + live; ++t) {
          const float4 lo = s.cand[2 * t];
          if (__float_as_int(lo.w) == r.self) continue;
          if constexpr (kCount) ++tests;
          const float4 hi = s.cand[2 * t + 1];
          if (slab_hit(lo.x, lo.y, lo.z, hi.x, hi.y, hi.z, r)) {
            hit = true;
            break;
          }
        }
      }
      if (hit)
        s.state[p.q] = static_cast<unsigned char>(st | kShadeOccluded);
      else if constexpr (Src::kSettles)
        s.key[st].left_at = round;
    }
    __syncthreads();
    phases.mark(5);
    if constexpr (Src::kSettles) {
      if (settling) {
#pragma unroll
        for (int k = 0; k < kShadeKeys; ++k)
          if (s.key[k].left_at != round) next &= ~(1u << k);
      }
    }
    active = next;
  }

  // 5. Pixels whose key did not fit march on their own; every pixel is
  //    stored, a settled one as occluded.
  int direct = 0;
  unsigned marched = 0u;  // this thread's pixels marched (kCount)
  for (TilePixel p(bs); p.q < n_pix; p.next()) {
    const int st = s.state[p.q];
    if (st == kShadeNone) continue;
    const int i = i0 + p.col;
    const int j = j0 + p.row;
    bool occluded = (st & kShadeOccluded) != 0;
    if (st == kShadeDirect) {
      occluded = march_occluded<kCount>(pos, ext, players, bins_ent, counts,
                                        f, g, src.direct(s, g, b, p.q, i, j),
                                        lb, max_steps, &tests);
      ++direct;
    }
    if constexpr (Src::kSettles) occluded = occluded || st == kShadeSettled;
    if constexpr (kCount) marched += st != kShadeSettled ? 1u : 0u;
    src.store(s, g, p.q, i, j, occluded);
  }
  phases.end();
  if (direct > 0) atomicAdd(stats + kStatDirect, direct);
  if (tid == 0) {
    int longest = 0;
    for (int k = 0; k < n; ++k) longest = max(longest, s.key[k].total);
    atomicMax(stats + kStatStarts, n + s.ctl[1]);
    atomicMax(stats + kStatList, longest);
  }
  if constexpr (kCount) {
    // warp_n and warp_slot are not read after step 3: they hold each
    // warp's sums.
    tests = __reduce_add_sync(kFullWarp, tests);
    marched = __reduce_add_sync(kFullWarp, marched);
    if (lane == 0) {
      s.warp_n[warp] = static_cast<int>(tests);
      s.warp_slot[warp] = static_cast<int>(marched);
    }
    __syncthreads();
    if (tid == 0) {
      unsigned long long block_tests = 0ull, block_marched = 0ull;
      for (int w = 0; w < nt / 32; ++w) {
        block_tests += static_cast<unsigned>(s.warp_n[w]);
        block_marched += static_cast<unsigned>(s.warp_slot[w]);
      }
      atomicAdd(work_out, block_tests);
      atomicAdd(work_out + 1, block_marched);
    }
  }
}

}  // namespace par
