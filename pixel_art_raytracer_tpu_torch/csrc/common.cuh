// Shared definitions of the port's CUDA kernels.
//
// Build flags (runtime/kernels.py): -fmad=false so no multiply-add contracts
// into an FMA, and nvcc's defaults -prec-div=true -ftz=false so `/` is the
// IEEE correctly-rounded quotient and subnormals survive, as in the C++
// reference and in the plain PyTorch versions the kernels are checked
// against.
//
// The per-pixel bodies live here as __device__ functions: the bin-column
// walk of primary visibility (trace.cu), the slab test and the 7-phase DDA
// march of the shadow ray (shadow.cu), and both in sequence (fused.cu).  The
// three kernels call the same code, so they agree by construction.
#pragma once

#include <climits>

#include <cuda_runtime.h>

namespace par {

// std::min(a, b) == (b < a ? b : a): keeps `a` when the pair is unordered
// (NaN), unlike fminf.  Same for std::max.
__device__ __forceinline__ float c_min(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float c_max(float a, float b) { return a < b ? b : a; }

// The spatial hash and view geometry of RenderConfig.
struct Grid {
  int view_w, view_h;
  int bin_size, bin_cap;
  int hash_w, hash_h, hash_l;

  __host__ __device__ int volume() const { return hash_w * hash_h * hash_l; }
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
// Primary visibility (kernel 1; ops/trace.py::trace_winner).
// ---------------------------------------------------------------------------

constexpr int kFields = 8;  // entity, px, py, pz, ex, ey, ez, sprite id

// Shared ints a bin column's staged candidates take.
__host__ __device__ inline int column_ints(const Grid& g) {
  return g.hash_l + g.hash_l * g.bin_cap * kFields;
}

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

// Clipped texel address into the flattened atlas (alternative.cpp:324-341).
__device__ __forceinline__ int texel_index(int sid, int row, int col,
                                           int sprite_w, int sprite_h) {
  return (sid * sprite_h + min(max(row, 0), sprite_h - 1)) * sprite_w
         + min(max(col, 0), sprite_w - 1);
}

struct Hit {
  int best;  // depth key of the winner, INT_MIN for background
  int slot;  // the winner's staged slot (bz * cap + k), -1 for background
};

// Walk pixel (i, world_j)'s staged column in the reference's order: bin
// z = 0..hash_l-1, slot k < count.  Strictly greater depth wins (first
// candidate wins ties); the adjacent-hit counter counts bins with an
// improving candidate and resets on an empty bin, and the walk stops once
// it reaches 2 (quirk Q5).
__device__ inline Hit walk_column(const int* s_cnt, const int* s_fld,
                                  const int* atlas_depth, int i, int world_j,
                                  const Grid& g, int sprite_w, int sprite_h,
                                  int early_exit) {
  const int cap = g.bin_cap;
  Hit h{INT_MIN, -1};
  int isect = 0;
  for (int bz = 0; bz < g.hash_l; ++bz) {
    const int cnt = s_cnt[bz];
    if (cnt == 0) isect = 0;  // empty bin resets the counter
    const int n = min(cnt, cap);
    bool bin_hit = false;
    for (int k = 0; k < n; ++k) {
      const int* d = s_fld + (bz * cap + k) * kFields;
      const int px = d[1], py = d[2], pz = d[3];
      const int ex = d[4], ey = d[5], ez = d[6];
      const int top = py + ey + pz + ez;
      if (i < px || i >= px + ex || world_j <= py + pz || world_j > top)
        continue;
      const int row = top - world_j;
      const int depth = py - pz + min(0, ey - row)
                        - atlas_depth[texel_index(d[7], row, i - px,
                                                  sprite_w, sprite_h)];
      if (depth > h.best) {
        h.best = depth;
        h.slot = bz * cap + k;
        bin_hit = true;
      }
    }
    isect += bin_hit ? 1 : 0;
    if (early_exit && isect >= 2) break;
  }
  return h;
}

// ---------------------------------------------------------------------------
// Shadow occlusion (kernel 2; ops/shadow.py::trace_light_dynamic).
// ---------------------------------------------------------------------------

// A shadow ray: start bin, float origin, reciprocal direction, own entity.
struct Ray {
  int rbx, rby, rbz;
  float ox, oy, oz;
  float ivx, ivy, ivz;
  int self;
};

// Slab test of box (p, p + x) with the reference's std::min/std::max order
// (alternative.cpp:40-83).
__device__ __forceinline__ bool slab_hit(const int* p, const int* x,
                                         const Ray& r) {
  const float x1 = (static_cast<float>(p[0]) - r.ox) * r.ivx;
  const float x2 = (static_cast<float>(p[0] + x[0]) - r.ox) * r.ivx;
  float lo = c_min(x1, x2);
  float hi = c_max(x1, x2);
  const float y1 = (static_cast<float>(p[1]) - r.oy) * r.ivy;
  const float y2 = (static_cast<float>(p[1] + x[1]) - r.oy) * r.ivy;
  lo = c_max(lo, c_min(y1, y2));
  hi = c_min(hi, c_max(y1, y2));
  const float z1 = (static_cast<float>(p[2]) - r.oz) * r.ivz;
  const float z2 = (static_cast<float>(p[2] + x[2]) - r.oz) * r.ivz;
  lo = c_max(lo, c_min(z1, z2));
  hi = c_min(hi, c_max(z1, z2));
  return hi >= lo;
}

// March ray `r` toward light bin (lbx, lby, lbz) with the reference's
// 7-phase thick DDA (x, y, z, xy, xz, yz, advance) for 7 * int(largest)
// phases (alternative.cpp:399-500).  Every visited in-range flat bin other
// than the start bin tests its first `count` slots of frame f's table
// (s_bins (V, cap), s_cnt (V,)), skipping the ray's own entity; out-of-range
// flat bins are skipped and in-range aliased bins are used as they are.
// Returns true at the first occluder.
__device__ inline bool march_occluded(const int* pos, const int* ext,
                                      const int* players, int f,
                                      const int* s_bins, const int* s_cnt,
                                      const Grid& g, const Ray& r, int lbx,
                                      int lby, int lbz) {
  const int V = g.volume();
  const int cap = g.bin_cap;
  const float sx = static_cast<float>(r.rbx);
  const float sy = static_cast<float>(r.rby);
  const float sz = static_cast<float>(r.rbz);
  const float dx = static_cast<float>(lbx) - sx;
  const float dy = static_cast<float>(lby) - sy;
  const float dz = static_cast<float>(lbz) - sz;
  const float largest = c_max(c_max(fabsf(dx), fabsf(dy)), fabsf(dz));
  const float stx = dx / largest;
  const float sty = dy / largest;
  const float stz = dz / largest;
  const int n_phases = 7 * static_cast<int>(largest);
  const int start_flat = g.flat(r.rbx, r.rby, r.rbz);

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
    const int n = min(s_cnt[flat], cap);
    for (int k = 0; k < n; ++k) {
      const int e = s_bins[flat * cap + k];
      if (e == r.self) continue;
      const int es = e >= 0 ? e : 0;
      if (slab_hit(entity_pos(pos, players, f, es),
                   ext + 3 * static_cast<size_t>(es), r))
        return true;
    }
  }
  return false;
}

// Copy frame f's bin table into shared memory with all threads of the
// block: s_bins (V, cap) then s_cnt (V,).  The caller synchronises.
__device__ inline void stage_frame_table(const int* bins_ent,
                                         const int* counts, int f,
                                         const Grid& g, int* s_bins,
                                         int* s_cnt) {
  const int V = g.volume();
  const int cap = g.bin_cap;
  const int* f_bins = bins_ent + static_cast<size_t>(f) * V * cap;
  const int* f_cnt = counts + static_cast<size_t>(f) * V;
  for (int t = threadIdx.x; t < V * cap; t += blockDim.x) s_bins[t] = f_bins[t];
  for (int t = threadIdx.x; t < V; t += blockDim.x) s_cnt[t] = f_cnt[t];
}

// Shared ints a frame's bin table takes.
__host__ __device__ inline int frame_table_ints(const Grid& g) {
  return g.volume() * (g.bin_cap + 1);
}

}  // namespace par
