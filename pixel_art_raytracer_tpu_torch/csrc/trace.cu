// Kernel 1: primary visibility — the winner entity of every (frame, pixel).
//
// Replaces: pixel_art_raytracer_tpu/ops/trace_pallas.py::_trace_kernel.
// Computes exactly ops/trace.py::trace_winner of the port (and of the JAX
// package): the oblique-orthographic hit over the pixel's bin column, walked
// bin z = 0..hash_l-1 and slot k < count in the reference's order, strictly
// greater depth wins (first candidate wins ties), the adjacent-hit counter
// counts bins with an improving candidate and resets on an empty bin, and
// the walk stops once it reaches 2 (quirk Q5).  Background is -1.
//
// What bounds it on the H100: not memory.  A frame writes 4 B per pixel and
// reads ~2 KB of candidates per bin column; the cost is the per-pixel walk
// over up to hash_l * bin_cap = 64 candidates (integer compares and one
// sprite-depth load per hit), i.e. issue slots and shared-memory loads.
//
// What the design does about it: one block per (frame, bin column).  All
// pixels of a column test the same hash_l * bin_cap candidates, so the
// block stages them once in shared memory (entity, position, extent, sprite
// id: 8 ints each) and every thread walks them for its pixels with no
// global loads but the tiny sprite-depth atlas (L1-resident).  The TPU
// kernel's lane-selection matmul, packed picks, field packing, compaction
// and VMEM budgeting have no counterpart: they worked around the TPU's
// lack of a per-lane gather.
#include <climits>

#include "common.cuh"

namespace {

constexpr int kFields = 8;  // entity, px, py, pz, ex, ey, ez, sprite id

__global__ void trace_winner_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ sprite_id, const int* __restrict__ atlas_depth,
    const int* __restrict__ bins_ent, const int* __restrict__ counts,
    const int* __restrict__ players, int* __restrict__ winner_out,
    int* __restrict__ best_out, par::Grid g, int sprite_w, int sprite_h,
    int early_exit) {
  extern __shared__ int smem[];
  const int cap = g.bin_cap;
  const int n_slots = g.hash_l * cap;
  int* s_cnt = smem;             // (hash_l,)
  int* s_fld = smem + g.hash_l;  // (hash_l * cap, kFields)

  const int f = blockIdx.y;
  const int column = blockIdx.x;  // bin_x * hash_h + bin_y
  const int bin_x = column / g.hash_h;
  const int bin_y = column % g.hash_h;
  // Flat index of bin (bin_x, bin_y, 0) in frame f's tables.
  const size_t base = static_cast<size_t>(f) * g.volume()
                      + static_cast<size_t>(column) * g.hash_l;

  for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
    const int bz = s / cap;
    const int k = s % cap;
    const int cnt = counts[base + bz];
    if (k == 0) s_cnt[bz] = cnt;
    int* d = s_fld + s * kFields;
    if (k < cnt) {
      const int e = bins_ent[(base + bz) * cap + k];
      const int* p = par::entity_pos(pos, players, f, e);
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
  __syncthreads();

  const int n_pix = g.bin_size * g.bin_size;
  for (int q = threadIdx.x; q < n_pix; q += blockDim.x) {
    const int i = bin_x * g.bin_size + q % g.bin_size;
    const int j = bin_y * g.bin_size + q / g.bin_size;
    if (i >= g.view_w || j >= g.view_h) continue;
    const int world_j = g.view_h - j;

    int best = INT_MIN;
    int winner = -1;
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
        const int col = i - px;
        const int texel =
            (d[7] * sprite_h + min(max(row, 0), sprite_h - 1)) * sprite_w
            + min(max(col, 0), sprite_w - 1);
        const int depth = py - pz + min(0, ey - row) - atlas_depth[texel];
        if (depth > best) {
          best = depth;
          winner = d[0];
          bin_hit = true;
        }
      }
      isect += bin_hit ? 1 : 0;
      if (early_exit && isect >= 2) break;
    }
    const size_t o =
        (static_cast<size_t>(f) * g.view_h + j) * g.view_w + i;
    winner_out[o] = winner;
    if (best_out != nullptr) best_out[o] = best;
  }
}

}  // namespace

// winner_out (F, H, W) int32; best_out the same shape or null.  Tables are
// bins_ent (F, V, cap) and counts (F, V); players (F, 3) is entity 0's
// position per frame.  Returns cudaGetLastError() after the launch.
extern "C" int par_trace_winners(
    const void* pos, const void* ext, const void* sprite_id,
    const void* atlas_depth, const void* bins_ent, const void* counts,
    const void* players, void* winner_out, void* best_out, int n_frames,
    int view_w, int view_h, int bin_size, int bin_cap, int hash_w,
    int hash_h, int hash_l, int sprite_w, int sprite_h, int early_exit,
    int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem =
      sizeof(int) * (static_cast<size_t>(hash_l)
                     + static_cast<size_t>(hash_l) * bin_cap * kFields);
  const dim3 grid(hash_w * hash_h, n_frames);
  trace_winner_kernel<<<grid, threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(sprite_id),
      static_cast<const int*>(atlas_depth),
      static_cast<const int*>(bins_ent), static_cast<const int*>(counts),
      static_cast<const int*>(players), static_cast<int*>(winner_out),
      static_cast<int*>(best_out), g, sprite_w, sprite_h, early_exit);
  return static_cast<int>(cudaGetLastError());
}
