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
#include "common.cuh"

namespace {

__global__ void trace_winner_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ sprite_id, const int* __restrict__ atlas_depth,
    const int* __restrict__ bins_ent, const int* __restrict__ counts,
    const int* __restrict__ players, int* __restrict__ winner_out,
    int* __restrict__ best_out, par::Grid g, int sprite_w, int sprite_h,
    int early_exit) {
  extern __shared__ int smem[];
  int* s_cnt = smem;             // (hash_l,)
  int* s_fld = smem + g.hash_l;  // (hash_l * cap, kFields)

  const int f = blockIdx.y;
  const int column = blockIdx.x;  // bin_x * hash_h + bin_y
  const int bin_x = column / g.hash_h;
  const int bin_y = column % g.hash_h;
  par::stage_column(pos, ext, sprite_id, bins_ent, counts, players, f,
                    column, g, s_cnt, s_fld);
  __syncthreads();

  const int n_pix = g.bin_size * g.bin_size;
  for (int q = threadIdx.x; q < n_pix; q += blockDim.x) {
    const int i = bin_x * g.bin_size + q % g.bin_size;
    const int j = bin_y * g.bin_size + q / g.bin_size;
    if (i >= g.view_w || j >= g.view_h) continue;
    const par::Hit h = par::walk_column(s_cnt, s_fld, atlas_depth, i,
                                        g.view_h - j, g, sprite_w, sprite_h,
                                        early_exit);
    const size_t o =
        (static_cast<size_t>(f) * g.view_h + j) * g.view_w + i;
    winner_out[o] = h.slot >= 0 ? s_fld[h.slot * par::kFields] : -1;
    if (best_out != nullptr) best_out[o] = h.best;
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
  const size_t smem = sizeof(int) * static_cast<size_t>(par::column_ints(g));
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
