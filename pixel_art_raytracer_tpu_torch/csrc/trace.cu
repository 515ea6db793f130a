// Kernel 1: primary visibility — the winner entity of every (frame, pixel).
//
// Replaces: pixel_art_raytracer_tpu/ops/trace_pallas.py::_trace_kernel.
// Computes exactly ops/trace.py::trace_winner of the port (and of the JAX
// package): the oblique-orthographic hit over the pixel's bin column, walked
// bin z = 0..hash_l-1 and slot k < count in the reference's order, strictly
// greater depth wins (first candidate wins ties), the adjacent-hit counter
// counts bins with an improving candidate and resets on an empty bin, and
// the walk stops once it reaches 2 (quirk Q5).  Background is -1.  A
// launch covers a window of whole bin rows of the view (all of them, or a
// row shard's, parallel/mesh.py): a pixel's walk reads only its own bin
// column, so a window's winners are the full frame's rows.
//
// What bounds it on the H100: bytes.  It must write 4 B of winner a pixel
// (39.3 MB for 64 frames of 480x320) and read its bin tables and the
// entity rows they name, 0.0123 ms at 3.35 TB/s; the operations its inputs
// need take less.
//
// What held it back: its first design gave each thread 5 of a column's
// 1,600 pixels and walked, for each, every live slot of the column's bins
// (7 shared loads, the interval test, and on a hit a dependent atlas
// gather).  On graybox a column holds 8.7 live slots of which a pixel hits
// 2.9, and a warp took the hit branch 5.8 times (the OR over its lanes):
// two thirds of the tests missed, and the hit path ran serialised at twice
// the rate the pixels needed.
//
// What the design does about it (common.cuh walk_column): one block per
// (frame, bin column).  The block stages the column's candidates, lists
// its live slots in walk order with each slot's footprint clipped to the
// tile (an empty one costs nothing), and draws the slots one at a time,
// all threads striding over the footprint's pixels, into per-pixel state
// in shared memory (best key, slot, adjacent-hit count with the last bin
// that improved); a list entry holds what the draw needs precomputed, read
// as four 16-byte loads.  Work follows the hits, not the tests, and no
// lane waits on another lane's hit.  A coalesced epilogue writes the
// winners.  The TPU kernel's lane-selection matmul, packed picks,
// incremental keys, column compaction and VMEM budgeting have no
// counterpart: they worked around the TPU's lack of a per-lane gather.
//
// Large tiles (supersampled views scale the bin with the view: 80 or 160
// pixels a side at 2x or 4x) are walked in row bands of at most
// kBandPixels pixels, one block per (frame, bin column, band), each with
// its own per-pixel state: the block keeps the 25,392 B and the 6 blocks
// per SM of a 40-pixel tile, where a whole 160-pixel tile would need
// 313,392 B, past the 227 KB a block may use.  Restaging the column per
// band costs 2 KB of reads from L2.
#include "common.cuh"

namespace {

// At most 512 threads a block, and 4 such blocks an SM: 32 registers a
// thread, so an SM holds 6 blocks of 320 threads (graybox), which measured
// faster than the 4 that 40 registers allow.
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 4;

// Shared bytes of a block: the draw list, the column, three ints a pixel
// of a band (at most 48 KB, the default; the wrapper refuses more).
size_t trace_smem(const par::Grid& g) {
  return sizeof(int) * static_cast<size_t>(
      par::draw_ints(g) + par::column_ints(g) + 3 * g.band_pixels());
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
trace_winner_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ sprite_id, const int* __restrict__ atlas_depth,
    const int* __restrict__ bins_ent, const int* __restrict__ counts,
    const int* __restrict__ players, int* __restrict__ winner_out,
    int* __restrict__ best_out, par::Grid g, int sprite_w, int sprite_h,
    int early_exit) {
  extern __shared__ __align__(16) int smem[];
  const int bs = g.bin_size;
  const par::Band b = par::Band::of_block(g);
  if (b.j0(g) >= g.view_h) return;  // the band lies below the view
  const int n_pix = b.pixels(g);
  const int max_pix = g.band_pixels();
  par::WalkSmem s;
  s.draw = smem;
  s.cnt = smem + par::draw_ints(g);
  s.fld = s.cnt + g.hash_l;
  s.best = s.cnt + par::column_ints(g);
  s.slot = s.best + max_pix;
  s.hits = s.slot + max_pix;

  const int f = blockIdx.y;
  par::walk_column(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                   players, f, b, g, sprite_w, sprite_h, early_exit, s);

  for (par::TilePixel p(bs); p.q < n_pix; p.next()) {
    const int i = b.i0(g) + p.col;
    const int j = b.j0(g) + p.row;
    if (i >= g.view_w || j >= g.view_h) continue;
    const int slot = s.slot[p.q];
    const size_t o = g.pixel(f, i, j);
    winner_out[o] = slot >= 0 ? s.fld[slot * par::kFields] : -1;
    if (best_out != nullptr) best_out[o] = s.best[p.q];
  }
}

}  // namespace

// winner_out (F, rows, W) int32 for the window of bin rows row_bin0 ..
// row_bin0 + bin_rows - 1 (pixel rows row_bin0 * bin_size on, at most
// bin_rows * bin_size of them: the whole view for 0 and hash_h); best_out
// the same shape or null.  Tables are bins_ent (F, V, cap) and counts
// (F, V); players (F, 3) is entity 0's position per frame.  One block per
// (bin column of the window, band) and frame.  Returns cudaGetLastError()
// after the launch.
extern "C" int par_trace_winners(
    const void* pos, const void* ext, const void* sprite_id,
    const void* atlas_depth, const void* bins_ent, const void* counts,
    const void* players, void* winner_out, void* best_out, int n_frames,
    int view_w, int view_h, int bin_size, int bin_cap, int hash_w,
    int hash_h, int hash_l, int sprite_w, int sprite_h, int early_exit,
    int row_bin0, int bin_rows, int threads, void* stream) {
  const par::Grid g = par::Grid{view_w, view_h, bin_size, bin_cap, hash_w,
                                hash_h, hash_l}.window(row_bin0, bin_rows);
  const size_t smem = trace_smem(g);
  const dim3 grid(hash_w * bin_rows, n_frames, g.bands);
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

// Shared bytes of one trace_winner_kernel block, the blocks one SM holds at
// `threads` threads, registers a thread and local (stack and spill) bytes
// a thread, into out[0..3].  Returns the CUDA error code.
extern "C" int par_trace_occupancy(int view_w, int view_h, int bin_size,
                                   int bin_cap, int hash_w, int hash_h,
                                   int hash_l, int threads, int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = trace_smem(g);
  out[0] = static_cast<int>(smem);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, trace_winner_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, trace_winner_kernel, threads, smem));
}
