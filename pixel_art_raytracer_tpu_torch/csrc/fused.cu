// Kernel 3: primary visibility and shadow occlusion of every (frame, pixel)
// in one launch.
//
// Replaces: pixel_art_raytracer_tpu/ops/fused_pallas.py::_fused_kernel.
// Computes exactly ops/fused.py::trace_shadow of the port: for each pixel,
// the bin-column walk of kernel 1 (winner and best depth, common.cuh
// walk_column), the winner's surface point (y, z, entity) as
// ops/trace.py::decode_winner gives it, with background taking entity 0 and
// y = z = 0 (quirk Q6), the light geometry of ops/shade.py::light_geometry,
// and the 7-phase DDA march of kernel 2.  Every pixel is marched,
// background included, so `lit` equals the plain version on every pixel.
//
// Geometry op order (alternative.cpp:707-732): dx = float(lx) - float(wx),
// length = (|dx| + |dy|) + |dz|, tl = d / length and inv = 1 / tl -- two
// IEEE roundings, never length / d (nvcc -prec-div=true, -fmad=false, no
// fast reciprocal).  Start and light bins use C's truncating `/`, since
// view_h - y - z can be negative.  A light on the surface point gives
// length 0 and NaN tl/inv, which the slab test's std::min/std::max order
// handles as the reference does.  The march is exact for any light: there
// is no step bound and no domain guard, so nothing reroutes.
//
// What bounds it on the H100: not bytes (a pixel writes 5 B, the tables
// are read once per block from L2) but operations: the walk's depth keys
// and the march's slab tests.  Its first design walked every pixel over
// every candidate of its column (trace.cu says what that cost) and marched
// every pixel on its own (~48 DDA phases a pixel, bins probed again and
// again, a 24 B box gather per test).
//
// What the design does about it: one block per (frame, bin column).  The
// walk is kernel 1's (common.cuh walk_column: the column's live slots drawn
// in walk order over their footprints into per-pixel state in shared
// memory); its state lives in the three per-pixel buffers that then hold
// the surface point (y, z, entity), and its draw list in the march's shared
// memory, which the walk ends before the march begins, so the block keeps
// the shared memory and occupancy of the march.  The surface point comes
// from the best key without a second atlas read
// (sdep = py - pz + min(0, ey - row) - best).  A hit pixel starts its
// shadow ray in bin (i / bs, j / bs, z / bs), since y + z equals its world
// row, and a background pixel in (i / bs, view_h / bs, 0), so the column's
// pixels share one or two start bins.  common.cuh march_tile then walks
// the DDA once per distinct start bin (a warp each), stages the distinct
// bins' boxes once as float corners and has every pixel test its start's
// list; the light geometry is recomputed from the surface point in
// registers.  Pixels whose start bin does not fit the table of
// PointTable::kKeys march on their own (stats[kStatDirect]).  Exact
// because the lit bit is an OR over the probed bins, which depend only on
// (start bin, light bin).
// The TPU kernel's packed picks, VMEM windows, membership tables, candidate
// lists, divkernel division and sz-hull reduction have no counterpart.
//
// Large tiles (80 or 160 pixels a side in a 2x or 4x supersampled view)
// take the walk's row bands (common.cuh Grid::band_rows) for the march
// too: one block per (frame, bin column, band) walks the band, then
// marches the band's pixels over the keys of their own start bins, which
// is exact for any set of pixels.  So the block holds the surface points
// of at most
// kBandPixels pixels: 131,104 B at 4x on a 26x26x8 grid, where a whole
// 160-pixel tile would need 467,104 B.  A 40-pixel tile is one band, as
// before.
#include "common.cuh"

namespace {

// Shared ints of the region the walk's draw list shares with the march:
// the larger of the two layouts.
__host__ __device__ int shared_region_ints(const par::Grid& g) {
  const int march = par::MarchSmem<par::PointTable>::ints(
      g, g.band_pixels(), par::kNoStepCap);
  return march > par::draw_ints(g) ? march : par::draw_ints(g);
}

// Shared ints after that region: the column's candidates, then the
// surface point (y, z, entity) of each pixel of a band.
int fused_tail_ints(const par::Grid& g) {
  return par::column_ints(g) + 3 * g.band_pixels();
}

__global__ void __launch_bounds__(par::kMarchThreads,
                                  par::kMarchBlocksPerSM)
fused_trace_shadow_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ sprite_id, const int* __restrict__ atlas_depth,
    const int* __restrict__ bins_ent, const int* __restrict__ counts,
    const int* __restrict__ players, const int* __restrict__ lights,
    int* __restrict__ winner_out, int* __restrict__ best_out,
    unsigned char* __restrict__ lit_out, int* __restrict__ stats,
    par::Grid g, int sprite_w, int sprite_h, int early_exit) {
  extern __shared__ __align__(16) int smem[];
  const int bs = g.bin_size;
  const par::Band b = par::Band::of_block(g);
  if (b.j0(g) >= g.view_h) return;  // the band lies below the view
  const int n_pix = b.pixels(g);
  const int max_pix = g.band_pixels();
  const par::MarchSmem<par::PointTable> s(smem, g, n_pix, par::kNoStepCap);
  int* s_col = smem + shared_region_ints(g);
  int* s_y = s_col + par::column_ints(g);  // (max_pix,)
  int* s_z = s_y + max_pix;                // (max_pix,)
  int* s_ent = s_z + max_pix;              // (max_pix,)
  par::WalkSmem w;
  w.cnt = s_col;
  w.fld = s_col + g.hash_l;
  w.draw = smem;
  w.best = s_y;
  w.slot = s_z;
  w.hits = s_ent;

  const int f = blockIdx.y;
  const int bin_x = b.bin_x;
  par::walk_column(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                   players, f, b, g, sprite_w, sprite_h, early_exit, w);

  // Each pixel's winner and surface point (ops/trace.py::decode_winner),
  // over the walk's state of the same pixel: only the thread of pixel q
  // reads and writes q, and nothing here touches the march's region.
  for (par::TilePixel p(bs); p.q < n_pix; p.next()) {
    const int q = p.q;
    const int i = b.i0(g) + p.col;
    const int j = b.j0(g) + p.row;
    if (i >= g.view_w || j >= g.view_h) continue;
    const int best = w.best[q];
    const int slot = w.slot[q];
    int ent = 0, y = 0, z = 0;
    if (slot >= 0) {
      const int* d = w.fld + slot * par::kFields;
      const int py = d[2], pz = d[3];
      const int ey = d[5], ez = d[6];
      const int row = py + ey + pz + ez - (g.view_h - j);
      // The atlas texel's depth, from best = py - pz + min(0, ey - row)
      // - sdep.
      const int sdep = py - pz + min(0, ey - row) - best;
      ent = d[0];
      y = py + ey + ez - row - sdep;
      z = pz + sdep;
    }
    s_y[q] = y;
    s_z[q] = z;
    s_ent[q] = ent;
    const size_t o =
        (static_cast<size_t>(f) * g.view_h + j) * g.view_w + i;
    winner_out[o] = slot >= 0 ? ent : -1;
    if (best_out != nullptr) best_out[o] = best;
  }
  // march_tile synchronises before it reads the surface points.

  const int lx = lights[3 * f];
  const int ly = lights[3 * f + 1];
  const int lz = lights[3 * f + 2];
  // The start bin (i / bs, (view_h - y - z) / bs, z / bs); i / bs is the
  // tile's bin_x.
  auto key_of = [&](int q, int, int) {
    return par::PointTable::Key{
        {bin_x, (g.view_h - s_y[q] - s_z[q]) / bs, s_z[q] / bs}};
  };
  // Light geometry (ops/shade.py::light_geometry).
  auto ray_of = [&](int q, int i, int) {
    const int y = s_y[q];
    const int z = s_z[q];
    const float dx = static_cast<float>(lx) - static_cast<float>(i);
    const float dy = static_cast<float>(ly) - static_cast<float>(y);
    const float dz = static_cast<float>(lz) - static_cast<float>(z);
    const float length = fabsf(dx) + fabsf(dy) + fabsf(dz);
    return par::Ray{bin_x,
                    (g.view_h - y - z) / bs,
                    z / bs,
                    static_cast<float>(i),
                    static_cast<float>(y),
                    static_cast<float>(z),
                    1.0f / (dx / length),
                    1.0f / (dy / length),
                    1.0f / (dz / length),
                    s_ent[q]};
  };
  par::march_tile(pos, ext, players, bins_ent, counts, f, g, b,
                  make_int3(lx / bs, (g.view_h - ly - lz) / bs, lz / bs),
                  par::kNoStepCap, s, key_of, ray_of,
                  par::LitStore{lit_out, g, f}, stats);
}

size_t fused_smem(const par::Grid& g) {
  return sizeof(int) * static_cast<size_t>(shared_region_ints(g)
                                           + fused_tail_ints(g));
}

}  // namespace

// winner_out (F, H, W) int32; best_out the same shape or null; lit_out
// (F, H, W) uint8 (0/1).  Tables are bins_ent (F, V, cap) and counts (F, V);
// players (F, 3) is entity 0's position per frame and lights (F, 3) the
// point light per frame; stats (3,) int32 device counters (common.cuh
// MarchStat), added to.  One block per (bin column, band) and frame.
// Returns cudaGetLastError() after the launch.
extern "C" int par_fused_trace_shadow(
    const void* pos, const void* ext, const void* sprite_id,
    const void* atlas_depth, const void* bins_ent, const void* counts,
    const void* players, const void* lights, void* winner_out,
    void* best_out, void* lit_out, void* stats, int n_frames, int view_w,
    int view_h, int bin_size, int bin_cap, int hash_w, int hash_h,
    int hash_l, int sprite_w, int sprite_h, int early_exit, int threads,
    void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = fused_smem(g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_trace_shadow_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(hash_w * hash_h, n_frames, g.bands);
  fused_trace_shadow_kernel<<<grid, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(sprite_id),
      static_cast<const int*>(atlas_depth),
      static_cast<const int*>(bins_ent), static_cast<const int*>(counts),
      static_cast<const int*>(players), static_cast<const int*>(lights),
      static_cast<int*>(winner_out), static_cast<int*>(best_out),
      static_cast<unsigned char*>(lit_out), static_cast<int*>(stats), g,
      sprite_w, sprite_h, early_exit);
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes of one block, the blocks one SM holds at `threads` threads,
// registers a thread and local (stack and spill) bytes a thread, into
// out[0..3].  Returns the CUDA error code.
extern "C" int par_fused_occupancy(int view_w, int view_h, int bin_size,
                                   int bin_cap, int hash_w, int hash_h,
                                   int hash_l, int threads, int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = fused_smem(g);
  out[0] = static_cast<int>(smem);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_trace_shadow_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fused_trace_shadow_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, fused_trace_shadow_kernel, threads, smem));
}
