// Kernel 3: primary visibility and shadow occlusion of every (frame, pixel)
// in one launch.
//
// Replaces: pixel_art_raytracer_tpu/ops/fused_pallas.py::_fused_kernel.
// Computes exactly ops/fused.py::trace_shadow of the port: for each pixel,
// the bin-column walk of kernel 1 (winner and best depth, common.cuh
// walk_column), the winner's surface point (y, z, entity) as
// ops/trace.py::decode_winner gives it, with background taking entity 0 and
// y = z = 0 (quirk Q6), the light geometry of ops/shade.py::light_geometry,
// and the 7-phase DDA march of kernel 2 (common.cuh march_occluded).  Every
// pixel is marched, background included, so `lit` equals the plain version
// on every pixel.
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
// What bounds it on the H100: not bytes.  A pixel writes 5 B (winner,
// lit) and the tables are read once per block from L2; the time goes to
// the divergent per-pixel march (a data-dependent loop of up to
// 7 * largest phases whose slot tests gather 24 B boxes scattered over the
// entity arrays) and to the candidate walk's gathers of sprite depths.
//
// What the design does about it: one block per (frame, bin column), as in
// kernel 1.  The block stages in shared memory both the column's
// hash_l * cap candidates (2 KB) and the frame's whole bin table
// (V * (cap + 1) ints, 27 KB for graybox), so the walk and every bin probe
// of the march read shared memory; only the box bounds of tested slots and
// the sprite depths come from global memory (L1/L2-resident).  The picks,
// the G-buffer fields and the ray inputs never leave registers: the TPU
// kernel's packed picks, VMEM windows, membership tables, candidate lists,
// divkernel division and sz-hull reduction have no counterpart.
#include "common.cuh"

namespace {

__global__ void fused_trace_shadow_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ sprite_id, const int* __restrict__ atlas_depth,
    const int* __restrict__ bins_ent, const int* __restrict__ counts,
    const int* __restrict__ players, const int* __restrict__ lights,
    int* __restrict__ winner_out, int* __restrict__ best_out,
    unsigned char* __restrict__ lit_out, par::Grid g, int sprite_w,
    int sprite_h, int early_exit) {
  extern __shared__ int smem[];
  int* s_bins = smem;                                // (V, cap)
  int* s_cnt = s_bins + g.volume() * g.bin_cap;      // (V,)
  int* s_col_cnt = s_cnt + g.volume();               // (hash_l,)
  int* s_fld = s_col_cnt + g.hash_l;                 // (hash_l * cap, kFields)

  const int f = blockIdx.y;
  const int column = blockIdx.x;  // bin_x * hash_h + bin_y
  const int bin_x = column / g.hash_h;
  const int bin_y = column % g.hash_h;
  par::stage_frame_table(bins_ent, counts, f, g, s_bins, s_cnt);
  par::stage_column(pos, ext, sprite_id, bins_ent, counts, players, f,
                    column, g, s_col_cnt, s_fld);
  __syncthreads();

  const int lx = lights[3 * f];
  const int ly = lights[3 * f + 1];
  const int lz = lights[3 * f + 2];
  const int bs = g.bin_size;
  const int lbx = lx / bs;
  const int lby = (g.view_h - ly - lz) / bs;
  const int lbz = lz / bs;

  const int n_pix = bs * bs;
  for (int q = threadIdx.x; q < n_pix; q += blockDim.x) {
    const int i = bin_x * bs + q % bs;
    const int j = bin_y * bs + q / bs;
    if (i >= g.view_w || j >= g.view_h) continue;
    const int world_j = g.view_h - j;
    const par::Hit h = par::walk_column(s_col_cnt, s_fld, atlas_depth, i,
                                        world_j, g, sprite_w, sprite_h,
                                        early_exit);

    // The winner's surface point (ops/trace.py::decode_winner).
    int ent = 0, y = 0, z = 0;
    if (h.slot >= 0) {
      const int* d = s_fld + h.slot * par::kFields;
      const int px = d[1], py = d[2], pz = d[3];
      const int ey = d[5], ez = d[6];
      const int row = py + ey + pz + ez - world_j;
      const int sdep = atlas_depth[par::texel_index(d[7], row, i - px,
                                                    sprite_w, sprite_h)];
      ent = d[0];
      y = py + ey + ez - row - sdep;
      z = pz + sdep;
    }

    // Light geometry (ops/shade.py::light_geometry).
    const float dx = static_cast<float>(lx) - static_cast<float>(i);
    const float dy = static_cast<float>(ly) - static_cast<float>(y);
    const float dz = static_cast<float>(lz) - static_cast<float>(z);
    const float length = fabsf(dx) + fabsf(dy) + fabsf(dz);
    const par::Ray r{i / bs,
                     (g.view_h - y - z) / bs,
                     z / bs,
                     static_cast<float>(i),
                     static_cast<float>(y),
                     static_cast<float>(z),
                     1.0f / (dx / length),
                     1.0f / (dy / length),
                     1.0f / (dz / length),
                     ent};
    const bool occluded = par::march_occluded(pos, ext, players, f, s_bins,
                                              s_cnt, g, r, lbx, lby, lbz);

    const size_t o =
        (static_cast<size_t>(f) * g.view_h + j) * g.view_w + i;
    winner_out[o] = h.slot >= 0 ? ent : -1;
    if (best_out != nullptr) best_out[o] = h.best;
    lit_out[o] = occluded ? 0 : 1;
  }
}

}  // namespace

// winner_out (F, H, W) int32; best_out the same shape or null; lit_out
// (F, H, W) uint8 (0/1).  Tables are bins_ent (F, V, cap) and counts (F, V);
// players (F, 3) is entity 0's position per frame and lights (F, 3) the
// point light per frame.  Returns cudaGetLastError() after the launch.
extern "C" int par_fused_trace_shadow(
    const void* pos, const void* ext, const void* sprite_id,
    const void* atlas_depth, const void* bins_ent, const void* counts,
    const void* players, const void* lights, void* winner_out,
    void* best_out, void* lit_out, int n_frames, int view_w, int view_h,
    int bin_size, int bin_cap, int hash_w, int hash_h, int hash_l,
    int sprite_w, int sprite_h, int early_exit, int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem =
      sizeof(int) * static_cast<size_t>(par::frame_table_ints(g)
                                        + par::column_ints(g));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_trace_shadow_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(hash_w * hash_h, n_frames);
  fused_trace_shadow_kernel<<<grid, threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(sprite_id),
      static_cast<const int*>(atlas_depth),
      static_cast<const int*>(bins_ent), static_cast<const int*>(counts),
      static_cast<const int*>(players), static_cast<const int*>(lights),
      static_cast<int*>(winner_out), static_cast<int*>(best_out),
      static_cast<unsigned char*>(lit_out), g, sprite_w, sprite_h,
      early_exit);
  return static_cast<int>(cudaGetLastError());
}
