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
// What the design does about it: one block per (frame, bin column, band
// of the walk's rows: common.cuh Grid::band_rows, the most rows whose
// pixels fit kBandPixels).  The walk is kernel 1's (common.cuh
// walk_column: the column's live slots drawn in walk order over their
// footprints into per-pixel state in shared memory); then the band's
// pixels take common.cuh march_band, the point march of shadow.cu's point
// modes, with the walk as its pixel source (WalkRays).  The walk's state
// lives in three of the march's per-pixel arrays (y, z, entity), which
// then hold each pixel's surface point, its draw list in the march's head
// (ShadeSmem's reserve: the walk ends before the march begins) and the
// column's staged candidates after the march's memory, since the source
// reads them while the march runs.  The surface point comes from the best
// key without a second atlas read (sdep = py - pz + min(0, ey - row)
// - best).  A hit pixel starts its shadow ray in bin (i / bs, j / bs,
// z / bs), since y + z equals its world row, and a background pixel in
// (i / bs, view_h / bs, 0), so the band's pixels share one or two start
// bins; the light geometry is computed from the surface point when the
// pixel is loaded.  Pixels whose start bin does not fit the table of
// kShadeKeys march on their own (stats[kStatDirect]).  Exact because the
// lit bit is an OR over the probed bins, which depend only on (start bin,
// light bin), for any set of pixels.
// The TPU kernel's packed picks, VMEM windows, membership tables, candidate
// lists, divkernel division and sz-hull reduction have no counterpart.
#include "common.cuh"

namespace {

// Bytes of the draw list (common.cuh draw_ints), which the march's head
// holds during the walk.
__host__ __device__ size_t draw_bytes(const par::Grid& g) {
  return sizeof(int) * static_cast<size_t>(par::draw_ints(g));
}

// Bytes of the march's memory, up to a multiple of 4: the column's staged
// candidates follow.
__host__ __device__ size_t march_bytes(const par::Grid& g, int chunk) {
  return (par::ShadeSmem::bytes(g, g.band_pixels(), chunk, draw_bytes(g))
          + 3) / 4 * 4;
}

// march_band's source of the fused kernel: each pixel's winner and surface
// point (ops/trace.py::decode_winner) from the walk's state of the same
// pixel (best depth in s.y, slot in s.z) and the column's staged fields,
// written to winner_out and best_out and, over that state, into s.y, s.z
// and s.self; then the light geometry (ops/shade.py::light_geometry).
// Only the thread of pixel q reads and writes q.  Its store writes the lit
// bit.
struct WalkRays : par::SurfaceRays {
  const int* fld;
  int f;
  int3 light;
  int* winner_out;
  int* best_out;
  unsigned char* lit;
  static constexpr int max_steps = par::kNoStepCap;

  __device__ void load(const par::ShadeSmem& s, const par::Grid& g, int q,
                       int i, int j) const {
    const int best = s.y[q];
    const int slot = s.z[q];
    int ent = 0, y = 0, z = 0;
    if (slot >= 0) {
      const int* d = fld + slot * par::kFields;
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
    s.y[q] = y;
    s.z[q] = z;
    s.self[q] = ent;
    const size_t o = g.pixel(f, i, j);
    winner_out[o] = slot >= 0 ? ent : -1;
    if (best_out != nullptr) best_out[o] = best;
    const float3 tl = par::towards_light(i, y, z, light);
    s.ivx[q] = 1.0f / tl.x;
    s.ivy[q] = 1.0f / tl.y;
    s.ivz[q] = 1.0f / tl.z;
  }
  __device__ void store(const par::ShadeSmem&, const par::Grid& g, int,
                        int i, int j, bool occluded) const {
    lit[g.pixel(f, i, j)] = occluded ? 0 : 1;
  }
};

__global__ void __launch_bounds__(par::kMarchThreads,
                                  par::kMarchBlocksPerSM)
fused_trace_shadow_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ sprite_id, const int* __restrict__ atlas_depth,
    const int* __restrict__ bins_ent, const int* __restrict__ counts,
    const int* __restrict__ players, const int* __restrict__ lights,
    int* __restrict__ winner_out, int* __restrict__ best_out,
    unsigned char* __restrict__ lit_out, int* __restrict__ stats,
    par::Grid g, int sprite_w, int sprite_h, int early_exit, int chunk) {
  extern __shared__ __align__(16) int smem[];
  const par::Band b = par::Band::of_block(g);
  if (b.j0(g) >= g.view_h) return;  // the band lies below the view
  const par::ShadeSmem s(smem, g, g.band_pixels(), chunk, draw_bytes(g));
  int* s_col = smem + march_bytes(g, chunk) / sizeof(int);
  par::WalkSmem w;
  w.cnt = s_col;
  w.fld = s_col + g.hash_l;
  w.draw = smem;
  w.best = s.y;
  w.slot = s.z;
  w.hits = s.self;

  const int f = blockIdx.y;
  par::walk_column(pos, ext, sprite_id, atlas_depth, bins_ent, counts,
                   players, f, b, g, sprite_w, sprite_h, early_exit, w);
  const int3 light = make_int3(lights[3 * f], lights[3 * f + 1],
                               lights[3 * f + 2]);
  const WalkRays src{{}, w.fld, f, light, winner_out, best_out, lit_out};
  par::march_band<false>(pos, ext, players, bins_ent, counts, f, g, b,
                         par::light_bin(light, g), src.max_steps, s, chunk,
                         src, stats, nullptr);
}

size_t fused_smem(const par::Grid& g, int chunk) {
  return march_bytes(g, chunk)
         + sizeof(int) * static_cast<size_t>(par::column_ints(g));
}

}  // namespace

// winner_out (F, H, W) int32; best_out the same shape or null; lit_out
// (F, H, W) uint8 (0/1).  Tables are bins_ent (F, V, cap) and counts (F, V);
// players (F, 3) is entity 0's position per frame and lights (F, 3) the
// point light per frame; stats (3,) int32 device counters (common.cuh
// MarchStat), added to.  One block of `threads` per (bin column, band) and
// frame; chunk >= kShadeKeys list entries staged at once.  Returns
// cudaGetLastError() after the launch.
extern "C" int par_fused_trace_shadow(
    const void* pos, const void* ext, const void* sprite_id,
    const void* atlas_depth, const void* bins_ent, const void* counts,
    const void* players, const void* lights, void* winner_out,
    void* best_out, void* lit_out, void* stats, int n_frames, int view_w,
    int view_h, int bin_size, int bin_cap, int hash_w, int hash_h,
    int hash_l, int sprite_w, int sprite_h, int early_exit, int chunk,
    int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = fused_smem(g, chunk);
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
      sprite_w, sprite_h, early_exit, chunk);
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes of one block, the blocks one SM holds at `threads` threads,
// registers a thread and local (stack and spill) bytes a thread, into
// out[0..3], with chunks of `chunk` list entries.  Returns the CUDA error
// code.
extern "C" int par_fused_occupancy(int view_w, int view_h, int bin_size,
                                   int bin_cap, int hash_w, int hash_h,
                                   int hash_l, int threads, int chunk,
                                   int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = fused_smem(g, chunk);
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
