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
// background included.
//
// Point mode (par_shadow_lit): the light bin is the frame's, and the march
// is exact for any light, with no table or reroute.  It takes an optional
// step cap: a ray probes 7 * min(int(largest), max_steps) phases, the
// statically bounded march of the JAX package's ops/shadow.py::trace_light
// (max_steps < 0 for none, as the render paths call it; the inverse
// fitter's soft_frame passes the renderer's shadow_max_steps).  A launch
// covers a window of whole bin rows of the view (all of them, or a row
// shard's, parallel/mesh.py), with per-pixel arrays of the window's rows.
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
// What bounds it on the H100: its bytes bound is the 41 B of ray inputs
// and 1 B of output a pixel in point mode (13 B in directional mode); it
// runs at a few times that.  Marched per pixel, as the reference does,
// each ray ran ~48 DDA phases, probed the same bins again and again (14-31
// distinct of ~40-56 probes on graybox) and gathered every tested box's
// 24 B from the entity arrays, in loops of different lengths within a
// warp.  What is left is the per-pixel slab tests and each block's short
// phases between barriers: collecting the keys, the DDA, staging the boxes.
//
// What the design does about it: a ray's probed bins depend only on its
// start bin, its light bin and the step cap, and a tile's pixels share few
// of them (hit pixels start at (i / bs, j / bs, z / bs); under a
// directional light each light-bin axis takes 2 or 3 values within a start
// bin).  So one block takes one (frame, bin-column tile) of bs x bs pixels
// and runs common.cuh march_tile over a table of keys: start bins
// (PointTable, 4 keys) or (start bin, light bin) pairs (DirectionalTable,
// 16 keys): one warp-parallel DDA per distinct key into a list of its
// distinct bins in first-visit order, the candidate boxes of those bins
// staged once in shared memory as float corners, and every pixel tests its
// key's boxes, neighbouring lanes running the same list.  A pixel whose key
// does not fit the tile's table marches on its own (march_occluded) and is
// counted in stats[kStatDirect].  Exact because the lit bit is an OR over
// the probed bins, which ignores order and repeats.  Under the step cap a
// list holds at most 7 * max_steps bins, which sizes the directional
// table's lists and a capped point table's.  The TPU kernel's per-tile
// candidate lists, membership words, extended start space and division
// helpers have no counterpart.
#include "common.cuh"

namespace {

// Per-pixel ray inputs of the point mode, each (F, H, W): the start bin,
// the float origin, the reciprocal direction (from ops/shade.light_geometry)
// and the pixel's own entity (from the G-buffer).
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
};

// Per-pixel inputs of the directional mode, each (F, H, W) int32: the
// G-buffer's surface point y, z and the pixel's own entity.
struct SurfacePixels {
  const int* y;
  const int* z;
  const int* self;
};

// The directional table's 6-int keys and 16 lists need more registers and
// shared memory than the point table's; 3 blocks of 320 threads leave 68
// registers a thread.
constexpr int kDirBlocksPerSM = 3;

__global__ void __launch_bounds__(par::kMarchThreads,
                                  par::kMarchBlocksPerSM)
shadow_lit_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, PixelRays rays,
    const int* __restrict__ light_bin, unsigned char* __restrict__ lit,
    int* __restrict__ stats, par::Grid g, int max_steps) {
  extern __shared__ __align__(16) int smem[];
  const int bs = g.bin_size;
  const par::MarchSmem<par::PointTable> s(smem, g, bs * bs, max_steps);

  const int f = blockIdx.y;
  const par::Band tile = par::Band::tile(g, blockIdx.x);
  auto index = [&](int i, int j) { return g.pixel(f, i, j); };
  auto key_of = [&](int, int i, int j) {
    const size_t o = index(i, j);
    return par::PointTable::Key{{rays.rbx[o], rays.rby[o], rays.rbz[o]}};
  };
  auto ray_of = [&](int, int i, int j) {
    const size_t o = index(i, j);
    return par::Ray{rays.rbx[o], rays.rby[o], rays.rbz[o],
                    rays.ox[o],  rays.oy[o],  rays.oz[o],
                    rays.ivx[o], rays.ivy[o], rays.ivz[o],
                    rays.self[o]};
  };
  par::march_tile(pos, ext, players, bins_ent, counts, f, g, tile,
                  make_int3(light_bin[3 * f], light_bin[3 * f + 1],
                            light_bin[3 * f + 2]),
                  max_steps, s, key_of, ray_of, lit, stats);
}

__global__ void __launch_bounds__(par::kMarchThreads, kDirBlocksPerSM)
shadow_dir_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, SurfacePixels px,
    const float* __restrict__ inv, const int* __restrict__ offsets,
    unsigned char* __restrict__ lit, int* __restrict__ stats, par::Grid g,
    int max_steps) {
  extern __shared__ __align__(16) int smem[];
  const int bs = g.bin_size;
  const par::MarchSmem<par::DirectionalTable> s(smem, g, bs * bs,
                                                max_steps);

  const int f = blockIdx.y;
  const par::Band tile = par::Band::tile(g, blockIdx.x);
  const int kx = offsets[3 * f], ky = offsets[3 * f + 1];
  const int kz = offsets[3 * f + 2];
  const float ivx = inv[3 * f], ivy = inv[3 * f + 1], ivz = inv[3 * f + 2];
  auto index = [&](int i, int j) { return g.pixel(f, i, j); };
  // (start bin, light bin) of the ray from surface point (i, y, z).
  auto key_of = [&](int, int i, int j) {
    const size_t o = index(i, j);
    const int y = px.y[o];
    const int z = px.z[o];
    return par::DirectionalTable::Key{
        {i / bs, (g.view_h - y - z) / bs, z / bs, (i + kx) / bs,
         (g.view_h - y - z - (ky + kz)) / bs, (z + kz) / bs}};
  };
  auto ray_of = [&](int, int i, int j) {
    const size_t o = index(i, j);
    const int y = px.y[o];
    const int z = px.z[o];
    return par::Ray{i / bs,
                    (g.view_h - y - z) / bs,
                    z / bs,
                    static_cast<float>(i),
                    static_cast<float>(y),
                    static_cast<float>(z),
                    ivx,
                    ivy,
                    ivz,
                    px.self[o]};
  };
  par::march_tile(pos, ext, players, bins_ent, counts, f, g, tile,
                  make_int3(0, 0, 0), max_steps, s, key_of, ray_of, lit,
                  stats);
}

size_t shadow_smem(const par::Grid& g, int max_steps) {
  return sizeof(int) * static_cast<size_t>(
      par::MarchSmem<par::PointTable>::ints(g, g.bin_size * g.bin_size,
                                            max_steps));
}

size_t dir_smem(const par::Grid& g, int max_steps) {
  return sizeof(int) * static_cast<size_t>(
      par::MarchSmem<par::DirectionalTable>::ints(
          g, g.bin_size * g.bin_size, max_steps));
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
// column of the window).  Returns cudaGetLastError().
extern "C" int par_shadow_lit(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* rbx,
    const void* rby, const void* rbz, const void* ox, const void* oy,
    const void* oz, const void* ivx, const void* ivy, const void* ivz,
    const void* start_ent, const void* light_bin, void* lit, void* stats,
    int n_frames, int view_w, int view_h, int bin_size, int bin_cap,
    int hash_w, int hash_h, int hash_l, int row_bin0, int bin_rows,
    int max_steps, int threads, void* stream) {
  const par::Grid g = par::Grid{view_w, view_h, bin_size, bin_cap, hash_w,
                                hash_h, hash_l}.window(row_bin0, bin_rows);
  const int cap = max_steps < 0 ? par::kNoStepCap : max_steps;
  const size_t smem = shadow_smem(g, cap);
  const int rc = allow_smem(shadow_lit_kernel, smem);
  if (rc != 0) return rc;
  const PixelRays rays{
      static_cast<const int*>(rbx),   static_cast<const int*>(rby),
      static_cast<const int*>(rbz),   static_cast<const float*>(ox),
      static_cast<const float*>(oy),  static_cast<const float*>(oz),
      static_cast<const float*>(ivx), static_cast<const float*>(ivy),
      static_cast<const float*>(ivz), static_cast<const int*>(start_ent)};
  const dim3 grid(hash_w * bin_rows, n_frames);
  shadow_lit_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), rays,
      static_cast<const int*>(light_bin), static_cast<unsigned char*>(lit),
      static_cast<int*>(stats), g, cap);
  return static_cast<int>(cudaGetLastError());
}

// The directional mode.  lit (F, H, W) uint8 (0/1); y, z, start_ent
// (F, H, W) int32 (the G-buffer's surface point and entity); inv (F, 3)
// float32 the reciprocal direction and offsets (F, 3) int32 the far-light
// offsets K of each frame (ops/shadow_dir.direction_constants); max_steps
// >= 0 the step cap; the rest as for par_shadow_lit.  Returns
// cudaGetLastError().
extern "C" int par_shadow_dir_lit(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* y, const void* z,
    const void* start_ent, const void* inv, const void* offsets, void* lit,
    void* stats, int n_frames, int view_w, int view_h, int bin_size,
    int bin_cap, int hash_w, int hash_h, int hash_l, int max_steps,
    int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = dir_smem(g, max_steps);
  const int rc = allow_smem(shadow_dir_kernel, smem);
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
      static_cast<int*>(stats), g, max_steps);
  return static_cast<int>(cudaGetLastError());
}

// Shared bytes of one block, the blocks one SM holds at `threads` threads,
// registers a thread and local (stack and spill) bytes a thread, into
// out[0..3].  Returns the CUDA error code.
extern "C" int par_shadow_occupancy(int view_w, int view_h, int bin_size,
                                    int bin_cap, int hash_w, int hash_h,
                                    int hash_l, int threads, int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(shadow_lit_kernel, shadow_smem(g, par::kNoStepCap),
                   threads, out);
}

// The same for the directional mode under step cap max_steps.
extern "C" int par_shadow_dir_occupancy(int view_w, int view_h, int bin_size,
                                        int bin_cap, int hash_w, int hash_h,
                                        int hash_l, int threads,
                                        int max_steps, int* out) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  return occupancy(shadow_dir_kernel, dir_smem(g, max_steps), threads, out);
}
