// Kernel 2: shadow occlusion — the lit mask of every (frame, pixel).
//
// Replaces: pixel_art_raytracer_tpu/ops/shadow_pallas.py::_shadow_kernel.
// Computes exactly ops/shadow.py::trace_light_dynamic of the port (and of
// the JAX package): each pixel's ray runs the reference's 7-phase thick DDA
// (x, y, z, xy, xz, yz, advance) from the pixel's bin toward the light's
// bin for 7 * int(largest) phases (alternative.cpp:399-500); every probed
// in-range flat bin other than the start bin tests its first `count`
// slots, skipping the pixel's own entity, with the slab test in the
// reference's std::min/std::max order; out-of-range flat bins are skipped
// and in-range aliased bins are used as they are.  Exact for any light:
// no step bound, table or reroute.  Every pixel is marched, background
// included.
//
// What bounds it on the H100: its bytes bound is the 41 B of ray inputs
// and 1 B of output a pixel; it runs at a few times that.  Marched per
// pixel, as the reference does, each ray ran ~48 DDA phases, probed the
// same bins again and again (14-31 distinct of ~40-56 probes on graybox)
// and gathered every tested box's 24 B from the entity arrays, in loops of
// different lengths within a warp.  What is left is the per-pixel slab
// tests and each block's short phases between barriers: collecting the
// start bins, the DDA, staging the boxes.
//
// What the design does about it: the probed bins depend only on the start
// bin and the light's bin, and a tile's pixels share one or two start bins
// (hit pixels start at (i / bs, j / bs, z / bs)).  So one block takes one
// (frame, bin-column tile) of bs x bs pixels and runs common.cuh
// march_tile: one warp-parallel DDA per distinct start bin into a list of
// its distinct bins in first-visit order, the candidate boxes of those bins
// staged once in shared memory as float corners, and every pixel tests its
// start's boxes, neighbouring lanes running the same list.  A pixel whose
// start bin does not fit the tile's table of kStarts marches on its own
// (march_occluded) and is counted in stats[kStatDirect].  Exact because
// the lit bit is an OR over the probed bins, which ignores order and
// repeats.  The TPU kernel's per-tile candidate lists, membership words and
// division helpers have no counterpart.
#include "common.cuh"

namespace {

// Per-pixel ray inputs, each (F, H, W): the start bin, the float origin, the
// reciprocal direction (from ops/shade.light_geometry) and the pixel's own
// entity (from the G-buffer).
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

__global__ void __launch_bounds__(par::kMarchThreads,
                                  par::kMarchBlocksPerSM)
shadow_lit_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, PixelRays rays,
    const int* __restrict__ light_bin, unsigned char* __restrict__ lit,
    int* __restrict__ stats, par::Grid g) {
  extern __shared__ __align__(16) int smem[];
  const int bs = g.bin_size;
  const par::MarchSmem s(smem, g, bs * bs);

  const int f = blockIdx.y;
  const int bin_x = blockIdx.x / g.hash_h;
  const int bin_y = blockIdx.x % g.hash_h;
  auto index = [&](int i, int j) {
    return (static_cast<size_t>(f) * g.view_h + j) * g.view_w + i;
  };
  auto key_of = [&](int, int i, int j) {
    const size_t o = index(i, j);
    return make_int3(rays.rbx[o], rays.rby[o], rays.rbz[o]);
  };
  auto ray_of = [&](int, int i, int j) {
    const size_t o = index(i, j);
    return par::Ray{rays.rbx[o], rays.rby[o], rays.rbz[o],
                    rays.ox[o],  rays.oy[o],  rays.oz[o],
                    rays.ivx[o], rays.ivy[o], rays.ivz[o],
                    rays.self[o]};
  };
  par::march_tile(pos, ext, players, bins_ent, counts, f, g, bin_x, bin_y,
                  light_bin[3 * f], light_bin[3 * f + 1],
                  light_bin[3 * f + 2], s, key_of, ray_of, lit, stats);
}

size_t shadow_smem(const par::Grid& g) {
  return sizeof(int) * static_cast<size_t>(
      par::MarchSmem::ints(g, g.bin_size * g.bin_size));
}

}  // namespace

// lit (F, H, W) uint8 (0/1).  The ten ray inputs are (F, H, W): start bin
// x/y/z int32, origin x/y/z and inverse direction x/y/z float32, own entity
// int32; light_bin (F, 3) int32; tables as for par_trace_winners; stats
// (3,) int32 device counters (common.cuh MarchStat), added to.  One block
// of `threads` per (frame, bin column).  Returns cudaGetLastError().
extern "C" int par_shadow_lit(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* rbx,
    const void* rby, const void* rbz, const void* ox, const void* oy,
    const void* oz, const void* ivx, const void* ivy, const void* ivz,
    const void* start_ent, const void* light_bin, void* lit, void* stats,
    int n_frames, int view_w, int view_h, int bin_size, int bin_cap,
    int hash_w, int hash_h, int hash_l, int threads, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem = shadow_smem(g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shadow_lit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const PixelRays rays{
      static_cast<const int*>(rbx),   static_cast<const int*>(rby),
      static_cast<const int*>(rbz),   static_cast<const float*>(ox),
      static_cast<const float*>(oy),  static_cast<const float*>(oz),
      static_cast<const float*>(ivx), static_cast<const float*>(ivy),
      static_cast<const float*>(ivz), static_cast<const int*>(start_ent)};
  const dim3 grid(hash_w * hash_h, n_frames);
  shadow_lit_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), rays,
      static_cast<const int*>(light_bin), static_cast<unsigned char*>(lit),
      static_cast<int*>(stats), g);
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
  const size_t smem = shadow_smem(g);
  out[0] = static_cast<int>(smem);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        shadow_lit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, shadow_lit_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[2] = attr.numRegs;
  out[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 1, shadow_lit_kernel, threads, smem));
}
