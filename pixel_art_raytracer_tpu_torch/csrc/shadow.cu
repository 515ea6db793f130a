// Kernel 2: shadow occlusion — the lit mask of every (frame, pixel).
//
// Replaces: pixel_art_raytracer_tpu/ops/shadow_pallas.py::_shadow_kernel.
// Computes exactly ops/shadow.py::trace_light_dynamic of the port (and of
// the JAX package): each thread marches its own pixel's ray with the
// reference's 7-phase thick DDA (x, y, z, xy, xz, yz, advance) from the
// pixel's bin toward the light's bin for 7 * int(largest) phases
// (alternative.cpp:399-500).  Every visited in-range flat bin other than
// the start bin tests its first `count` slots, skipping the pixel's own
// entity, with the slab test in the reference's std::min/std::max order;
// out-of-range flat bins are skipped and in-range aliased bins are used as
// they are.  The march is exact for any light, so there is no step bound,
// table or reroute.  Every pixel is marched, background included.
//
// What bounds it on the H100: latency, not bandwidth.  A pixel reads 40 B
// of inputs and writes 1 B, but its march is a data-dependent loop of up to
// 7 * largest phases, each probing one bin's slots and gathering the
// candidate boxes' bounds (24 B each, scattered over the 3.9 MB entity
// arrays) — dependent loads and divergent loop lengths within a warp.
//
// What the design does about it: the frame's whole bin table (V * cap + V
// ints, 27 KB for graybox) sits in shared memory, so every bin probe is a
// shared load; the entity arrays stay L2-resident and are read through L1;
// a thread stops at its first occluder.  Neighbouring threads march
// neighbouring pixels, whose rays run close together, so their probes and
// gathers mostly coincide.  The TPU kernel's per-tile candidate lists,
// membership words and division helpers have no counterpart.
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

__global__ void shadow_lit_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, PixelRays rays,
    const int* __restrict__ light_bin, unsigned char* __restrict__ lit,
    par::Grid g, int pix_per_block) {
  extern __shared__ int smem[];
  int* s_bins = smem;                           // (V, cap)
  int* s_cnt = smem + g.volume() * g.bin_cap;   // (V,)

  const int f = blockIdx.y;
  par::stage_frame_table(bins_ent, counts, f, g, s_bins, s_cnt);
  __syncthreads();

  const int hw = g.view_h * g.view_w;
  const int lbx = light_bin[3 * f];
  const int lby = light_bin[3 * f + 1];
  const int lbz = light_bin[3 * f + 2];
  const int p_begin = static_cast<int>(blockIdx.x) * pix_per_block;
  const int p_end = min(hw, p_begin + pix_per_block);

  for (int p = p_begin + static_cast<int>(threadIdx.x); p < p_end;
       p += blockDim.x) {
    const size_t o = static_cast<size_t>(f) * hw + p;
    const par::Ray r{rays.rbx[o], rays.rby[o], rays.rbz[o],
                     rays.ox[o],  rays.oy[o],  rays.oz[o],
                     rays.ivx[o], rays.ivy[o], rays.ivz[o],
                     rays.self[o]};
    lit[o] = par::march_occluded(pos, ext, players, f, s_bins, s_cnt, g, r,
                                 lbx, lby, lbz) ? 0 : 1;
  }
}

}  // namespace

// lit (F, H, W) uint8 (0/1).  The ten ray inputs are (F, H, W): start bin
// x/y/z int32, origin x/y/z and inverse direction x/y/z float32, own entity
// int32; light_bin (F, 3) int32; tables as for par_trace_winners.  Returns
// cudaGetLastError().
extern "C" int par_shadow_lit(
    const void* pos, const void* ext, const void* players,
    const void* bins_ent, const void* counts, const void* rbx,
    const void* rby, const void* rbz, const void* ox, const void* oy,
    const void* oz, const void* ivx, const void* ivy, const void* ivz,
    const void* start_ent, const void* light_bin, void* lit, int n_frames,
    int view_w, int view_h,
    int bin_size, int bin_cap, int hash_w, int hash_h, int hash_l,
    int threads, int pix_per_block, void* stream) {
  const par::Grid g{view_w, view_h, bin_size, bin_cap, hash_w, hash_h,
                    hash_l};
  const size_t smem =
      sizeof(int) * static_cast<size_t>(par::frame_table_ints(g));
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
  const int hw = view_w * view_h;
  const dim3 grid((hw + pix_per_block - 1) / pix_per_block, n_frames);
  shadow_lit_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<const int*>(ext),
      static_cast<const int*>(players), static_cast<const int*>(bins_ent),
      static_cast<const int*>(counts), rays,
      static_cast<const int*>(light_bin), static_cast<unsigned char*>(lit),
      g, pix_per_block);
  return static_cast<int>(cudaGetLastError());
}
