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

__device__ __forceinline__ bool slab_hit(const int* p, const int* x, float ox,
                                         float oy, float oz, float ivx,
                                         float ivy, float ivz) {
  const float x1 = (static_cast<float>(p[0]) - ox) * ivx;
  const float x2 = (static_cast<float>(p[0] + x[0]) - ox) * ivx;
  float lo = par::c_min(x1, x2);
  float hi = par::c_max(x1, x2);
  const float y1 = (static_cast<float>(p[1]) - oy) * ivy;
  const float y2 = (static_cast<float>(p[1] + x[1]) - oy) * ivy;
  lo = par::c_max(lo, par::c_min(y1, y2));
  hi = par::c_min(hi, par::c_max(y1, y2));
  const float z1 = (static_cast<float>(p[2]) - oz) * ivz;
  const float z2 = (static_cast<float>(p[2] + x[2]) - oz) * ivz;
  lo = par::c_max(lo, par::c_min(z1, z2));
  hi = par::c_min(hi, par::c_max(z1, z2));
  return hi >= lo;
}

__global__ void shadow_lit_kernel(
    const int* __restrict__ pos, const int* __restrict__ ext,
    const int* __restrict__ players, const int* __restrict__ bins_ent,
    const int* __restrict__ counts, PixelRays rays,
    const int* __restrict__ light_bin, unsigned char* __restrict__ lit,
    par::Grid g, int pix_per_block) {
  extern __shared__ int smem[];
  const int V = g.volume();
  const int cap = g.bin_cap;
  int* s_bins = smem;           // (V, cap)
  int* s_cnt = smem + V * cap;  // (V,)

  const int f = blockIdx.y;
  const int* f_bins = bins_ent + static_cast<size_t>(f) * V * cap;
  const int* f_cnt = counts + static_cast<size_t>(f) * V;
  for (int t = threadIdx.x; t < V * cap; t += blockDim.x) s_bins[t] = f_bins[t];
  for (int t = threadIdx.x; t < V; t += blockDim.x) s_cnt[t] = f_cnt[t];
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
    const int rbx = rays.rbx[o], rby = rays.rby[o], rbz = rays.rbz[o];
    const float ox = rays.ox[o], oy = rays.oy[o], oz = rays.oz[o];
    const float ivx = rays.ivx[o], ivy = rays.ivy[o], ivz = rays.ivz[o];
    const int self = rays.self[o];

    const float sx = static_cast<float>(rbx);
    const float sy = static_cast<float>(rby);
    const float sz = static_cast<float>(rbz);
    const float dx = static_cast<float>(lbx) - sx;
    const float dy = static_cast<float>(lby) - sy;
    const float dz = static_cast<float>(lbz) - sz;
    const float largest =
        par::c_max(par::c_max(fabsf(dx), fabsf(dy)), fabsf(dz));
    const float stx = dx / largest;
    const float sty = dy / largest;
    const float stz = dz / largest;
    const int n_phases = 7 * static_cast<int>(largest);
    const int start_flat = (rbx * g.hash_h + rby) * g.hash_l + rbz;

    bool occluded = false;
    float tx = sx, ty = sy, tz = sz;
    for (int t = 0; t < n_phases && !occluded; ++t) {
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
      const int bx = static_cast<int>(cx);
      const int by = static_cast<int>(cy);
      const int bz = static_cast<int>(cz);
      const int flat = (bx * g.hash_h + by) * g.hash_l + bz;
      if (flat < 0 || flat >= V || flat == start_flat) continue;
      const int n = min(s_cnt[flat], cap);
      for (int k = 0; k < n; ++k) {
        const int e = s_bins[flat * cap + k];
        if (e == self) continue;
        const int es = e >= 0 ? e : 0;
        if (slab_hit(par::entity_pos(pos, players, f, es),
                     ext + 3 * static_cast<size_t>(es), ox, oy, oz, ivx, ivy,
                     ivz)) {
          occluded = true;
          break;
        }
      }
    }
    lit[o] = occluded ? 0 : 1;
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
      sizeof(int) * static_cast<size_t>(g.volume()) * (bin_cap + 1);
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
