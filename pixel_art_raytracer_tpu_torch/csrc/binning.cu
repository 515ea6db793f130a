// The spatial hash's tables on the card, with no sort and no host wait: the
// full rebin of every entity, and the per-frame merge of the few dynamic
// entities into the static cache.
//
// The full rebin replaces no TPU kernel: the JAX package bins with XLA's
// sort (pixel_art_raytracer_tpu/ops/binning.py), and the port's plain
// version (ops/binning.py `ranked_pairs`, `plain_tables`) enumerates
// (entity, bin) pairs over a static offset grid, stable-sorts them, ranks
// them with a scan and sizes the totals with `bincount`, which makes the
// host wait.  On the card that chain ran ~7.6 ms a frame on graybox
// (162,308 boxes, 1.95 M pairs; the scan on one SM), while the work is
// bound by reading each box once: 162,308 x 24 B = 3.9 MB, 1.2 us at
// 3.35 TB/s.
//
// Semantics, those of `covered_bins` + `ranked_pairs`: the cull
// (alternative.cpp:212-219); each axis's covered range with C-truncating
// division, clamped to the grid and clipped to `span` bins past its first,
// as the offset grid clips it; an entity covers a bin at most once, so its
// rank in a bin is the number of covering entities of smaller index; the
// wrap at capacity (quirk Q3) keeps the last ranks.
//
// Two launches, no host wait (the outputs' sizes are static):
//   count  one block per (chunk of kChunk entities, frame, tile of at most
//          kTileBins bins) enumerates each entity's covered bins straight
//          from its bounds into a histogram of the tile's bins in shared
//          memory, and a mask a bin of the chunk's 32-entity groups that
//          cover it; both go to scratch (2, F, B, V).  Tiles keep a block's
//          shared memory at 64 KB whatever V is; a grid of at most
//          kTileBins bins (every grid the benchmark runs) is one tile.
//   place  one warp per (bin, frame) sums its bin's column of chunk counts
//          for the total, walks the chunks from the last with a suffix
//          scan, and re-reads, in the chunks that hold one of the last
//          `window` ranks, only the groups its masks name, from the last:
//          a ballot on "covers this bin" and a popcount give each entity's
//          rank.
// The boxes stay in L2 (50 MB) between the passes.
//
// Output layouts, by `ring`: 1 is build_bins' table (window a power of two,
// the bin capacity there): rank r in slot r & (window - 1), count
// total & (window - 1);
// 0 is the static cache's: the kept ranks left-aligned, count the total.
// Empty slots are -1 in both.
//
// The merge (`bin_merge_kernel`, ops/static_bins.py `StaticBins.merge`)
// replaces no TPU kernel either: the JAX package merges with XLA select
// chains, and the port's plain version is a chain of ~50 tensor ops (~115
// launches a call on the card, and an upload of the offset grid that makes
// the host wait for the stream).  Its work is its writes: each frame's
// (V, cap) table and (V,) counts, F * V * (cap + 1) * 4 B (1.77 MB on
// graybox at F = 64, 0.53 us at 3.35 TB/s).  One launch, one thread per
// (frame, bin): the block's frame puts its dynamic entities' covered
// ranges (`cover_box`, the count pass's) in shared memory; a bin no
// dynamic entity covers copies the cache's static-only row in 16-byte
// stores; a covered bin applies the rank arithmetic of the wrap to its
// stored static entries (ranks shifted by the dynamic entries in front of
// them) and then its dynamic entries (rank k for the k-th covering one).
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullWarp = 0xFFFFFFFFu;
// Entities a count block takes: 32 groups of 32, one bit each in a mask.
constexpr int kChunk = 1024;
// Bins a count block holds: a count and a group mask each, 64 KB.
constexpr int kTileBins = 8192;
constexpr int kCountThreads = 256;
constexpr int kPlaceWarps = 8;
constexpr int kMergeThreads = 256;
// Dynamic entities a merge takes: one bit each in a bin's mask word.
constexpr int kMaxDynamic = 32;

struct BinGrid {
  int view_w, view_h, view_l, bin_size;
  int hash_w, hash_h, hash_l;
  int span_x, span_y, span_z;
  __device__ int volume() const { return hash_w * hash_h * hash_l; }
};

// Half-open covered bin ranges of one entity; empty when culled.
struct Cover {
  int x0, x1, y0, y1, z0, z1;
  __device__ bool holds(int bx, int by, int bz) const {
    return bx >= x0 && bx < x1 && by >= y0 && by < y1 && bz >= z0 &&
           bz < z1;
  }
};

// ops/binning.py covered_bins of one box at (px, py, pz) with extents
// (ex, ey, ez).
__device__ Cover cover_box(int px, int py, int pz, int ex, int ey, int ez,
                           const BinGrid& g) {
  const int bs = g.bin_size, vh = g.view_h;
  const int qx = px + ex, qy = py + ey, qz = pz + ez;
  const bool culled = qx < 0 || px >= g.view_w || qy < -qz ||
                      py >= vh - pz + bs || qz < -ez - bs ||
                      pz > g.view_l + bs;
  Cover c;
  c.x0 = max(px / bs, 0);
  c.y0 = max((vh - qy - qz) / bs, 0);
  c.z0 = max(pz / bs, 0);
  c.x1 = min(min((qx + bs - 1) / bs, g.hash_w), c.x0 + g.span_x);
  c.y1 = min(min((vh - py - pz + bs - 1) / bs, g.hash_h), c.y0 + g.span_y);
  c.z1 = min(min((qz + bs - 1) / bs, g.hash_l), c.z0 + g.span_z);
  if (culled) c.x1 = c.x0;
  return c;
}

// Entity e of frame f: entity 0 takes players[f] where players is given.
__device__ Cover cover(const int* pos, const int* ext, const int* players,
                       int f, int e, const BinGrid& g) {
  const int* p = (e == 0 && players != nullptr)
                     ? players + 3 * f
                     : pos + 3 * static_cast<size_t>(e);
  const int* x = ext + 3 * static_cast<size_t>(e);
  return cover_box(p[0], p[1], p[2], x[0], x[1], x[2], g);
}

__global__ void __launch_bounds__(kCountThreads)
bin_count_kernel(const int* __restrict__ pos, const int* __restrict__ ext,
                 const int* __restrict__ players, int n, BinGrid g,
                 int* __restrict__ chunk_counts,
                 unsigned* __restrict__ chunk_groups) {
  extern __shared__ int hist[];  // the tile's counts, then its group masks
  const int V = g.volume();
  const int tile = min(V, kTileBins);  // the shared arrays' length
  const int t0 = blockIdx.z * kTileBins;
  const int tn = min(kTileBins, V - t0);  // bins [t0, t0 + tn) here
  unsigned* groups = reinterpret_cast<unsigned*>(hist + tile);
  const int b = blockIdx.x, f = blockIdx.y;
  for (int v = threadIdx.x; v < 2 * tile; v += blockDim.x) hist[v] = 0;
  __syncthreads();
  const int e_end = min(n, (b + 1) * kChunk);
  for (int e = b * kChunk + threadIdx.x; e < e_end; e += blockDim.x) {
    const Cover c = cover(pos, ext, players, f, e, g);
    if (c.x1 <= c.x0 || c.y1 <= c.y0 || c.z1 <= c.z0) continue;
    // Bin indices grow with (bx, by, bz): skip an entity outside the tile.
    const int lo = (c.x0 * g.hash_h + c.y0) * g.hash_l + c.z0;
    const int hi = ((c.x1 - 1) * g.hash_h + c.y1 - 1) * g.hash_l + c.z1 - 1;
    if (hi < t0 || lo >= t0 + tn) continue;
    const unsigned group = 1u << ((e - b * kChunk) >> 5);
    for (int bx = c.x0; bx < c.x1; ++bx)
      for (int by = c.y0; by < c.y1; ++by)
        for (int bz = c.z0; bz < c.z1; ++bz) {
          const int v = (bx * g.hash_h + by) * g.hash_l + bz - t0;
          if (v < 0 || v >= tn) continue;
          atomicAdd(&hist[v], 1);
          atomicOr(&groups[v], group);
        }
  }
  __syncthreads();
  const size_t o = (static_cast<size_t>(f) * gridDim.x + b) * V + t0;
  for (int v = threadIdx.x; v < tn; v += blockDim.x) {
    chunk_counts[o + v] = hist[v];
    chunk_groups[o + v] = groups[v];
  }
}

__global__ void __launch_bounds__(kPlaceWarps * 32)
bin_place_kernel(const int* __restrict__ pos, const int* __restrict__ ext,
                 const int* __restrict__ players, int n, int n_chunks,
                 BinGrid g, const int* __restrict__ chunk_counts,
                 const unsigned* __restrict__ chunk_groups, int window,
                 int ring, int id_offset, int* __restrict__ ids,
                 int* __restrict__ counts) {
  const int V = g.volume();
  const int lane = threadIdx.x & 31;
  const int v = blockIdx.x * kPlaceWarps + (threadIdx.x >> 5);
  const int f = blockIdx.y;
  if (v >= V) return;  // the whole warp
  const int bx = v / (g.hash_h * g.hash_l);
  const int by = (v / g.hash_l) % g.hash_h;
  const int bz = v % g.hash_l;

  // This bin's column of chunk counts and group masks: chunk b at b * V.
  const size_t col = static_cast<size_t>(f) * n_chunks * V + v;
  const int* cc = chunk_counts + col;
  const unsigned* cg = chunk_groups + col;
  int part = 0;
  for (int b = lane; b < n_chunks; b += 32)
    part += cc[static_cast<size_t>(b) * V];
  const int total = __reduce_add_sync(kFullWarp, part);
  const int kept = min(total, window);
  const int first = total - kept;  // the lowest kept rank

  int* out = ids + (static_cast<size_t>(f) * V + v) * window;
  for (int s = kept + lane; s < window; s += 32) out[s] = -1;
  if (lane == 0) counts[static_cast<size_t>(f) * V + v] =
      ring ? (total & (window - 1)) : total;

  // Chunks from the last, 32 a round (lane l: chunk hi - l); `after` is the
  // entries of the chunks above this round.
  int after = 0;
  for (int hi = n_chunks - 1; hi >= 0 && after < kept; hi -= 32) {
    const int b = hi - lane;
    const int c = b >= 0 ? cc[static_cast<size_t>(b) * V] : 0;
    const unsigned mask = b >= 0 ? cg[static_cast<size_t>(b) * V] : 0u;
    int upto = c;  // entries of chunks b .. hi
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFullWarp, upto, d);
      if (lane >= d) upto += y;
    }
    const int base = total - after - upto;  // rank of chunk b's first entry
    // Chunk b holds ranks [base, base + c): needed where one is kept.
    unsigned need = __ballot_sync(kFullWarp, c > 0 && base + c > first);
    while (need) {
      const int l = __ffs(need) - 1;
      need &= need - 1;
      const int cb = hi - l;
      const int top = __shfl_sync(kFullWarp, base + c, l);  // past its last
      const int low = max(__shfl_sync(kFullWarp, base, l), first);
      unsigned groups = __shfl_sync(kFullWarp, mask, l);
      // The named groups from the last; lane j tests a group's entity
      // 31 - j, so lower lanes hold later entities.
      int found = 0;
      while (groups != 0u && found < top - low) {
        const int group = 31 - __clz(groups);
        groups ^= 1u << group;
        const int e = cb * kChunk + group * 32 + 31 - lane;
        const bool hit =
            e < n && cover(pos, ext, players, f, e, g).holds(bx, by, bz);
        const unsigned m = __ballot_sync(kFullWarp, hit);
        if (hit) {
          const int rank = top - 1 - found - __popc(m & ((1u << lane) - 1u));
          if (rank >= first)
            out[ring ? (rank & (window - 1)) : rank - first] = e + id_offset;
        }
        found += __popc(m);
      }
    }
    after += __shfl_sync(kFullWarp, upto, 31);
  }
}

// Element strides of a (frames, dynamic entities, 3) int32 view.
struct Strides {
  int frame, entity, axis;
};

// A row of n ints: 16-byte stores where n and both rows allow them.
__device__ void copy_row(int* __restrict__ dst, const int* __restrict__ src,
                         int n) {
  if ((n & 3) == 0 &&
      ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<int4*>(dst + i) =
          *reinterpret_cast<const int4*>(src + i);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = src[i];
  }
}

__device__ void fill_row(int* dst, int value, int n) {
  if ((n & 3) == 0 && (reinterpret_cast<size_t>(dst) & 15) == 0) {
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<int4*>(dst + i) = make_int4(value, value, value,
                                                    value);
  } else {
    for (int i = 0; i < n; ++i) dst[i] = value;
  }
}

// ops/static_bins.py StaticBins.plain_merge: one thread per (frame, bin),
// blocks of kMergeThreads bins of one frame (blockIdx.x = frame * tiles +
// tile).  static_ids holds a bin's last cap + n_dynamic static entries
// left-aligned (-1 past them), bins_static and counts_static the merge
// where no dynamic entity covers the bin.
__global__ void __launch_bounds__(kMergeThreads)
bin_merge_kernel(const int* __restrict__ dyn_pos, Strides ps,
                 const int* __restrict__ dyn_ext, Strides es, int n_dynamic,
                 BinGrid g, int cap, const int* __restrict__ static_total,
                 const int* __restrict__ static_ids,
                 const int* __restrict__ bins_static,
                 const int* __restrict__ counts_static,
                 int* __restrict__ bins_ent, int* __restrict__ counts) {
  __shared__ Cover covers[kMaxDynamic];
  const int V = g.volume();
  const int tiles = (V + kMergeThreads - 1) / kMergeThreads;
  const int f = blockIdx.x / tiles;
  const int v = (blockIdx.x % tiles) * kMergeThreads + threadIdx.x;
  if (threadIdx.x < n_dynamic) {
    const int d = threadIdx.x;
    const int* p = dyn_pos + static_cast<size_t>(f) * ps.frame +
                   static_cast<size_t>(d) * ps.entity;
    const int* x = dyn_ext + static_cast<size_t>(f) * es.frame +
                   static_cast<size_t>(d) * es.entity;
    covers[d] = cover_box(p[0], p[ps.axis], p[2 * ps.axis], x[0],
                          x[es.axis], x[2 * es.axis], g);
  }
  __syncthreads();
  if (v >= V) return;
  const int bx = v / (g.hash_h * g.hash_l);
  const int by = (v / g.hash_l) % g.hash_h;
  const int bz = v % g.hash_l;
  unsigned mask = 0u;  // bit d: dynamic entity d covers this bin
  for (int d = 0; d < n_dynamic; ++d)
    if (covers[d].holds(bx, by, bz)) mask |= 1u << d;
  const size_t row = static_cast<size_t>(f) * V + v;
  int* out = bins_ent + row * cap;
  if (mask == 0u) {
    copy_row(out, bins_static + static_cast<size_t>(v) * cap, cap);
    counts[row] = counts_static[v];
    return;
  }
  // The dynamic entries come first in the bin's insertion order: a stored
  // static entry's rank is its static rank plus the n_dyn in front of it.
  const int n_dyn = __popc(mask);
  const int window = cap + n_dynamic;
  const int* stored = static_ids + static_cast<size_t>(v) * window;
  int stored_len = 0;
  for (int i = 0; i < window; ++i) stored_len += stored[i] >= 0;
  const int total = static_total[v] + n_dyn;
  const int first = total - cap;  // the lowest rank the wrap keeps
  const int base = static_total[v] - stored_len + n_dyn;
  fill_row(out, -1, cap);
  for (int i = 0; i < window; ++i)
    if (stored[i] >= 0 && base + i >= first)
      out[(base + i) & (cap - 1)] = stored[i];
  int rank = 0;
  for (unsigned m = mask; m != 0u; m &= m - 1u, ++rank)
    if (rank >= first) out[rank & (cap - 1)] = __ffs(m) - 1;
  counts[row] = total & (cap - 1);
}

}  // namespace

// Bin tables of n entities (pos, ext (n, 3) int32) in n_frames frames:
// entity 0 at players[f] ((F, 3) int32) where players is not null.
// chunk_counts is scratch of (2, F, ceil(n / 1024) at least 1, V) int32;
// ids (F, V, window) and counts (F, V) int32 are written whole, ids as
// entity index + id_offset.  Two launches on `stream`; returns
// cudaGetLastError().
extern "C" int par_bin_tables(
    const void* pos, const void* ext, const void* players,
    void* chunk_counts, void* ids, void* counts, int n, int n_frames,
    int view_w, int view_h, int view_l, int bin_size, int hash_w,
    int hash_h, int hash_l, int span_x, int span_y, int span_z, int window,
    int ring, int id_offset, void* stream) {
  const BinGrid g{view_w, view_h, view_l, bin_size, hash_w, hash_h, hash_l,
                  span_x, span_y, span_z};
  const int V = hash_w * hash_h * hash_l;
  const int n_chunks = n > kChunk ? (n + kChunk - 1) / kChunk : 1;
  const int n_tiles = (V + kTileBins - 1) / kTileBins;
  const size_t smem = 2 * sizeof(int) * (V < kTileBins ? V : kTileBins);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bin_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  const int* x = static_cast<const int*>(ext);
  const int* pl = static_cast<const int*>(players);
  int* cc = static_cast<int*>(chunk_counts);
  unsigned* cg = reinterpret_cast<unsigned*>(
      cc + static_cast<size_t>(n_frames) * n_chunks * V);
  bin_count_kernel<<<dim3(n_chunks, n_frames, n_tiles), kCountThreads, smem,
                     s>>>(p, x, pl, n, g, cc, cg);
  bin_place_kernel<<<dim3((V + kPlaceWarps - 1) / kPlaceWarps, n_frames),
                     kPlaceWarps * 32, 0, s>>>(
      p, x, pl, n, n_chunks, g, cc, cg, window, ring, id_offset,
      static_cast<int*>(ids), static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// Each frame's tables of the static cache with its n_dynamic (1 to 32)
// dynamic entities merged in: ops/static_bins.py StaticBins.plain_merge.
// dyn_pos, dyn_ext are (n_frames, n_dynamic, 3) int32 at the given element
// strides (an expanded view reads as it is); static_total (V,),
// static_ids (V, cap + n_dynamic), bins_static (V, cap), counts_static
// (V,) int32 the cache's.  bins_ent (F, V, cap) and counts (F, V) int32
// are written whole.  One launch on `stream`; returns cudaGetLastError().
extern "C" int par_bin_merge(
    const void* dyn_pos, const void* dyn_ext, const void* static_total,
    const void* static_ids, const void* bins_static,
    const void* counts_static, void* bins_ent, void* counts, int n_frames,
    int n_dynamic, int pos_frame, int pos_entity, int pos_axis,
    int ext_frame, int ext_entity, int ext_axis, int view_w, int view_h,
    int view_l, int bin_size, int hash_w, int hash_h, int hash_l,
    int span_x, int span_y, int span_z, int cap, void* stream) {
  if (n_dynamic < 1 || n_dynamic > kMaxDynamic)
    return static_cast<int>(cudaErrorInvalidValue);
  const BinGrid g{view_w, view_h, view_l, bin_size, hash_w, hash_h, hash_l,
                  span_x, span_y, span_z};
  const int V = hash_w * hash_h * hash_l;
  const int tiles = (V + kMergeThreads - 1) / kMergeThreads;
  bin_merge_kernel<<<n_frames * tiles, kMergeThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(dyn_pos),
      Strides{pos_frame, pos_entity, pos_axis},
      static_cast<const int*>(dyn_ext),
      Strides{ext_frame, ext_entity, ext_axis}, n_dynamic, g, cap,
      static_cast<const int*>(static_total),
      static_cast<const int*>(static_ids),
      static_cast<const int*>(bins_static),
      static_cast<const int*>(counts_static), static_cast<int*>(bins_ent),
      static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}
