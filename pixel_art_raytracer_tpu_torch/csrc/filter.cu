// The box filter of supersampled frames on the card: the truncated mean of
// each s x s block of (F, H s, W s, 3) uint8 frames, (F, H, W, 3) uint8, in
// one launch with no host wait.
//
// It replaces no TPU kernel: the JAX package filters one frame with XLA's
// reduce (models/supersample.py `box_filter` there), and the port's plain
// version (models/supersample.py `box_filter`) is a chain of eager ops
// through a float32 copy of the frames: at config 5's batch (F = 64,
// 2048**2 traced) a 3.2 GB temporary and ~10.7 GB of traffic.  The work is
// bound by reading each traced byte once and writing each filtered byte
// once, F (H s)(W s) 3 + F H W 3 bytes: 1.0 GB there, 0.30 ms at 3.35 TB/s.
//
// Exactness: the plain version truncates float32(sum) / float32(s * s), a
// correctly rounded quotient of a sum of s * s bytes; for every sum up to
// 255 s**2 that is sum / (s * s) in integers (tests/test_torch_supersample.py
// checks every sum for s = 1 to 4), which the kernel computes.
//
// Layout: filtered row r (of F H) is the mean of traced rows r s to
// r s + s - 1, which follow each other in memory.  One block per tile of
// `rows` filtered rows by `width` filtered pixels (tile_of: about 768 traced
// bytes a row segment, about 12 KB of them a block):
//   stage   the tile's rows * s traced row segments into shared memory, each
//           as the 16-byte aligned words that cover it (a word that holds a
//           byte of the frames lies inside their allocation), so every load
//           is a 16-byte one whatever the width or the frame's offset;
//   reduce  one thread a filtered pixel sums its s x s pixels from shared
//           memory and stores the three quotients: a warp's pixels are 32
//           consecutive ones of a row, so its stores cover 96 consecutive
//           bytes; its index arithmetic is done once a thread, not once a
//           byte.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Traced bytes a row segment of a tile holds, and a block stages.
constexpr int kSegmentBytes = 768;
constexpr int kStageBytes = 12 * 1024;
// 16-byte words a thread loads before it stores them: a tile of
// kStageBytes, and the words its row segments straddle, in one round.
constexpr int kLoads = 4;

struct Tile {
  int width;  // filtered pixels a tile row
  int rows;   // filtered rows a tile
  int pitch;  // shared bytes a staged traced row segment: its words
};

Tile tile_of(int s) {
  Tile t;
  t.width = kSegmentBytes / (3 * s) > 0 ? kSegmentBytes / (3 * s) : 1;
  // A segment of n bytes starts up to 15 bytes into its first word.
  t.pitch = (t.width * s * 3 + 15 + 15) / 16 * 16;
  t.rows = kStageBytes / (s * t.pitch) > 0 ? kStageBytes / (s * t.pitch) : 1;
  return t;
}

// S == 2: config 5's factor at compile time, its loops unrolled and the
// division by 4 a shift; S == 0: any factor `s_arg`.  At config 5's batch
// <2> takes 0.388 ms and <0> 0.576 (NVIDIA H100 80GB HBM3, 700 W), so the
// factor every cell runs keeps its own copy.
// At most 40 registers, so 6 blocks fit an SM: 0.390 ms at config 5's batch
// where the 46 registers of no bound (5 blocks) take 0.447 ms and the 32 of 8
// blocks spill and take 0.58 ms (NVIDIA H100 80GB HBM3, 700 W).
template <int S>
__global__ void __launch_bounds__(kThreads, 6) box_filter_kernel(
    const unsigned char* __restrict__ in, unsigned char* __restrict__ out,
    int n_rows, int width, int s_arg, Tile t) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int s = S > 0 ? S : s_arg;
  const int tiles_x = (width + t.width - 1) / t.width;
  const int x0 = (blockIdx.x % tiles_x) * t.width;
  const int row0 = (blockIdx.x / tiles_x) * t.rows;
  const int w = min(t.width, width - x0);
  const int rows = min(t.rows, n_rows - row0);
  const long long in_pitch = 3LL * width * s;  // bytes of a traced row
  const int seg = 3 * w * s;
  const int words = t.pitch / 16;
  // Traced row k of the tile starts at byte first + k * in_pitch.
  const long long first = static_cast<long long>(row0) * s * in_pitch +
                          3LL * x0 * s;
  const uintptr_t at = reinterpret_cast<uintptr_t>(in);

  // Each thread issues kLoads loads before it stores one, so a block has
  // its whole tile in flight at once (for s up to 20 a tile is at most
  // kThreads * kLoads words).
  const int n_words = rows * s * words;
  for (int i0 = threadIdx.x; i0 < n_words; i0 += kThreads * kLoads) {
    uint4 v[kLoads];
    int to[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int i = i0 + u * kThreads;
      const int k = i / words, word = i - k * words;
      const uintptr_t a = at + first + k * in_pitch;
      const uintptr_t w0 = a & ~static_cast<uintptr_t>(15);
      to[u] = i < n_words && w0 + 16u * word < a + seg
                  ? k * t.pitch + 16 * word : -1;
      if (to[u] >= 0) v[u] = __ldcs(reinterpret_cast<const uint4*>(w0) + word);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (to[u] >= 0) *reinterpret_cast<uint4*>(stage + to[u]) = v[u];
  }
  __syncthreads();

  // One thread a filtered pixel: column x of the tile, in every step-th
  // row from threadIdx.x / t.width (a tile is at most kThreads pixels wide).
  const int x = threadIdx.x % t.width;
  const int step = kThreads / t.width;
  const int lead0 = static_cast<int>((at + first) & 15u);
  const int lead_step = static_cast<int>(in_pitch & 15);
  if (x >= w || threadIdx.x >= step * t.width) return;
  for (int r = threadIdx.x / t.width; r < rows; r += step) {
    unsigned red = 0, green = 0, blue = 0;
#pragma unroll
    for (int di = 0; di < s; ++di) {
      const int k = r * s + di;
      const unsigned char* p = stage + k * t.pitch +
                               ((lead0 + k * lead_step) & 15) + 3 * x * s;
#pragma unroll
      for (int dj = 0; dj < s; ++dj) {
        red += p[3 * dj];
        green += p[3 * dj + 1];
        blue += p[3 * dj + 2];
      }
    }
    const unsigned n = static_cast<unsigned>(s * s);
    unsigned char* o =
        out + (static_cast<long long>(row0) + r) * 3 * width + 3 * (x0 + x);
    o[0] = static_cast<unsigned char>(red / n);
    o[1] = static_cast<unsigned char>(green / n);
    o[2] = static_cast<unsigned char>(blue / n);
  }
}

template <int S>
void launch(const unsigned char* in, unsigned char* out, int n_rows,
            int width, int s, Tile t, int blocks, size_t smem,
            cudaStream_t stream) {
  box_filter_kernel<S><<<blocks, kThreads, smem, stream>>>(in, out, n_rows,
                                                          width, s, t);
}

}  // namespace

// The box filter of n_rows / H frames: `frames` (n_rows s, width s, 3)
// uint8, `out` (n_rows, width, 3) uint8, both contiguous, out written
// whole.  One launch on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for sizes below 1 or a grid or tile too large.
extern "C" int par_box_filter(const void* frames, void* out, int n_rows,
                              int width, int s, void* stream) {
  if (n_rows < 1 || width < 1 || s < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Tile t = tile_of(s);
  const long long blocks =
      static_cast<long long>((width + t.width - 1) / t.width) *
      ((n_rows + t.rows - 1) / t.rows);
  const size_t smem = static_cast<size_t>(t.rows) * s * t.pitch;
  if (blocks > INT_MAX || smem > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* in = static_cast<const unsigned char*>(frames);
  auto* o = static_cast<unsigned char*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b = static_cast<int>(blocks);
  if (s == 2)
    launch<2>(in, o, n_rows, width, s, t, b, smem, st);
  else
    launch<0>(in, o, n_rows, width, s, t, b, smem, st);
  return static_cast<int>(cudaGetLastError());
}
