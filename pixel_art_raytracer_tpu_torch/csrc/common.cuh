// Shared definitions of the port's CUDA kernels.
//
// Build flags (runtime/kernels.py): -fmad=false so no multiply-add contracts
// into an FMA, and nvcc's defaults -prec-div=true -ftz=false so `/` is the
// IEEE correctly-rounded quotient and subnormals survive, as in the C++
// reference and in the plain PyTorch versions the kernels are checked
// against.
#pragma once

#include <cuda_runtime.h>

namespace par {

// std::min(a, b) == (b < a ? b : a): keeps `a` when the pair is unordered
// (NaN), unlike fminf.  Same for std::max.
__device__ __forceinline__ float c_min(float a, float b) { return b < a ? b : a; }
__device__ __forceinline__ float c_max(float a, float b) { return a < b ? b : a; }

// The spatial hash and view geometry of RenderConfig.
struct Grid {
  int view_w, view_h;
  int bin_size, bin_cap;
  int hash_w, hash_h, hash_l;

  __host__ __device__ int volume() const { return hash_w * hash_h * hash_l; }
};

// Position of entity `e` in frame `f`: entity 0 (the player, the only
// dynamic entity of the batched path) takes its per-frame position.
__device__ __forceinline__ const int* entity_pos(const int* pos,
                                                const int* players, int f,
                                                int e) {
  return e == 0 ? players + 3 * f : pos + 3 * static_cast<size_t>(e);
}

}  // namespace par
