// Error reporting for the ctypes wrappers: every launch entry point returns
// cudaGetLastError() as an int, and the wrapper turns it into a message.
#include <cuda_runtime.h>

extern "C" const char* par_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
