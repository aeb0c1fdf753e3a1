// C helpers shared by every kernel entry point of libv3d_kernels.so.
#include "common.cuh"

extern "C" const char* v3d_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
