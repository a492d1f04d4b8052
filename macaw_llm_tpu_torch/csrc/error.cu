// Error text for the codes the kernel entry points return.
#include "kernels.cuh"

extern "C" const char* macaw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
