// Error strings for the codes the kernel entry points return.
#include "common.cuh"

GNNOME_API const char* gnnome_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
