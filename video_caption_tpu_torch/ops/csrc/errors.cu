// Text of a cudaError_t returned by one of the kernel entry points.
#include <cuda_runtime.h>

extern "C" const char* vct_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
