// The message for a CUDA error code returned by one of the kernels' C
// entry points (the Python wrappers raise with it).
#include <cuda_runtime.h>

extern "C" const char* rtt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
