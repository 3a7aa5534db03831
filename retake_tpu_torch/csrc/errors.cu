// Error text for the return codes of the port's kernel launchers (the
// library links its own CUDA runtime, so the Python side asks it here).
#include <cuda_runtime.h>

extern "C" const char* retake_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
