// An empty kernel on one warp, <<<1, 32>>>: the time the card needs for a
// launch that does nothing. A kernel's bound from its bytes and operations
// can lie below this floor; a measurement then prints both.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// Launches the empty kernel on `stream` (a cudaStream_t). Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* empty_launch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
