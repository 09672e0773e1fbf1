// Shared by every kernel source of mxnet_tpu_torch: each source is built
// into its own shared library with a plain C interface (see _build.py),
// and each library exports mxt_error_string for its wrapper's messages.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Select the tensors' device for this library's runtime (it keeps its own
// current-device state, separate from PyTorch's) before a launch.
static inline cudaError_t mxt_set_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e != cudaSuccess || cur == device) return e;
  return cudaSetDevice(device);
}
