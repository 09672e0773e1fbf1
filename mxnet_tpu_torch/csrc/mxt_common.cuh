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

// cp.async: 16 bytes from device to shared memory, zero-filled when !pred
// (src must still be a valid address); commit a group; wait for all.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                                  bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
static __device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}
