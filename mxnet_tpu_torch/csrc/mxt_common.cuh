// Shared by every kernel source of mxnet_tpu_torch: each source is built
// into its own shared library with a plain C interface (see _build.py),
// and each library exports mxt_error_string for its wrapper's messages.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

extern "C" const char* mxt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Kernel launches this library has made: every launch site calls
// mxt_counted once it has launched; mxt_launches reads the count. A CUDA
// graph replay launches the kernels its capture recorded without passing
// a launch site: the replaying code adds them with mxt_add_launches.
static unsigned long long mxt_launch_count = 0;
static inline void mxt_counted() {
  __atomic_add_fetch(&mxt_launch_count, 1ULL, __ATOMIC_RELAXED);
}
extern "C" unsigned long long mxt_launches() {
  return __atomic_load_n(&mxt_launch_count, __ATOMIC_RELAXED);
}
extern "C" void mxt_add_launches(unsigned long long n) {
  __atomic_add_fetch(&mxt_launch_count, n, __ATOMIC_RELAXED);
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

// Element types of the attention kernels: float, __nv_bfloat16, __half.
// The C entries name them by code (MXT_F32, MXT_BF16, MXT_F16); a kernel
// widens what it loads to f32, does its math in f32, and rounds once where
// it stores (mxt_round).
enum { MXT_F32 = 0, MXT_BF16 = 1, MXT_F16 = 2 };

static __device__ __forceinline__ float mxt_f32(float x) { return x; }
static __device__ __forceinline__ float mxt_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
static __device__ __forceinline__ float mxt_f32(__half x) {
  return __half2float(x);
}

template <typename T>
static __device__ __forceinline__ T mxt_round(float x) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __float2bfloat16_rn(x);
  } else if constexpr (std::is_same<T, __half>::value) {
    return __float2half_rn(x);
  } else {
    return x;
  }
}

// 4 consecutive elements, widened (16-byte aligned for float, 8 for halves)
static __device__ __forceinline__ float4 mxt_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
static __device__ __forceinline__ float4 mxt_ld4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
static __device__ __forceinline__ float mxt_h2f(uint32_t bits) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}
static __device__ __forceinline__ float4 mxt_ld4(const __half* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(mxt_h2f(u.x), mxt_h2f(u.x >> 16), mxt_h2f(u.y),
                     mxt_h2f(u.y >> 16));
}

// 4 consecutive elements, each rounded once to T
static __device__ __forceinline__ void mxt_st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
static __device__ __forceinline__ void mxt_st4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u.x) : "f"(v.y), "f"(v.x));
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(u.y) : "f"(v.w), "f"(v.z));
  *reinterpret_cast<uint2*>(p) = u;
}
static __device__ __forceinline__ void mxt_st4(__half* p, float4 v) {
  uint2 u;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(u.x) : "f"(v.y), "f"(v.x));
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(u.y) : "f"(v.w), "f"(v.z));
  *reinterpret_cast<uint2*>(p) = u;
}
