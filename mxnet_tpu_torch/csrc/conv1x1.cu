// Fused 1x1 convolution with a BN-apply (+residual) (+ReLU) prologue and a
// BN-statistics epilogue, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/conv_fused.py:_c1x1_kernel (launched by
// conv1x1). Same function, per image n:
//   xf      = x[n] * scale + shift (+ residual[n])  (f32; only with bn_in)
//   xf      = max(xf, 0)                            (relu_in)
//   x'      = xf rounded to x's dtype                (as the TPU kernel does)
//   y[n]    = w @ x'                                 (f32 sums)
//   stored  = y rounded to x's dtype
//   part[n, pt, 0/1, co] = sum / sum of squares of the stored values of
//             P-tile pt, in f32
// Layout: x (N, Ci, P = H*W), w (Co, Ci), y (N, Co, P); x and w are f32 or
// bf16 each, y has x's dtype. The caller sums the partials over (n, pt), as
// the JAX function does after its pallas_call.
//
// What bounds it on the H100: bytes. ResNet-50's 1x1 shapes at batch 128
// in bf16 do 2*Ci*Co flops per 2*(Ci + Co) bytes of each spatial position,
// 32 to 410 flops per byte, below or near the tensor cores' ~295 line; the
// least time is reading x (and the residual) once and writing y once.
// The TPU design keeps w whole in VMEM and one (Co, P-block) output tile
// resident per grid step, with the grid run in order. Here:
//  * the output is tiled in (64 channels x 64 positions) blocks over a grid
//    of (P tiles, Co tiles, N), each block looping over Ci in chunks of 16;
//  * each chunk of x is staged through shared memory with the prologue
//    applied on the way in (scale, shift, residual, ReLU, then rounding to
//    x's dtype), so the normalized input never reaches device memory; the
//    w chunk is staged beside it, transposed;
//  * 256 threads each keep a 4 x 4 micro-tile of f32 sums in registers,
//    16 FMAs per two float4 shared-memory loads;
//  * the epilogue rounds y, stores it, and sums each channel's stored
//    values over the block's positions by shuffles within the 16 threads
//    that share a channel; one thread writes them to the block's own slot
//    of the partials: one writer per element and no atomics, so the
//    statistics are the same on every run;
//  * ragged P (3136, 784, 196, 49 are no multiples of 64), Co and Ci edges
//    are masked: padding enters no sum and is never stored.
// This is a simple FMA kernel: f32 pipes at 67 TFLOP/s, far from the bytes
// bound. Tensor cores (mma.sync / wgmma on bf16) and TMA are a later step.

#include <cuda_bf16.h>

#include "mxt_common.cuh"

namespace {

constexpr int kBM = 64;          // output channels per block
constexpr int kBN = 64;          // spatial positions per block
constexpr int kBK = 16;          // input channels per chunk
constexpr int kThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// v rounded to T and back: what a store of T then a load would give
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
conv1x1_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               const float* __restrict__ scale,
               const float* __restrict__ shift, const void* __restrict__ res,
               int res_bf16, int relu, TX* __restrict__ y,
               float* __restrict__ part, int Ci, int Co, int P) {
  __shared__ __align__(16) float xs[kBK][kBN];
  __shared__ __align__(16) float ws[kBK][kBM + 4];   // padded: transposed
                                                     // stores hit 2 banks

  const int p0 = blockIdx.x * kBN;
  const int c0 = blockIdx.y * kBM;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t xoff = (size_t)n * Ci * P;
  const bool prologue = scale != nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += kBK) {
    __syncthreads();                         // previous chunk consumed
#pragma unroll
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int r = e / kBN, c = e % kBN;    // input channel, position
      const int ci = k0 + r, p = p0 + c;
      float v = 0.f;
      if (ci < Ci && p < P) {
        const size_t off = xoff + (size_t)ci * P + p;
        v = to_f32(x[off]);
        if (prologue) {
          // two roundings, as x * scale + shift in the JAX function
          v = __fadd_rn(__fmul_rn(v, scale[ci]), shift[ci]);
          if (res != nullptr)
            v += res_bf16
                     ? __bfloat162float(
                           static_cast<const __nv_bfloat16*>(res)[off])
                     : static_cast<const float*>(res)[off];
          if (relu) v = fmaxf(v, 0.f);
          v = round_to<TX>(v);
        }
      }
      xs[r][c] = v;
    }
#pragma unroll
    for (int e = tid; e < kBK * kBM; e += kThreads) {
      const int r = e / kBK, c = e % kBK;    // output channel, input channel
      const int co = c0 + r, ci = k0 + c;
      ws[c][r] = (co < Co && ci < Ci) ? to_f32(w[(size_t)co * Ci + ci]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ws[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // epilogue: round, store, per-channel sums of the stored values
  const unsigned half = 0xffffu << (threadIdx.x & 16);   // this ty's lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = c0 + ty * 4 + i;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      const float yc = round_to<TX>(acc[i][j]);
      if (co < Co && p < P) {
        y[((size_t)n * Co + co) * P + p] = from_f32<TX>(yc);
        s1 += yc;
        s2 = fmaf(yc, yc, s2);
      }
    }
    if (part != nullptr) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(half, s1, off);
        s2 += __shfl_xor_sync(half, s2, off);
      }
      if (tx == 0 && co < Co) {
        // part (N, Pt, 2, Co): this block's own slot
        float* slot = part + ((size_t)n * gridDim.x + blockIdx.x) * 2 * Co;
        slot[co] = s1;
        slot[Co + co] = s2;
      }
    }
  }
}

template <typename TX, typename TW>
cudaError_t launch(const void* x, const void* w, const float* scale,
                   const float* shift, const void* res, int res_bf16,
                   int relu, void* y, float* part, int N, int Ci, int Co,
                   int P, cudaStream_t stream) {
  dim3 grid((P + kBN - 1) / kBN, (Co + kBM - 1) / kBM, N);
  conv1x1_kernel<TX, TW><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), scale, shift, res,
      res_bf16, relu, static_cast<TX*>(y), part, Ci, Co, P);
  return cudaGetLastError();
}

}  // namespace

// x (N,Ci,P) f32|bf16, w (Co,Ci) f32|bf16, scale/shift (Ci,) f32 or both
// NULL (no prologue), res (N,Ci,P) f32|bf16 or NULL, y (N,Co,P) of x's
// dtype, part (N, Pt, 2, Co) f32 or NULL: all contiguous. Pt, the caller's
// count of 64-position tiles, must be ceil(P / 64).
extern "C" int mxt_conv1x1(const void* x, const void* w, const void* scale,
                           const void* shift, const void* res, void* y,
                           void* part, int N, int Ci, int Co, int P, int Pt,
                           int x_bf16, int w_bf16, int res_bf16, int relu,
                           int device, void* stream) {
  if (Pt != (P + kBN - 1) / kBN) return cudaErrorInvalidValue;
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (N <= 0 || Co <= 0 || P <= 0) return cudaSuccess;
  if (N > 65535 || (Co + kBM - 1) / kBM > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto sh = static_cast<const float*>(shift);
  auto pt = static_cast<float*>(part);
  if (x_bf16 && w_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, sc, sh, res, res_bf16,
                                                relu, y, pt, N, Ci, Co, P, st);
  if (x_bf16)
    return launch<__nv_bfloat16, float>(x, w, sc, sh, res, res_bf16, relu, y,
                                        pt, N, Ci, Co, P, st);
  if (w_bf16)
    return launch<float, __nv_bfloat16>(x, w, sc, sh, res, res_bf16, relu, y,
                                        pt, N, Ci, Co, P, st);
  return launch<float, float>(x, w, sc, sh, res, res_bf16, relu, y, pt, N, Ci,
                              Co, P, st);
}
