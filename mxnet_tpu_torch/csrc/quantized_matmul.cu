// Weight-only quantized matmul, float32 activations x int8 / fp8-e4m3
// weights, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/quantization.py:_qmm_kernel (launched by
// _qmm_pallas). Same function: out[m, n] = (sum_k x[m, k] * widen(q[k, n]))
// * scale[n], f32 accumulation, the per-column scale applied once in the
// epilogue (it factors out of the contraction). The wide weight never
// exists in device memory.
//
// What bounds it on the H100: in the decode step (M = number of slots,
// 8 here) bytes: the narrow weight is read once for 2*M flops per byte,
// so the ceiling is K*N bytes at 3.35 TB/s. In prefill (M up to the
// bucket, 1024) operations, on the FP32 pipes, because x is float32. The
// design is for the decode step:
//  * one block of 256 threads per (64 columns, 8 rows): 16 column threads
//    x 16 k-slices. A column thread owns 4 adjacent columns, so a warp
//    reads 64 contiguous weight bytes from each of 2 rows; the 16 slices
//    split K, so many independent weight loads are in flight per block
//    and a narrow layer (N = 1024) still spreads over 16 blocks;
//  * weights are loaded narrow (one 32-bit word holds 4 int8 or 4 fp8
//    values) and widened in registers: int8 by a signed byte convert, fp8
//    e4m3 through cuda_fp8.h;
//  * x is staged 256 k at a time in shared memory as [k][m], so one
//    float4 broadcast pair gives the 8 rows' activations for a k;
//  * the 16 k-slice partial sums are added in a fixed order through shared
//    memory, then scaled and stored, so results are deterministic;
//  * any M, N and K: rows, columns and k past the edge are masked. Where
//    N % 4 != 0 (the vocab projection, N = 50257) a row is not 4-byte
//    aligned and the weights are read byte by byte.
// Prefill re-reads each weight tile once per 8 rows (from L2). Tensor
// cores (int8/fp8 wgmma with x quantized or widened to bf16) are a later
// step.

#include <cuda_fp8.h>
#include <stdint.h>

#include "mxt_common.cuh"

namespace {

constexpr int kRows = 8;       // BM
constexpr int kColThreads = 16;
constexpr int kCols = 4 * kColThreads;   // BN = 64
constexpr int kSlices = 16;
constexpr int kThreads = kColThreads * kSlices;
constexpr int kChunk = 256;    // k per shared-memory stage

template <int KIND>
__device__ __forceinline__ float widen(uint32_t byte) {
  if (KIND == 0) return static_cast<float>(static_cast<int8_t>(byte));
  __nv_fp8_e4m3 f;
  f.__x = static_cast<__nv_fp8_storage_t>(byte);
  return static_cast<float>(f);
}

template <int KIND, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
qmm_f32(const float* __restrict__ x, const uint8_t* __restrict__ w,
        const float* __restrict__ scale, float* __restrict__ out, int M,
        int N, int K) {
  __shared__ __align__(16) float xs[kChunk][kRows];
  __shared__ float red[kSlices][kRows][kCols];

  const int tid = threadIdx.x;
  const int ct = tid % kColThreads;
  const int ks = tid / kColThreads;
  const int n0 = blockIdx.x * kCols + ct * 4;
  const int m0 = blockIdx.y * kRows;

  float acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
    acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0.f;

  for (int kc = 0; kc < K; kc += kChunk) {
    __syncthreads();
    for (int i = tid; i < kChunk * kRows; i += kThreads) {
      const int m = i / kChunk, kk = i % kChunk;
      const int gm = m0 + m, gk = kc + kk;
      xs[kk][m] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : 0.f;
    }
    __syncthreads();
    const int kn = min(kChunk, K - kc);
#pragma unroll 4
    for (int kk = ks; kk < kn; kk += kSlices) {
      const uint8_t* row = w + (size_t)(kc + kk) * N;
      float wv[4];
      if (ALIGNED) {
        uint32_t word = 0;
        if (n0 < N) word = *reinterpret_cast<const uint32_t*>(row + n0);
#pragma unroll
        for (int c = 0; c < 4; ++c) wv[c] = widen<KIND>((word >> (8 * c)) & 0xffu);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          wv[c] = (n0 + c < N) ? widen<KIND>(row[n0 + c]) : 0.f;
      }
      const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
      const float xm[kRows] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xm[m], wv[c], acc[m][c]);
    }
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ks][m][ct * 4 + c] = acc[m][c];
  __syncthreads();
  for (int i = tid; i < kRows * kCols; i += kThreads) {
    const int m = i / kCols, c = i % kCols;
    const int gm = m0 + m, gn = blockIdx.x * kCols + c;
    if (gm >= M || gn >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) sum += red[s][m][c];
    out[(size_t)gm * N + gn] = sum * scale[gn];
  }
}

template <int KIND>
cudaError_t launch(const float* x, const uint8_t* w, const float* scale,
                   float* out, int M, int N, int K, cudaStream_t stream) {
  dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  if (N % 4 == 0)
    qmm_f32<KIND, true><<<grid, kThreads, 0, stream>>>(x, w, scale, out, M,
                                                       N, K);
  else
    qmm_f32<KIND, false><<<grid, kThreads, 0, stream>>>(x, w, scale, out, M,
                                                        N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M,K) f32, w (K,N) int8 (kind 0) or fp8-e4m3 bytes (kind 1), scale (N,)
// f32, out (M,N) f32: contiguous.
extern "C" int mxt_quantized_matmul_f32(const void* x, const void* w,
                                        const void* scale, void* out, int M,
                                        int N, int K, int kind, int device,
                                        void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if ((M + kRows - 1) / kRows > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto xf = static_cast<const float*>(x);
  auto wb = static_cast<const uint8_t*>(w);
  auto sf = static_cast<const float*>(scale);
  auto of = static_cast<float*>(out);
  switch (kind) {
    case 0: return launch<0>(xf, wb, sf, of, M, N, K, st);
    case 1: return launch<1>(xf, wb, sf, of, M, N, K, st);
    default: return cudaErrorInvalidValue;
  }
}
