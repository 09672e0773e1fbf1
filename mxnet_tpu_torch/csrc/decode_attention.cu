// Single-token decode attention over a length-masked KV pool, float32,
// for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py:_decode_kernel (launched by
// _decode_pallas). Same function: for each slot b and q head h,
// out = softmax(q . K[:len] * scale) V[:len] over the first lengths[b]
// cached positions of kv head h / G (G = H / H_kv); positions at or past
// the cursor are stale pool memory and never enter the softmax; a slot
// with lengths == 0 gets zeros.
//
// What bounds it on the H100: bytes. Each cached K/V row is used once per
// q row of its group (G = 1 for MHA), about 0.5 flop per byte, so the
// ceiling is streaming sum(lengths) * 2 * H_kv * D * 4 bytes at 3.35 TB/s.
// The design aims at keeping enough loads in flight:
//  * one block of 256 threads per (slot, kv head); the GQA group's q rows
//    sit in shared memory and in registers, so each K/V row is read once
//    for all G heads that share it;
//  * D/4 threads own one key (a float4 each), so a warp reads 32/(D/4)
//    whole rows as contiguous 16-byte loads; the block holds
//    256/(D/4) keys at a time and each thread issues 4 keys' K and V
//    loads before using any, 8 x 16 bytes in flight per thread;
//  * the loop runs only over positions < lengths[b], so the cost follows
//    the session's length, not max_len;
//  * every key group keeps its own online softmax (max, sum, accumulator)
//    in registers; the groups are merged once at the end through shared
//    memory, in a fixed order, so the result does not depend on timing.
// A later step splits long caches across blocks (flash-decoding) so that
// fewer than ~132 (slot, kv head) pairs still fill the card.

#include <math.h>

#include "mxt_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ lengths,
           float* __restrict__ o, int H, int Hkv, int S, float scale) {
  constexpr int kTpk = D / 4;                // threads per key
  constexpr int kGroups = kThreads / kTpk;   // keys in flight per pass
  __shared__ __align__(16) float qs[G][D];
  __shared__ float red_m[kGroups][G];
  __shared__ float red_l[kGroups][G];
  __shared__ __align__(16) float red_acc[kGroups][G][D];

  const int bhk = blockIdx.x;                // b * Hkv + hk
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int len = min(max(lengths[b], 0), S);
  const int tid = threadIdx.x;
  const int kg = tid / kTpk;                 // key group of this thread
  const int c = (tid % kTpk) * 4;            // its 4 of the D dims
  const size_t q_base = ((size_t)b * H + (size_t)hk * G) * D;

  for (int i = tid; i < G * D; i += kThreads) qs[i / D][i % D] = q[q_base + i];
  __syncthreads();

  float4 qv[G], acc[G];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qv[g] = *reinterpret_cast<const float4*>(&qs[g][c]);
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const float* kb = k + (size_t)bhk * S * D + c;
  const float* vb = v + (size_t)bhk * S * D + c;

  // the trip count is uniform over the block, so every lane reaches the
  // shuffles below; validity is per key
  for (int base = 0; base < len; base += kGroups * kUnroll) {
    float4 kk[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + kg;
      if (j < len) {
        kk[u] = *reinterpret_cast<const float4*>(kb + (size_t)j * D);
        vv[u] = *reinterpret_cast<const float4*>(vb + (size_t)j * D);
      } else {
        kk[u] = vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + u * kGroups + kg < len;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = qv[g].x * kk[u].x + qv[g].y * kk[u].y +
                  qv[g].z * kk[u].z + qv[g].w * kk[u].w;
#pragma unroll
        for (int off = kTpk / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off, kTpk);
        if (valid) {
          s *= scale;
          const float m_new = fmaxf(m[g], s);
          const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
          acc[g].x = acc[g].x * corr + p * vv[u].x;
          acc[g].y = acc[g].y * corr + p * vv[u].y;
          acc[g].z = acc[g].z * corr + p * vv[u].z;
          acc[g].w = acc[g].w * corr + p * vv[u].w;
          m[g] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (c == 0) {
      red_m[kg][g] = m[g];
      red_l[kg][g] = l[g];
    }
    *reinterpret_cast<float4*>(&red_acc[kg][g][c]) = acc[g];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float mx = -INFINITY;
    for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, red_m[r][g]);
    float lsum = 0.f, out = 0.f;
    if (mx != -INFINITY) {
      for (int r = 0; r < kGroups; ++r) {
        const float mr = red_m[r][g];
        const float w = (mr == -INFINITY) ? 0.f : expf(mr - mx);
        lsum += red_l[r][g] * w;
        out += red_acc[r][g][d] * w;
      }
    }
    o[q_base + i] = out / (lsum == 0.f ? 1.f : lsum);
  }
}

template <int D, int G>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* lengths, float* o, int B, int H, int Hkv, int S,
                   float scale, cudaStream_t stream) {
  decode_f32<D, G><<<B * Hkv, kThreads, 0, stream>>>(q, k, v, lengths, o, H,
                                                     Hkv, S, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_g(int G, const float* q, const float* k, const float* v,
                     const int* lengths, float* o, int B, int H, int Hkv,
                     int S, float scale, cudaStream_t stream) {
  switch (G) {
    case 1: return launch<D, 1>(q, k, v, lengths, o, B, H, Hkv, S, scale,
                                stream);
    case 2: return launch<D, 2>(q, k, v, lengths, o, B, H, Hkv, S, scale,
                                stream);
    case 4: return launch<D, 4>(q, k, v, lengths, o, B, H, Hkv, S, scale,
                                stream);
    case 8: return launch<D, 8>(q, k, v, lengths, o, B, H, Hkv, S, scale,
                                stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D), k/v (B,Hkv,S,D), lengths (B,) int32, o (B,H,D): contiguous.
extern "C" int mxt_decode_attention_f32(const void* q, const void* k,
                                        const void* v, const void* lengths,
                                        void* o, int B, int H, int Hkv, int S,
                                        int D, float scale, int device,
                                        void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (B * Hkv <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto lf = static_cast<const int*>(lengths);
  auto of = static_cast<float*>(o);
  switch (D) {
    case 16: return launch_g<16>(G, qf, kf, vf, lf, of, B, H, Hkv, S, scale,
                                 st);
    case 32: return launch_g<32>(G, qf, kf, vf, lf, of, B, H, Hkv, S, scale,
                                 st);
    case 64: return launch_g<64>(G, qf, kf, vf, lf, of, B, H, Hkv, S, scale,
                                 st);
    case 128: return launch_g<128>(G, qf, kf, vf, lf, of, B, H, Hkv, S,
                                   scale, st);
    default: return cudaErrorInvalidValue;
  }
}
