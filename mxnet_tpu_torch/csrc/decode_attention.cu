// Single-token decode attention over a length-masked KV pool, for Hopper
// (sm_90a): float32, bfloat16 or float16 q and caches (one type), widened
// to f32 at load, f32 math, the output rounded once to the input type.
//
// Replaces: mxnet_tpu/ops/attention.py:_decode_kernel (launched by
// _decode_pallas). Same function: for each slot b and q head h,
// out = softmax(q . K[:len] * scale) V[:len] over the first lengths[b]
// cached positions of kv head h / G (G = H / H_kv); positions at or past
// the cursor are stale pool memory and never enter the softmax; a slot
// with lengths == 0 gets zeros. Any group G that divides H is taken, as
// the TPU kernel takes it.
//
// What bounds it on the H100: bytes. Each cached K/V row is used once per
// q row of its group (G = 1 for MHA), about 0.5 flop per byte, so the
// ceiling is streaming sum(lengths) * 2 * H_kv * D * 4 bytes at 3.35 TB/s.
// The design aims at keeping enough loads in flight:
//  * one block of 256 threads per (slot, kv head, tile of GT q heads);
//    the tile's q rows sit in shared memory and in registers, so each K/V
//    row is read once for all GT heads that share it. GT is 1, 2, 4 or 8:
//    the group itself when it is one of those, else the next power of two
//    above it, at most 8 (G = 3 takes one tile of 4, G = 7 one of 8, G = 16
//    two of 8); heads past G in the last tile read zeros and are not
//    written;
//  * min(D/4, 32) threads own one key, a float4 each (two at D = 256: a
//    key spans one warp, the widest a shuffle reaches), so a warp reads
//    whole rows as contiguous 16-byte loads; the block holds
//    256/min(D/4, 32) keys at a time and each thread issues 4 float4
//    loads of K and of V (4 keys, 2 at D = 256) before using any;
//  * the loop runs only over positions < lengths[b], so the cost follows
//    the session's length, not max_len;
//  * every key group keeps its own online softmax (max, sum, accumulator)
//    in registers; the groups are merged once at the end through shared
//    memory, one q head at a time and in a fixed order, so the result
//    does not depend on timing and the merge buffer stays at
//    groups x D floats (8 KB at D = 256).
// A later step splits long caches across blocks (flash-decoding) so that
// fewer than ~132 (slot, kv head) pairs still fill the card.
//
// Head dims above 256 (D = 128 * NC: 384 and 512) take decode_wide: one
// warp per key, lane i owning columns c * 128 + 4 i .. +3 of every
// 128-column chunk c, so the loop over D runs in chunks and a key's
// shuffle stays inside its warp. The group's q rows stay in shared memory
// (one conflict-free float4 load per chunk and key) rather than in
// registers; only the G accumulators are (4 * G * NC floats: 128 at G = 8,
// D = 512). The q rows and the per-head merge buffer (8 key groups x D
// floats) live in dynamic shared memory sized at launch: (G + 8) * D * 4
// bytes, 32 KB at G = 8, D = 512.

#include <math.h>

#include "mxt_common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ lengths,
            T* __restrict__ o, int H, int Hkv, int S, float scale,
            int group) {
  constexpr int kTpk = D / 4 < 32 ? D / 4 : 32;   // threads per key
  constexpr int kW = D / (4 * kTpk);              // float4 per thread
  constexpr int kGroups = kThreads / kTpk;        // keys in flight per pass
  constexpr int kUnroll = 4 / kW;                 // keys per thread per pass
  __shared__ __align__(16) float qs[G][D];
  __shared__ float red_m[kGroups][G];
  __shared__ float red_l[kGroups][G];
  __shared__ __align__(16) float red_acc[kGroups][D];

  const int bhk = blockIdx.x;                // b * Hkv + hk
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int len = min(max(lengths[b], 0), S);
  const int tid = threadIdx.x;
  const int kg = tid / kTpk;                 // key group of this thread
  const int lane = tid % kTpk;               // float4 w of a row: column
                                             // (w * kTpk + lane) * 4
  const int g0 = blockIdx.y * G;             // first q head of this tile
  const int ng = min(G, group - g0);         // heads of the tile below G
  const size_t q_base = ((size_t)b * H + (size_t)hk * group + g0) * D;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i / D][i % D] = i / D < ng ? mxt_f32(q[q_base + i]) : 0.f;
  __syncthreads();

  float4 qv[G][kW], acc[G][kW];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int w = 0; w < kW; ++w) {
      qv[g][w] = *reinterpret_cast<const float4*>(&qs[g][(w * kTpk + lane) * 4]);
      acc[g][w] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const T* kb = k + (size_t)bhk * S * D + lane * 4;
  const T* vb = v + (size_t)bhk * S * D + lane * 4;

  // the trip count is uniform over the block, so every lane reaches the
  // shuffles below; validity is per key
  for (int base = 0; base < len; base += kGroups * kUnroll) {
    float4 kk[kUnroll][kW], vv[kUnroll][kW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * kGroups + kg;
#pragma unroll
      for (int w = 0; w < kW; ++w) {
        if (j < len) {
          const size_t off = (size_t)j * D + w * kTpk * 4;
          kk[u][w] = mxt_ld4(kb + off);
          vv[u][w] = mxt_ld4(vb + off);
        } else {
          kk[u][w] = vv[u][w] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool valid = base + u * kGroups + kg < len;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kW; ++w)
          s += qv[g][w].x * kk[u][w].x + qv[g][w].y * kk[u][w].y +
               qv[g][w].z * kk[u][w].z + qv[g][w].w * kk[u][w].w;
#pragma unroll
        for (int off = kTpk / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off, kTpk);
        if (valid) {
          s *= scale;
          const float m_new = fmaxf(m[g], s);
          const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
          const float p = expf(s - m_new);
          l[g] = l[g] * corr + p;
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            acc[g][w].x = acc[g][w].x * corr + p * vv[u][w].x;
            acc[g][w].y = acc[g][w].y * corr + p * vv[u][w].y;
            acc[g][w].z = acc[g][w].z * corr + p * vv[u][w].z;
            acc[g][w].w = acc[g][w].w * corr + p * vv[u][w].w;
          }
          m[g] = m_new;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red_m[kg][g] = m[g];
      red_l[kg][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int w = 0; w < kW; ++w)
      *reinterpret_cast<float4*>(&red_acc[kg][(w * kTpk + lane) * 4]) =
          acc[g][w];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float mx = -INFINITY;
      for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, red_m[r][g]);
      float lsum = 0.f, out = 0.f;
      if (mx != -INFINITY) {
        for (int r = 0; r < kGroups; ++r) {
          const float mr = red_m[r][g];
          const float w = (mr == -INFINITY) ? 0.f : expf(mr - mx);
          lsum += red_l[r][g] * w;
          out += red_acc[r][d] * w;
        }
      }
      if (g < ng)
        o[q_base + (size_t)g * D + d] =
            mxt_round<T>(out / (lsum == 0.f ? 1.f : lsum));
    }
    __syncthreads();                         // red_acc reused for g + 1
  }
}

// q heads per block for a GQA group: the group when it is 1, 2, 4 or 8,
// else the next power of two above it, at most 8
inline int head_tile(int group) {
  return group >= 8 ? 8 : group > 2 ? (group > 4 ? 8 : 4) : group;
}

template <typename T>
struct Args {
  const T *q, *k, *v;
  const int* lengths;
  T* o;
  int B, H, Hkv, S;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D, int GT>
cudaError_t launch(const Args<T>& x) {
  const int group = x.H / x.Hkv;
  dim3 grid(x.B * x.Hkv, (group + GT - 1) / GT);
  decode_attn<T, D, GT><<<grid, kThreads, 0, x.stream>>>(
      x.q, x.k, x.v, x.lengths, x.o, x.H, x.Hkv, x.S, x.scale, group);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(const Args<T>& x) {
  switch (head_tile(x.H / x.Hkv)) {
    case 1: return launch<T, D, 1>(x);
    case 2: return launch<T, D, 2>(x);
    case 4: return launch<T, D, 4>(x);
    case 8: return launch<T, D, 8>(x);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NC, int G>
__global__ void __launch_bounds__(kThreads)
decode_wide(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ lengths,
            T* __restrict__ o, int H, int Hkv, int S, float scale,
            int group) {
  constexpr int D = 128 * NC;
  constexpr int kGroups = kThreads / 32;     // keys in flight per pass
  extern __shared__ __align__(16) float wide_smem[];
  float* qs = wide_smem;                     // [G][D]
  float* red_acc = wide_smem + G * D;        // [kGroups][D]
  __shared__ float red_m[kGroups][G];
  __shared__ float red_l[kGroups][G];

  const int bhk = blockIdx.x;                // b * Hkv + hk
  const int b = bhk / Hkv, hk = bhk % Hkv;
  const int len = min(max(lengths[b], 0), S);
  const int tid = threadIdx.x;
  const int kg = tid / 32;                   // key group: one warp
  const int lane = tid % 32;
  const int g0 = blockIdx.y * G;             // first q head of this tile
  const int ng = min(G, group - g0);
  const size_t q_base = ((size_t)b * H + (size_t)hk * group + g0) * D;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = i / D < ng ? mxt_f32(q[q_base + i]) : 0.f;
  __syncthreads();

  float4 acc[G][NC];
  float m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    m[g] = -INFINITY;
    l[g] = 0.f;
  }
  const T* kb = k + (size_t)bhk * S * D + lane * 4;
  const T* vb = v + (size_t)bhk * S * D + lane * 4;

  for (int base = 0; base < len; base += kGroups) {
    const int j = base + kg;
    if (j >= len) break;                     // whole warp: same key
    float4 kk[NC], vv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      kk[c] = mxt_ld4(kb + (size_t)j * D + c * 128);
      vv[c] = mxt_ld4(vb + (size_t)j * D + c * 128);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 qq =
            *reinterpret_cast<const float4*>(qs + g * D + c * 128 + lane * 4);
        s += qq.x * kk[c].x + qq.y * kk[c].y + qq.z * kk[c].z +
             qq.w * kk[c].w;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      s *= scale;
      const float m_new = fmaxf(m[g], s);
      const float corr = (m[g] == -INFINITY) ? 0.f : expf(m[g] - m_new);
      const float p = expf(s - m_new);
      l[g] = l[g] * corr + p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[g][c].x = acc[g][c].x * corr + p * vv[c].x;
        acc[g][c].y = acc[g][c].y * corr + p * vv[c].y;
        acc[g][c].z = acc[g][c].z * corr + p * vv[c].z;
        acc[g][c].w = acc[g][c].w * corr + p * vv[c].w;
      }
      m[g] = m_new;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      red_m[kg][g] = m[g];
      red_l[kg][g] = l[g];
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(red_acc + kg * D + c * 128 + lane * 4) =
          acc[g][c];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float mx = -INFINITY;
      for (int r = 0; r < kGroups; ++r) mx = fmaxf(mx, red_m[r][g]);
      float lsum = 0.f, out = 0.f;
      if (mx != -INFINITY) {
        for (int r = 0; r < kGroups; ++r) {
          const float mr = red_m[r][g];
          const float w = (mr == -INFINITY) ? 0.f : expf(mr - mx);
          lsum += red_l[r][g] * w;
          out += red_acc[r * D + d] * w;
        }
      }
      if (g < ng)
        o[q_base + (size_t)g * D + d] =
            mxt_round<T>(out / (lsum == 0.f ? 1.f : lsum));
    }
    __syncthreads();                         // red_acc reused for g + 1
  }
}

template <typename T, int NC, int G>
cudaError_t launch_wide(const Args<T>& x) {
  const int smem = (G + kThreads / 32) * 128 * NC * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      decode_wide<T, NC, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  const int group = x.H / x.Hkv;
  dim3 grid(x.B * x.Hkv, (group + G - 1) / G);
  decode_wide<T, NC, G><<<grid, kThreads, smem, x.stream>>>(
      x.q, x.k, x.v, x.lengths, x.o, x.H, x.Hkv, x.S, x.scale, group);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_wide_g(const Args<T>& x) {
  switch (head_tile(x.H / x.Hkv)) {
    case 1: return launch_wide<T, NC, 1>(x);
    case 2: return launch_wide<T, NC, 2>(x);
    case 4: return launch_wide<T, NC, 4>(x);
    case 8: return launch_wide<T, NC, 8>(x);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(int D, const void* q, const void* k, const void* v,
                const void* lengths, void* o, int B, int H, int Hkv, int S,
                float scale, cudaStream_t stream) {
  const Args<T> x{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const int*>(lengths),
                  static_cast<T*>(o), B, H, Hkv, S, scale, stream};
  switch (D) {
    case 16: return launch_g<T, 16>(x);
    case 32: return launch_g<T, 32>(x);
    case 64: return launch_g<T, 64>(x);
    case 128: return launch_g<T, 128>(x);
    case 256: return launch_g<T, 256>(x);
    case 384: return launch_wide_g<T, 3>(x);
    case 512: return launch_wide_g<T, 4>(x);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,D), k/v (B,Hkv,S,D), o (B,H,D) of one element type (dtype:
// MXT_F32, MXT_BF16 or MXT_F16); lengths (B,) int32; all contiguous.
extern "C" int mxt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int H, int Hkv, int S,
                                    int D, float scale, int dtype, int device,
                                    void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (B * Hkv <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case MXT_F32: return run<float>(D, q, k, v, lengths, o, B, H, Hkv, S,
                                    scale, st);
    case MXT_BF16: return run<__nv_bfloat16>(D, q, k, v, lengths, o, B, H,
                                             Hkv, S, scale, st);
    case MXT_F16: return run<__half>(D, q, k, v, lengths, o, B, H, Hkv, S,
                                     scale, st);
    default: return cudaErrorInvalidValue;
  }
}
