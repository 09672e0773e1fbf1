// Flash attention forward, float32, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/attention.py:_flash_kernel (launched by
// _flash_pallas). Same function: out = softmax(q k^T * scale [causal]) v
// with an online softmax in f32, plus the per-row logsumexp, without the
// (S, S) score matrix ever reaching device memory. GQA reads kv head
// h / (H / H_kv) directly (no repeated copy). A row with no valid key gets
// out = 0 and lse = +inf, the TPU kernel's sentinel.
//
// What bounds it on the H100: operations. Causal prefill at S = 1024 does
// 4*S^2/2*D flops per head against 16*S*D bytes, far above the card's
// flops-per-byte line, and float32 inputs leave the tensor cores out, so
// the ceiling is the 67 TFLOP/s of the FP32 pipes. The design keeps the
// FMA pipes fed from registers and shared memory:
//  * one block per (b*h, 64-row q tile), kSplit threads per q row (one for
//    D <= 64, D/64 above: 2 at D = 128, 4 at D = 256); each thread keeps
//    its share of the row's q vector and output accumulator in registers
//    (2*D/kSplit floats, so D = 128 and 256 hold as many as D = 64 and do
//    not spill), and the partners of a row sum their partial dot products
//    with a butterfly of warp shuffles;
//  * K/V tiles (64*64/D keys above D = 64: 32 at D = 128, 16 at D = 256,
//    so the two tiles stay at 32 KB of static shared memory) are staged in
//    shared memory once per block by coalesced float4 loads and read back
//    as float4 broadcasts, 4 FMAs per shared load; the float4 columns are
//    dealt to a row's partners in turn, so they read different banks;
//  * the online softmax runs per 16-key chunk, so the running max and the
//    accumulator rescale cost 1/32 of the FMAs;
//  * causal: tiles wholly above the block's last row are never loaded, and
//    each row stops at its own diagonal within the last tile;
//  * a ragged S (not a multiple of the tile) is masked: rows past S do no
//    work, keys past S are zero-filled and never enter the softmax.
// The TPU kernel's 8-lane lse replication is TPU tiling and is dropped:
// lse is (B*H, S) f32. Tensor cores (wgmma, bf16/TF32) are a later step.
//
// Head dims above 256 (D = 128 * NC: 384 and 512) take a second kernel,
// flash_fwd_wide_f32, since a thread can no longer hold its share of both
// the q row and the accumulator:
//  * 8 threads per q row and 32 rows per block; a thread owns 16 columns of
//    every 128-column chunk, and keeps only the accumulator in registers
//    (16 * NC floats); the q row is re-read chunk by chunk from device
//    memory (L1-resident: the block's 32 rows) once per tile;
//  * the dot products loop over D in 128-column chunks, each chunk adding to
//    the 16 keys' partial sums, which the 8 partners then sum by shuffles;
//  * the K/V tile is 16 keys (one softmax chunk) at any D, in dynamic shared
//    memory sized at launch (128 * D bytes: 48 KB at D = 384, 64 KB at
//    D = 512), opted in above the 48 KB default.
// The port's ceiling of 512 is the backward's (flash_attention_bwd.cu).

#include <math.h>

#include "mxt_common.cuh"

namespace {

constexpr int kRows = 64;   // q rows per block
constexpr int kChunk = 16;  // keys per online-softmax update

template <int D>
struct Shape {
  static constexpr int kSplit = D > 64 ? D / 64 : 1;     // threads per row
  static constexpr int kTile = D > 64 ? 64 * 64 / D : 64;  // keys per tile
  static constexpr int kThreads = kRows * kSplit;
  static constexpr int kVec = D / (4 * kSplit);   // float4 columns per thread
};

template <int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int S, float scale,
              int causal) {
  constexpr int kSplit = Shape<D>::kSplit;
  constexpr int kTile = Shape<D>::kTile;
  constexpr int kVec = Shape<D>::kVec;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int bh = blockIdx.y;                 // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;     // this thread's share of D
  const bool live = row < S;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;
  // the lanes of this row's partners, for the dot-product shuffle
  const unsigned lane = threadIdx.x & 31;
  const unsigned pair_mask = ((1u << kSplit) - 1u) << (lane & ~(kSplit - 1u));

  // register j*4.. holds columns (j*kSplit + part)*4 ..+3
  float qr[4 * kVec], acc[4 * kVec];
  const float* qp = q + ((size_t)bh * S + (live ? row : 0)) * D;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = (j * kSplit + part) * 4;
    float4 t = live ? *reinterpret_cast<const float4*>(qp + d)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[4 * j] = t.x; qr[4 * j + 1] = t.y; qr[4 * j + 2] = t.z;
    qr[4 * j + 3] = t.w;
    acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) {
    const int last = min(q0 + kRows, S);     // one past the block's last row
    n_tiles = min(n_tiles, (last + kTile - 1) / kTile);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                         // previous tile consumed
    for (int i = threadIdx.x; i < kTile * D / 4; i += Shape<D>::kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < S) {
        const size_t off = kv_base + (size_t)(k0 + r) * D + c;
        kv4 = *reinterpret_cast<const float4*>(k + off);
        vv4 = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(&ks[r][c]) = kv4;
      *reinterpret_cast<float4*>(&vs[r][c]) = vv4;
    }
    __syncthreads();
    if (!live) continue;
    // valid keys of this tile; a row's partners agree on it, so they take
    // every shuffle below together
    int kend = min(kTile, S - k0);
    if (causal) kend = min(kend, row - k0 + 1);
    for (int c0 = 0; c0 < kend; c0 += kChunk) {
      float s[kChunk];
      float mc = -INFINITY;
#pragma unroll
      for (int jk = 0; jk < kChunk; ++jk) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int d = (j * kSplit + part) * 4;
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + jk][d]);
          dot = fmaf(qr[4 * j], kk.x, dot);
          dot = fmaf(qr[4 * j + 1], kk.y, dot);
          dot = fmaf(qr[4 * j + 2], kk.z, dot);
          dot = fmaf(qr[4 * j + 3], kk.w, dot);
        }
        // butterfly: every partner ends with the same (commuted) sum
#pragma unroll
        for (int off = 1; off < kSplit; off <<= 1)
          dot += __shfl_xor_sync(pair_mask, dot, off);
        s[jk] = (c0 + jk < kend) ? dot * scale : -INFINITY;
        mc = fmaxf(mc, s[jk]);
      }
      // s[0] is a valid key (c0 < kend), so m_new is finite
      const float m_new = fmaxf(m, mc);
      const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < 4 * kVec; ++d) acc[d] *= corr;
#pragma unroll
      for (int jk = 0; jk < kChunk; ++jk) {
        const float p = (s[jk] == -INFINITY) ? 0.f : expf(s[jk] - m_new);
        l += p;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int d = (j * kSplit + part) * 4;
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + jk][d]);
          acc[4 * j] = fmaf(p, vv.x, acc[4 * j]);
          acc[4 * j + 1] = fmaf(p, vv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(p, vv.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(p, vv.w, acc[4 * j + 3]);
        }
      }
      m = m_new;
    }
  }
  if (!live) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  float* op = o + ((size_t)bh * S + row) * D;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = (j * kSplit + part) * 4;
    *reinterpret_cast<float4*>(op + d) =
        make_float4(acc[4 * j] / l_safe, acc[4 * j + 1] / l_safe,
                    acc[4 * j + 2] / l_safe, acc[4 * j + 3] / l_safe);
  }
  if (part == 0)
    lse[(size_t)bh * S + row] = (l == 0.f) ? INFINITY : m + logf(l_safe);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int H, int Hkv, int S, float scale,
                   int causal, cudaStream_t stream) {
  dim3 grid((S + kRows - 1) / kRows, B * H);
  flash_fwd_f32<D><<<grid, Shape<D>::kThreads, 0, stream>>>(
      q, k, v, o, lse, H, Hkv, S, scale, causal);
  return cudaGetLastError();
}

constexpr int kWideRows = 32;    // q rows per block
constexpr int kWideSplit = 8;    // threads per row
constexpr int kWideTile = 16;    // keys per K/V tile (one softmax chunk)
constexpr int kWideThreads = kWideRows * kWideSplit;

template <int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int H, int Hkv, int S,
                   float scale, int causal) {
  constexpr int D = 128 * NC;
  extern __shared__ __align__(16) float wide_smem[];
  float* ks = wide_smem;                     // [kWideTile][D]
  float* vs = wide_smem + kWideTile * D;     // [kWideTile][D]

  const int bh = blockIdx.y;                 // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int q0 = blockIdx.x * kWideRows;
  const int row = q0 + threadIdx.x / kWideSplit;
  const int part = threadIdx.x % kWideSplit;
  const bool live = row < S;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;
  const unsigned lane = threadIdx.x & 31;
  const unsigned pair_mask = 0xffu << (lane & ~(kWideSplit - 1u));

  // acc[16 * c + 4 * j + e] is column c * 128 + (j * 8 + part) * 4 + e
  float acc[16 * NC];
#pragma unroll
  for (int i = 0; i < 16 * NC; ++i) acc[i] = 0.f;
  const float* qp = q + ((size_t)bh * S + (live ? row : 0)) * D + part * 4;
  float m = -INFINITY, l = 0.f;

  int n_tiles = (S + kWideTile - 1) / kWideTile;
  if (causal) {
    const int last = min(q0 + kWideRows, S);
    n_tiles = min(n_tiles, (last + kWideTile - 1) / kWideTile);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kWideTile;
    __syncthreads();                         // previous tile consumed
    for (int i = threadIdx.x; i < kWideTile * D / 4; i += kWideThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < S) {
        const size_t off = kv_base + (size_t)(k0 + r) * D + c;
        kv4 = *reinterpret_cast<const float4*>(k + off);
        vv4 = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(ks + r * D + c) = kv4;
      *reinterpret_cast<float4*>(vs + r * D + c) = vv4;
    }
    __syncthreads();
    if (!live) continue;
    int kend = min(kWideTile, S - k0);
    if (causal) kend = min(kend, row - k0 + 1);
    if (kend <= 0) continue;                 // partners agree: same row
    float s[kWideTile];
#pragma unroll
    for (int jk = 0; jk < kWideTile; ++jk) s[jk] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      float4 qv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qv[j] = __ldg(reinterpret_cast<const float4*>(qp + c * 128 + j * 32));
#pragma unroll
      for (int jk = 0; jk < kWideTile; ++jk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(
              ks + jk * D + c * 128 + (j * 8 + part) * 4);
          s[jk] = fmaf(qv[j].x, kk.x, s[jk]);
          s[jk] = fmaf(qv[j].y, kk.y, s[jk]);
          s[jk] = fmaf(qv[j].z, kk.z, s[jk]);
          s[jk] = fmaf(qv[j].w, kk.w, s[jk]);
        }
      }
    }
    float mc = -INFINITY;
#pragma unroll
    for (int jk = 0; jk < kWideTile; ++jk) {
#pragma unroll
      for (int off = 1; off < kWideSplit; off <<= 1)
        s[jk] += __shfl_xor_sync(pair_mask, s[jk], off);
      s[jk] = (jk < kend) ? s[jk] * scale : -INFINITY;
      mc = fmaxf(mc, s[jk]);
    }
    const float m_new = fmaxf(m, mc);        // s[0] is valid: finite
    const float corr = (m == -INFINITY) ? 0.f : expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < 16 * NC; ++i) acc[i] *= corr;
#pragma unroll
    for (int jk = 0; jk < kWideTile; ++jk) {
      const float p = (s[jk] == -INFINITY) ? 0.f : expf(s[jk] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(
              vs + jk * D + c * 128 + (j * 8 + part) * 4);
          float* a = &acc[16 * c + 4 * j];
          a[0] = fmaf(p, vv.x, a[0]);
          a[1] = fmaf(p, vv.y, a[1]);
          a[2] = fmaf(p, vv.z, a[2]);
          a[3] = fmaf(p, vv.w, a[3]);
        }
      }
    }
    m = m_new;
  }
  if (!live) return;
  const float l_safe = (l == 0.f) ? 1.f : l;
  float* op = o + ((size_t)bh * S + row) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* a = &acc[16 * c + 4 * j];
      *reinterpret_cast<float4*>(op + c * 128 + j * 32) =
          make_float4(a[0] / l_safe, a[1] / l_safe, a[2] / l_safe,
                      a[3] / l_safe);
    }
  }
  if (part == 0)
    lse[(size_t)bh * S + row] = (l == 0.f) ? INFINITY : m + logf(l_safe);
}

template <int NC>
cudaError_t launch_wide(const float* q, const float* k, const float* v,
                        float* o, float* lse, int B, int H, int Hkv, int S,
                        float scale, int causal, cudaStream_t stream) {
  const int smem = 2 * kWideTile * 128 * NC * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wide_f32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + kWideRows - 1) / kWideRows, B * H);
  flash_fwd_wide_f32<NC><<<grid, kWideThreads, smem, stream>>>(
      q, k, v, o, lse, H, Hkv, S, scale, causal);
  return cudaGetLastError();
}

}  // namespace

// q (B,H,S,D), k/v (B,Hkv,S,D), o (B,H,S,D), lse (B,H,S): contiguous f32.
extern "C" int mxt_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int Hkv,
                                 int S, int D, float scale, int causal,
                                 int device, void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (S <= 0 || B * H <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto kf = static_cast<const float*>(k);
  auto vf = static_cast<const float*>(v);
  auto of = static_cast<float*>(o);
  auto lf = static_cast<float*>(lse);
  switch (D) {
    case 16: return launch<16>(qf, kf, vf, of, lf, B, H, Hkv, S, scale,
                               causal, st);
    case 32: return launch<32>(qf, kf, vf, of, lf, B, H, Hkv, S, scale,
                               causal, st);
    case 64: return launch<64>(qf, kf, vf, of, lf, B, H, Hkv, S, scale,
                               causal, st);
    case 128: return launch<128>(qf, kf, vf, of, lf, B, H, Hkv, S, scale,
                                 causal, st);
    case 256: return launch<256>(qf, kf, vf, of, lf, B, H, Hkv, S, scale,
                                 causal, st);
#define MXT_WIDE(NC)                                                     \
    case 128 * NC: return launch_wide<NC>(qf, kf, vf, of, lf, B, H, Hkv, \
                                          S, scale, causal, st);
    MXT_WIDE(3) MXT_WIDE(4)
#undef MXT_WIDE
    default: return cudaErrorInvalidValue;
  }
}
