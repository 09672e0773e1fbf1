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
//    D <= 64, D/64 above); each thread keeps its share of the row's q
//    vector and output accumulator in registers (2*D/kSplit floats, so
//    D = 128 holds as many as D = 64 and does not spill), and the partners
//    of a row sum their partial dot products with one warp shuffle;
//  * K/V tiles (64 keys, 32 at D = 128 to stay within 48 KB) are staged in
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
    default: return cudaErrorInvalidValue;
  }
}
