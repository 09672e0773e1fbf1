// Flash attention backward, float32, for Hopper (sm_90a): dQ and dK/dV.
//
// Replaces: mxnet_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (both launched by _flash_pallas_bwd). Same
// function, by recompute from the forward's per-row logsumexp, with no
// (S, S) matrix in device memory:
//   s_ij  = q_i . k_j * scale            (masked: j > i when causal)
//   p_ij  = exp(s_ij - lse_i)            (0 on masked keys, and on rows
//                                         whose lse is not finite: the
//                                         forward's +inf sentinel for a
//                                         row with no valid key)
//   delta_i = dO_i . O_i - glse_i        (glse: the lse output's
//                                         cotangent, NULL means zeros)
//   dS_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   dQ_i  = sum_j dS_ij k_j,   dK_j = sum_i dS_ij q_i,   dV_j = sum_i p_ij dO_i
// K/V of q head h are those of kv head h / (H / H_kv) (GQA by index). The
// dK/dV kernel writes one partial per q head, (B, H, S, D); the caller sums
// each GQA group, as the TPU path does outside its kernel.
//
// What bounds it on the H100: operations. dQ does 3 dot products of length
// D per (q row, key) pair (6*D flops), dK/dV 4 (8*D flops); causal S = 1024
// gives ~400 flops per byte moved, and float32 inputs leave the tensor cores
// out, so the ceiling is the 67 TFLOP/s of the FP32 pipes. The design:
//  * the TPU's two-kernel split: dQ gridded over (q tile, b*h), each block
//    streaming K/V tiles through shared memory; dK/dV gridded over
//    (key tile, b*h), each block streaming Q/dO tiles. Every output element
//    is written by one thread, summed in a fixed order, without atomics: a
//    given input gives bit-identical gradients from run to run;
//  * a row is split over D/16 threads of one warp (one below D = 16), each
//    owning 16 of its D columns (float4 columns dealt in turn, so the
//    partners of a row read different banks): dQ keeps q, dO and the dQ
//    accumulator in registers (3 x 16 floats), dK/dV keeps k, v, dK and dV
//    (4 x 16), so no width spills (32 columns a thread spilled dQ at
//    255 registers); partners sum their partial dot products with a
//    butterfly of shuffles, which leaves the same sum in every partner;
//  * dot products for kChunk keys (or q rows) are formed before their
//    shuffles, and the rank-1 updates after, so the shuffles overlap;
//  * delta is recomputed in each kernel, as on the TPU: dQ from its own
//    q and O rows, dK/dV once per Q/dO tile (O read from device memory);
//  * causal: dQ stops at the diagonal tile and each row at its own key;
//    dK/dV starts at the first q tile that can see the block's first key
//    (k0 / tile) and each key at its own row;
//  * a ragged S is masked: rows and keys past S do no work and are never
//    read into a sum.
// Tensor cores (wgmma on bf16, TMA) and one fused FA-2-style kernel are a
// later step.
//
// Head dims above 256 (D = 128 * NC: 384 and 512) take the "wide" kernels
// below. D/16 partners per row would fill a warp at 512 (and be no power of
// two at 384), so the split is fixed and the loop runs over D in 128-column
// chunks instead:
//  * dQ: 16 threads per q row, 16 rows per block; a thread owns 8 columns
//    of every chunk and keeps only its dQ accumulator in registers
//    (8 * NC floats); the block's q and dO rows are staged once in dynamic
//    shared memory, and K/V tiles of 8 keys stream beside them, all 8
//    keys' dot products formed before their shuffles (192 * D bytes:
//    96 KB at D = 512, two blocks an SM). Reading q and dO from device
//    memory instead, as the forward reads q, made ptxas keep 32 registers
//    and spill 16-22 KB at D = 384/512 (H100 build);
//  * dK/dV: 16 threads per key, 16 keys per block; a thread owns 8 columns
//    of every chunk and keeps dK and dV in registers (16 * NC floats), its
//    k and v columns re-read per 8 q rows (L1-resident); Q/dO tiles of 16
//    rows sit in dynamic shared memory (128 * D bytes);
//  * both butterflies stay inside one warp (8 and 16 aligned lanes).
// 512 is the ceiling: at D = 768 the dK/dV accumulators spilled at 255
// registers (ptxas -v on the H100 build).

#include <math.h>

#include "mxt_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;

template <int D>
struct Split {
  static constexpr int kCols = D < 16 ? D : 16;    // columns per thread
  static constexpr int kSplit = D / kCols;         // threads per row
  static constexpr int kRows = kThreads / kSplit;  // rows per block
  static constexpr int kVec = kCols / 4;           // float4 per thread
  static constexpr int kTile = D > 64 ? 4096 / D : 64;  // rows per smem tile
};

// Lanes of this thread's row partners (kSplit consecutive, aligned lanes).
template <int kSplit>
__device__ __forceinline__ unsigned partner_mask() {
  const unsigned lane = threadIdx.x & 31;
  static_assert(kSplit >= 1 && kSplit <= 16, "partners within half a warp");
  return ((1u << kSplit) - 1u) << (lane & ~(kSplit - 1u));
}

template <int kSplit>
__device__ __forceinline__ float row_sum(float x, unsigned mask) {
#pragma unroll
  for (int off = 1; off < kSplit; off <<= 1)
    x += __shfl_xor_sync(mask, x, off);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 x, float* y) {
  y[0] = fmaf(a, x.x, y[0]);
  y[1] = fmaf(a, x.y, y[1]);
  y[2] = fmaf(a, x.z, y[2]);
  y[3] = fmaf(a, x.w, y[3]);
}

// rows [r0, r0 + T) of a (S, D) matrix into shared memory; rows past S are 0
template <int D, int T>
__device__ __forceinline__ void load_tile(float (*dst)[D],
                                          const float* __restrict__ src,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < T * D / 4; i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) x = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<float4*>(&dst[r][c]) = x;
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, b*h); kSplit threads per q row
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ glse, float* __restrict__ dq,
                 int H, int Hkv, int S, float scale, int causal) {
  using P = Split<D>;
  constexpr int kSplit = P::kSplit, kRows = P::kRows, kVec = P::kVec;
  constexpr int kTile = P::kTile;
  __shared__ __align__(16) float ks[kTile][D];
  __shared__ __align__(16) float vs[kTile][D];

  const int bh = blockIdx.y;                 // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int q0 = blockIdx.x * kRows;
  const int row = q0 + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;
  const bool live = row < S;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;
  const unsigned mask = partner_mask<kSplit>();

  // register 4*j.. holds columns (j*kSplit + part)*4 ..+3
  float qr[4 * kVec], dor[4 * kVec], acc[4 * kVec];
  const size_t roff = ((size_t)bh * S + (live ? row : 0)) * D;
  float dd = 0.f;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = (j * kSplit + part) * 4;
    float4 tq = make_float4(0.f, 0.f, 0.f, 0.f), tdo = tq, to = tq;
    if (live) {
      tq = *reinterpret_cast<const float4*>(q + roff + d);
      tdo = *reinterpret_cast<const float4*>(dout + roff + d);
      to = *reinterpret_cast<const float4*>(o + roff + d);
    }
    dd = dot4(tdo, to, dd);
    qr[4 * j] = tq.x; qr[4 * j + 1] = tq.y; qr[4 * j + 2] = tq.z;
    qr[4 * j + 3] = tq.w;
    dor[4 * j] = tdo.x; dor[4 * j + 1] = tdo.y; dor[4 * j + 2] = tdo.z;
    dor[4 * j + 3] = tdo.w;
    acc[4 * j] = acc[4 * j + 1] = acc[4 * j + 2] = acc[4 * j + 3] = 0.f;
  }
  float delta = row_sum<kSplit>(dd, mask);
  float lse_r = INFINITY;
  if (live) {
    lse_r = lse[(size_t)bh * S + row];
    if (glse != nullptr) delta -= glse[(size_t)bh * S + row];
  }
  const bool empty = !isfinite(lse_r);       // no valid key: p = 0, dQ = 0

  int n_tiles = (S + kTile - 1) / kTile;
  if (causal) {
    const int last = min(q0 + kRows, S);     // one past the block's last row
    n_tiles = min(n_tiles, (last + kTile - 1) / kTile);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();                         // previous tile consumed
    load_tile<D, kTile>(ks, k + kv_base, k0, S);
    load_tile<D, kTile>(vs, v + kv_base, k0, S);
    __syncthreads();
    if (!live || empty) continue;
    // valid keys of this tile; a row's partners agree on it, so they take
    // every shuffle below together
    int kend = min(kTile, S - k0);
    if (causal) kend = min(kend, row - k0 + 1);
    for (int c0 = 0; c0 < kend; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jk = 0; jk < kChunk; ++jk) {
        float a = 0.f, c = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int d = (j * kSplit + part) * 4;
          const float4 kk = *reinterpret_cast<const float4*>(&ks[c0 + jk][d]);
          const float4 vv = *reinterpret_cast<const float4*>(&vs[c0 + jk][d]);
          a = dot4(make_float4(qr[4 * j], qr[4 * j + 1], qr[4 * j + 2],
                               qr[4 * j + 3]), kk, a);
          c = dot4(make_float4(dor[4 * j], dor[4 * j + 1], dor[4 * j + 2],
                               dor[4 * j + 3]), vv, c);
        }
        s[jk] = a;
        dp[jk] = c;
      }
#pragma unroll
      for (int jk = 0; jk < kChunk; ++jk) {
        s[jk] = row_sum<kSplit>(s[jk], mask);
        dp[jk] = row_sum<kSplit>(dp[jk], mask);
      }
#pragma unroll
      for (int jk = 0; jk < kChunk; ++jk) {
        const float p = (c0 + jk < kend) ? expf(s[jk] * scale - lse_r) : 0.f;
        const float ds = p * (dp[jk] - delta) * scale;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int d = (j * kSplit + part) * 4;
          axpy4(ds, *reinterpret_cast<const float4*>(&ks[c0 + jk][d]),
                &acc[4 * j]);
        }
      }
    }
  }
  if (!live) return;
  float* out = dq + (size_t)(bh * (size_t)S + row) * D;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = (j * kSplit + part) * 4;
    *reinterpret_cast<float4*>(out + d) =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (key tile, b*h over q heads); kSplit threads per key
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ glse, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int Hkv, int S, float scale,
                  int causal) {
  using P = Split<D>;
  constexpr int kSplit = P::kSplit, kRows = P::kRows, kVec = P::kVec;
  constexpr int kTile = P::kTile;            // q rows per shared tile
  constexpr int kDT = kThreads / kTile;      // threads per row for delta
  static_assert(kDT * kTile == kThreads && kDT <= 32, "delta split");
  __shared__ __align__(16) float qs[kTile][D];
  __shared__ __align__(16) float dos[kTile][D];
  __shared__ float lse_s[kTile];
  __shared__ float delta_s[kTile];

  const int bh = blockIdx.y;                 // b * H + h (q head)
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int k0 = blockIdx.x * kRows;
  const int key = k0 + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;
  const bool live = key < S;
  const size_t q_base = (size_t)bh * S * D;
  const unsigned mask = partner_mask<kSplit>();

  float kr[4 * kVec], vr[4 * kVec], dka[4 * kVec], dva[4 * kVec];
  const size_t koff = ((size_t)(b * Hkv + hk) * S + (live ? key : 0)) * D;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = (j * kSplit + part) * 4;
    float4 tk = make_float4(0.f, 0.f, 0.f, 0.f), tv = tk;
    if (live) {
      tk = *reinterpret_cast<const float4*>(k + koff + d);
      tv = *reinterpret_cast<const float4*>(v + koff + d);
    }
    kr[4 * j] = tk.x; kr[4 * j + 1] = tk.y; kr[4 * j + 2] = tk.z;
    kr[4 * j + 3] = tk.w;
    vr[4 * j] = tv.x; vr[4 * j + 1] = tv.y; vr[4 * j + 2] = tv.z;
    vr[4 * j + 3] = tv.w;
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[4 * j + e] = dva[4 * j + e] = 0.f;
  }

  const int n_tiles = (S + kTile - 1) / kTile;
  const int t_first = causal ? k0 / kTile : 0;
  for (int t = t_first; t < n_tiles; ++t) {
    const int r0 = t * kTile;
    __syncthreads();                         // previous tile consumed
    load_tile<D, kTile>(qs, q + q_base, r0, S);
    load_tile<D, kTile>(dos, dout + q_base, r0, S);
    __syncthreads();
    {
      // delta and lse of the tile's rows: kDT threads per row
      const int r = threadIdx.x / kDT, p = threadIdx.x % kDT;
      const bool in = r0 + r < S;
      float acc = 0.f;
      if (in) {
        const float* orow = o + q_base + (size_t)(r0 + r) * D;
        for (int c = p * 4; c < D; c += kDT * 4)
          acc = dot4(*reinterpret_cast<const float4*>(&dos[r][c]),
                     *reinterpret_cast<const float4*>(orow + c), acc);
      }
      acc = row_sum<kDT>(acc, partner_mask<kDT>());
      if (p == 0) {
        float l = INFINITY, g = 0.f;
        if (in) {
          l = lse[(size_t)bh * S + r0 + r];
          if (glse != nullptr) g = glse[(size_t)bh * S + r0 + r];
        }
        lse_s[r] = isfinite(l) ? l : INFINITY;   // empty row: p = 0
        delta_s[r] = acc - g;
      }
    }
    __syncthreads();
    if (!live) continue;
    // q rows of this tile that see this key; partners agree on the range
    const int ibeg = causal ? max(0, key - r0) : 0;
    const int iend = min(kTile, S - r0);
    for (int c0 = ibeg; c0 < iend; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jr = 0; jr < kChunk; ++jr) {
        const int i = min(c0 + jr, kTile - 1);
        float a = 0.f, c = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const int d = (j * kSplit + part) * 4;
          const float4 qq = *reinterpret_cast<const float4*>(&qs[i][d]);
          const float4 gg = *reinterpret_cast<const float4*>(&dos[i][d]);
          a = dot4(make_float4(kr[4 * j], kr[4 * j + 1], kr[4 * j + 2],
                               kr[4 * j + 3]), qq, a);
          c = dot4(make_float4(vr[4 * j], vr[4 * j + 1], vr[4 * j + 2],
                               vr[4 * j + 3]), gg, c);
        }
        s[jr] = a;
        dp[jr] = c;
      }
#pragma unroll
      for (int jr = 0; jr < kChunk; ++jr) {
        s[jr] = row_sum<kSplit>(s[jr], mask);
        dp[jr] = row_sum<kSplit>(dp[jr], mask);
      }
#pragma unroll
      for (int jr = 0; jr < kChunk; ++jr) {
        const int i = c0 + jr;
        if (i < iend) {
          const float p = expf(s[jr] * scale - lse_s[i]);
          const float ds = p * (dp[jr] - delta_s[i]) * scale;
#pragma unroll
          for (int j = 0; j < kVec; ++j) {
            const int d = (j * kSplit + part) * 4;
            axpy4(p, *reinterpret_cast<const float4*>(&dos[i][d]),
                  &dva[4 * j]);
            axpy4(ds, *reinterpret_cast<const float4*>(&qs[i][d]),
                  &dka[4 * j]);
          }
        }
      }
    }
  }
  if (!live) return;
  const size_t out = ((size_t)bh * S + key) * D;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int d = (j * kSplit + part) * 4;
    *reinterpret_cast<float4*>(dk + out + d) = make_float4(
        dka[4 * j], dka[4 * j + 1], dka[4 * j + 2], dka[4 * j + 3]);
    *reinterpret_cast<float4*>(dv + out + d) = make_float4(
        dva[4 * j], dva[4 * j + 1], dva[4 * j + 2], dva[4 * j + 3]);
  }
}

// ---------------------------------------------------------------------------
// wide head dims: D = 128 * NC
// ---------------------------------------------------------------------------
constexpr int kWideTile = 16;                // keys (dQ) or q rows (dK/dV)
constexpr int kWideThreads = 256;

constexpr int kDqRows = 16;                  // dQ: q rows per block
constexpr int kDqTile = 8;                   // dQ: keys per K/V tile

template <int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide_f32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ o,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ glse, float* __restrict__ dq,
                      int H, int Hkv, int S, float scale, int causal) {
  constexpr int D = 128 * NC;
  constexpr int kSplit = kWideThreads / kDqRows;   // 16 threads per row
  extern __shared__ __align__(16) float wide_smem[];
  float* ks = wide_smem;                     // [kDqTile][D]
  float* vs = ks + kDqTile * D;
  float* qs = vs + kDqTile * D;              // [kDqRows][D]: the block's rows
  float* gs = qs + kDqRows * D;              // [kDqRows][D]: their dO

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int q0 = blockIdx.x * kDqRows;
  const int r_loc = threadIdx.x / kSplit;
  const int row = q0 + r_loc;
  const int part = threadIdx.x % kSplit;
  const bool live = row < S;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;
  const size_t q_base = (size_t)bh * S * D;
  const unsigned mask = partner_mask<kSplit>();

  for (int i = threadIdx.x; i < kDqRows * D / 4; i += kWideThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), g = x;
    if (q0 + r < S) {
      const size_t off = q_base + (size_t)(q0 + r) * D + c;
      x = *reinterpret_cast<const float4*>(q + off);
      g = *reinterpret_cast<const float4*>(dout + off);
    }
    *reinterpret_cast<float4*>(qs + r * D + c) = x;
    *reinterpret_cast<float4*>(gs + r * D + c) = g;
  }
  __syncthreads();
  // this thread's column j of chunk c: c * 128 + j * 64 + part * 4 (+0..3)
  const float* qr = qs + r_loc * D + part * 4;
  const float* gr = gs + r_loc * D + part * 4;

  float acc[8 * NC];
  float dd = 0.f;
  const float* orow = o + q_base + (size_t)(live ? row : 0) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = c * 128 + j * 64;
      if (live)
        dd = dot4(*reinterpret_cast<const float4*>(gr + d),
                  *reinterpret_cast<const float4*>(orow + d), dd);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[8 * c + 4 * j + e] = 0.f;
    }
  }
  float delta = row_sum<kSplit>(dd, mask);
  float lse_r = INFINITY;
  if (live) {
    lse_r = lse[(size_t)bh * S + row];
    if (glse != nullptr) delta -= glse[(size_t)bh * S + row];
  }
  const bool empty = !isfinite(lse_r);

  int n_tiles = (S + kDqTile - 1) / kDqTile;
  if (causal) {
    const int last = min(q0 + kDqRows, S);
    n_tiles = min(n_tiles, (last + kDqTile - 1) / kDqTile);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kDqTile;
    __syncthreads();
    for (int i = threadIdx.x; i < kDqTile * D / 4; i += kWideThreads) {
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
    if (!live || empty) continue;
    int kend = min(kDqTile, S - k0);
    if (causal) kend = min(kend, row - k0 + 1);
    if (kend <= 0) continue;                 // partners agree: same row
    // the tile's keys at once: partial dot products over the chunks, then
    // one butterfly per key
    float s[kDqTile], dp[kDqTile];
#pragma unroll
    for (int jk = 0; jk < kDqTile; ++jk) s[jk] = dp[jk] = 0.f;
    // one chunk at a time: unrolled over the chunks, the compiler issued
    // every shared load of the tile at once and spilled at D = 512
#pragma unroll 1
    for (int c = 0; c < NC; ++c) {
      float4 qv[2], gv[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        qv[j] = *reinterpret_cast<const float4*>(qr + c * 128 + j * 64);
        gv[j] = *reinterpret_cast<const float4*>(gr + c * 128 + j * 64);
      }
#pragma unroll
      for (int jk = 0; jk < kDqTile; ++jk) {
        const float* kr = ks + jk * D + c * 128 + part * 4;
        const float* vr = vs + jk * D + c * 128 + part * 4;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[jk] = dot4(qv[j], *reinterpret_cast<const float4*>(kr + j * 64),
                       s[jk]);
          dp[jk] = dot4(gv[j], *reinterpret_cast<const float4*>(vr + j * 64),
                        dp[jk]);
        }
      }
    }
#pragma unroll
    for (int jk = 0; jk < kDqTile; ++jk) {
      s[jk] = row_sum<kSplit>(s[jk], mask);
      dp[jk] = row_sum<kSplit>(dp[jk], mask);
    }
#pragma unroll
    for (int jk = 0; jk < kDqTile; ++jk) {
      const float p = (jk < kend) ? expf(s[jk] * scale - lse_r) : 0.f;
      const float ds = p * (dp[jk] - delta) * scale;
      const float* kr = ks + jk * D + part * 4;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
          axpy4(ds, *reinterpret_cast<const float4*>(kr + c * 128 + j * 64),
                &acc[8 * c + 4 * j]);
      }
    }
  }
  if (!live) return;
  float* out = dq + ((size_t)bh * S + row) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* a = &acc[8 * c + 4 * j];
      *reinterpret_cast<float4*>(out + c * 128 + j * 64) =
          make_float4(a[0], a[1], a[2], a[3]);
    }
  }
}

template <int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkv_wide_f32(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ o,
                       const float* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ glse, float* __restrict__ dk,
                       float* __restrict__ dv, int H, int Hkv, int S,
                       float scale, int causal) {
  constexpr int D = 128 * NC;
  constexpr int kSplit = 16;
  constexpr int kRows = kWideThreads / kSplit;   // keys per block
  constexpr int kDT = kWideThreads / kWideTile;  // threads per row for delta
  extern __shared__ __align__(16) float wide_smem[];
  float* qs = wide_smem;                     // [kWideTile][D]
  float* dos = wide_smem + kWideTile * D;
  __shared__ float lse_s[kWideTile];
  __shared__ float delta_s[kWideTile];

  const int bh = blockIdx.y;                 // b * H + h (q head)
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int k0 = blockIdx.x * kRows;
  const int key = k0 + threadIdx.x / kSplit;
  const int part = threadIdx.x % kSplit;
  const bool live = key < S;
  const size_t q_base = (size_t)bh * S * D;
  const unsigned mask = partner_mask<kSplit>();
  // this thread's column j of chunk c: c * 128 + j * 64 + part * 4 (+0..3)
  const size_t koff = ((size_t)(b * Hkv + hk) * S + (live ? key : 0)) * D
                      + part * 4;
  const float* kp = k + koff;
  const float* vp = v + koff;

  float dka[8 * NC], dva[8 * NC];
#pragma unroll
  for (int i = 0; i < 8 * NC; ++i) dka[i] = dva[i] = 0.f;

  const int n_tiles = (S + kWideTile - 1) / kWideTile;
  const int t_first = causal ? k0 / kWideTile : 0;
  for (int t = t_first; t < n_tiles; ++t) {
    const int r0 = t * kWideTile;
    __syncthreads();
    for (int i = threadIdx.x; i < kWideTile * D / 4; i += kWideThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), g = x;
      if (r0 + r < S) {
        const size_t off = q_base + (size_t)(r0 + r) * D + c;
        x = *reinterpret_cast<const float4*>(q + off);
        g = *reinterpret_cast<const float4*>(dout + off);
      }
      *reinterpret_cast<float4*>(qs + r * D + c) = x;
      *reinterpret_cast<float4*>(dos + r * D + c) = g;
    }
    __syncthreads();
    {
      const int r = threadIdx.x / kDT, p = threadIdx.x % kDT;
      const bool in = r0 + r < S;
      float acc = 0.f;
      if (in) {
        const float* orow = o + q_base + (size_t)(r0 + r) * D;
        for (int c = p * 4; c < D; c += kDT * 4)
          acc = dot4(*reinterpret_cast<const float4*>(dos + r * D + c),
                     *reinterpret_cast<const float4*>(orow + c), acc);
      }
      acc = row_sum<kDT>(acc, partner_mask<kDT>());
      if (p == 0) {
        float l = INFINITY, g = 0.f;
        if (in) {
          l = lse[(size_t)bh * S + r0 + r];
          if (glse != nullptr) g = glse[(size_t)bh * S + r0 + r];
        }
        lse_s[r] = isfinite(l) ? l : INFINITY;
        delta_s[r] = acc - g;
      }
    }
    __syncthreads();
    if (!live) continue;
    const int ibeg = causal ? max(0, key - r0) : 0;
    const int iend = min(kWideTile, S - r0);
    for (int c0 = ibeg; c0 < iend; c0 += kChunk) {
      float s[kChunk], dp[kChunk];
#pragma unroll
      for (int jr = 0; jr < kChunk; ++jr) s[jr] = dp[jr] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float4 kv[2], vv[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          kv[j] = __ldg(reinterpret_cast<const float4*>(kp + c * 128 + j * 64));
          vv[j] = __ldg(reinterpret_cast<const float4*>(vp + c * 128 + j * 64));
        }
#pragma unroll
        for (int jr = 0; jr < kChunk; ++jr) {
          const int i = min(c0 + jr, kWideTile - 1);
          const float* qr = qs + i * D + c * 128 + part * 4;
          const float* gr = dos + i * D + c * 128 + part * 4;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            s[jr] = dot4(kv[j], *reinterpret_cast<const float4*>(qr + j * 64),
                         s[jr]);
            dp[jr] = dot4(vv[j], *reinterpret_cast<const float4*>(gr + j * 64),
                          dp[jr]);
          }
        }
      }
#pragma unroll
      for (int jr = 0; jr < kChunk; ++jr) {
        s[jr] = row_sum<kSplit>(s[jr], mask);
        dp[jr] = row_sum<kSplit>(dp[jr], mask);
      }
#pragma unroll
      for (int jr = 0; jr < kChunk; ++jr) {
        const int i = c0 + jr;
        if (i < iend) {
          const float p = expf(s[jr] * scale - lse_s[i]);
          const float ds = p * (dp[jr] - delta_s[i]) * scale;
          const float* qr = qs + i * D + part * 4;
          const float* gr = dos + i * D + part * 4;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              axpy4(p, *reinterpret_cast<const float4*>(gr + c * 128 + j * 64),
                    &dva[8 * c + 4 * j]);
              axpy4(ds, *reinterpret_cast<const float4*>(qr + c * 128 + j * 64),
                    &dka[8 * c + 4 * j]);
            }
          }
        }
      }
    }
  }
  if (!live) return;
  const size_t out = ((size_t)bh * S + key) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = c * 128 + j * 64;
      const float* a = &dka[8 * c + 4 * j];
      const float* g = &dva[8 * c + 4 * j];
      *reinterpret_cast<float4*>(dk + out + d) =
          make_float4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<float4*>(dv + out + d) =
          make_float4(g[0], g[1], g[2], g[3]);
    }
  }
}

struct Args {
  const float *q, *k, *v, *o, *dout, *lse, *glse;
  float *a, *b;                              // dq | dk, dv
  int B, H, Hkv, S;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& x) {
  constexpr int kRows = Split<D>::kRows;
  dim3 grid((x.S + kRows - 1) / kRows, x.B * x.H);
  flash_bwd_dq_f32<D><<<grid, kThreads, 0, x.stream>>>(
      x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, x.a, x.H, x.Hkv, x.S,
      x.scale, x.causal);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& x) {
  constexpr int kRows = Split<D>::kRows;
  dim3 grid((x.S + kRows - 1) / kRows, x.B * x.H);
  flash_bwd_dkv_f32<D><<<grid, kThreads, 0, x.stream>>>(
      x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, x.a, x.b, x.H, x.Hkv, x.S,
      x.scale, x.causal);
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_wide(bool dkv, const Args& x) {
  // dK/dV: Q/dO tiles of 16 rows; dQ: K/V tiles of 8 keys and its 16
  // rows' q and dO
  const int smem = (dkv ? 2 * kWideTile : 2 * kDqTile + 2 * kDqRows) * 128
                   * NC * (int)sizeof(float);
  if (dkv) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_wide_f32<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((x.S + 15) / 16, x.B * x.H);
    flash_bwd_dkv_wide_f32<NC><<<grid, kWideThreads, smem, x.stream>>>(
        x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, x.a, x.b, x.H, x.Hkv, x.S,
        x.scale, x.causal);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_wide_f32<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((x.S + kDqRows - 1) / kDqRows, x.B * x.H);
    flash_bwd_dq_wide_f32<NC><<<grid, kWideThreads, smem, x.stream>>>(
        x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, x.a, x.H, x.Hkv, x.S,
        x.scale, x.causal);
  }
  return cudaGetLastError();
}

cudaError_t run(bool dkv, int D, const Args& x) {
  switch (D) {
    case 16: return dkv ? launch_dkv<16>(x) : launch_dq<16>(x);
    case 32: return dkv ? launch_dkv<32>(x) : launch_dq<32>(x);
    case 64: return dkv ? launch_dkv<64>(x) : launch_dq<64>(x);
    case 128: return dkv ? launch_dkv<128>(x) : launch_dq<128>(x);
    case 256: return dkv ? launch_dkv<256>(x) : launch_dq<256>(x);
    case 384: return launch_wide<3>(dkv, x);
    case 512: return launch_wide<4>(dkv, x);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t prepare(int device, const Args& x) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (x.Hkv <= 0 || x.H % x.Hkv) return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// q, o, dout (B,H,S,D); k, v (B,Hkv,S,D); lse (B,H,S); glse (B,H,S) or
// NULL; dq (B,H,S,D): contiguous f32.
extern "C" int mxt_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    const void* glse, void* dq, int B, int H,
                                    int Hkv, int S, int D, float scale,
                                    int causal, int device, void* stream) {
  const Args x{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(glse), static_cast<float*>(dq),
               nullptr, B, H, Hkv, S, scale, causal,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e = prepare(device, x);
  if (e != cudaSuccess || S <= 0 || B * H <= 0) return e;
  return run(false, D, x);
}

// as above; dk, dv (B,H,S,D): one partial per q head (sum each GQA group).
extern "C" int mxt_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* lse,
                                     const void* glse, void* dk, void* dv,
                                     int B, int H, int Hkv, int S, int D,
                                     float scale, int causal, int device,
                                     void* stream) {
  const Args x{static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<const float*>(o),
               static_cast<const float*>(dout),
               static_cast<const float*>(lse),
               static_cast<const float*>(glse), static_cast<float*>(dk),
               static_cast<float*>(dv), B, H, Hkv, S, scale, causal,
               static_cast<cudaStream_t>(stream)};
  cudaError_t e = prepare(device, x);
  if (e != cudaSuccess || S <= 0 || B * H <= 0) return e;
  return run(true, D, x);
}
