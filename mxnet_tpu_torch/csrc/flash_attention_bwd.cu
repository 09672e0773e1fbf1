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
// out, so the ceiling is the 67 TFLOP/s of the FP32 pipes. Both kernels
// keep the TPU's two-kernel split: every output element is written by one
// thread, summed in a fixed order, without atomics, so a given input gives
// bit-identical gradients from run to run; a ragged S is masked (rows and
// keys past S never enter a sum).
//
// dQ: gridded over (q tile, b*h), each block streaming K/V tiles through
// shared memory:
//  * a row is split over D/16 threads of one warp (one below D = 16), each
//    owning 16 of its D columns (float4 columns dealt in turn, so the
//    partners of a row read different banks): q, dO and the dQ accumulator
//    in registers (3 x 16 floats; 32 columns a thread spilled at 255
//    registers); partners sum their partial dot products with a butterfly
//    of shuffles, which leaves the same sum in every partner;
//  * dot products for kChunk keys are formed before their shuffles, and
//    the rank-1 updates after, so the shuffles overlap;
//  * delta is recomputed from the block's own q and O rows, as on the
//    TPU; causal: it stops at the diagonal tile and each row at its key.
//
// dK/dV (D <= 256): FA-2's outer loop, f32 FMA, gridded over (BK keys,
// b*h). 128 threads; BK = 64 at D <= 64, 32 at D = 128, 16 at D = 256, so
// that the dK and dV accumulators (2 * BK * D / 128 floats a thread, at
// most 64) stay in registers:
//  * the block's K and V rows are staged once in shared memory; Q and dO
//    tiles of BQ rows stream through cp.async, double-buffered (the next
//    tile's copy in flight while this one is used) except at D = 64, where
//    a single buffer lets three blocks share an SM and hide each other's
//    copies;
//  * key blocks run on grid y, heads on x, so every head's longest (first)
//    causal key block is scheduled first and the short ones fill the tail;
//  * per tile four register-blocked products, each a micro-tile of outer
//    products per thread with no shuffle: S^T = K Q^T and dP^T = V dO^T
//    (a thread's JA keys x IB rows, float4 steps along D), then
//    dV += P^T dO and dK += dS^T Q (a thread's JA2 keys x 4*DC columns,
//    4 rows a step). At D = 64 each float4 read from shared memory feeds
//    16 (S, dP) or ~10 (dV, dK) FMAs a float4 (the old one-key-per-thread
//    kernel fed 4 and paid two butterflies per (key, row) pair);
//  * P and dS pass between the products through shared memory; rows of
//    every tile are padded by 4 floats, so the 8 rows (or 4 keys) a warp
//    reads at once fall in different banks;
//  * lse and delta come per tile row (delta = dO . O - glse, O read from
//    device memory, as the TPU kernel recomputes it); the +inf empty-row
//    lse gives p = 0; causal: the block starts at the first q tile that
//    sees its first key (the skip from the k side), and masks j > i;
//  * GQA by index: kv head h / (H / H_kv), one partial per q head.
// Tensor cores (bf16 pieces as in quantized_matmul.cu, or wgmma) and dQ in
// the same style are a later step.
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
// dK/dV, FA-2 style: one block per (BK keys, b*h over q heads)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float lane4(float4 v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

constexpr int kDkvThreads = 128;

// BK keys a block, Q/dO tiles of BQ rows. Products S^T = K Q^T and
// dP^T = V dO^T: a thread owns keys sj + 16 a (a < JA) x rows si + 8 b
// (b < IB). Products dV += P^T dO and dK += dS^T Q: a thread owns keys
// aj + JG2 a (a < JA2) x columns ad * 4 + 4 DG c .. + 3 (c < DC).
template <int D, int BK, int BQ, int STAGES>
struct DkvCfg {
  static constexpr int JA = BK / 16, IB = BQ / 8;
  static constexpr int DG = D / 8;           // 2 float4 columns a thread
  static constexpr int JG2 = kDkvThreads / DG;
  static constexpr int JA2 = BK / JG2, DC = D / (4 * DG);
  static constexpr int KS = D + 4;           // padded row of K, V, Q, dO
  static constexpr int PS = BQ + 4;          // padded row of P, dS
  static constexpr int RT = kDkvThreads / BQ;   // threads a row for delta
  static constexpr int kFloats =
      2 * BK * KS + 2 * STAGES * BQ * KS + 2 * BK * PS + 2 * BQ;
  static_assert(JA >= 1 && IB >= 1 && JA2 >= 1 && DC >= 1, "tiling");
  static_assert(RT >= 1 && RT <= 16 && (RT & (RT - 1)) == 0, "delta");
};

template <int D, int BK, int BQ, int STAGES>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ o,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ glse, float* __restrict__ dk,
                  float* __restrict__ dv, int H, int Hkv, int S, float scale,
                  int causal) {
  using C = DkvCfg<D, BK, BQ, STAGES>;
  constexpr int JA = C::JA, IB = C::IB, DG = C::DG, JG2 = C::JG2;
  constexpr int JA2 = C::JA2, DC = C::DC, KS = C::KS, PS = C::PS;
  constexpr int RT = C::RT;
  extern __shared__ __align__(16) float dkv_smem[];
  float* Ks = dkv_smem;                      // [BK][KS]
  float* Vs = Ks + BK * KS;                  // [BK][KS]
  float* Qs = Vs + BK * KS;                  // [STAGES][BQ][KS]
  float* Gs = Qs + STAGES * BQ * KS;         // [STAGES][BQ][KS]: dO
  float* Ps = Gs + STAGES * BQ * KS;         // [BK][PS]
  float* dSs = Ps + BK * PS;                 // [BK][PS]
  float* lse_s = dSs + BK * PS;              // [BQ]
  float* delta_s = lse_s + BQ;               // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // key blocks on y: the grid runs every head's first key block (the
  // longest under a causal mask) first, so short blocks fill the tail
  const int bh = blockIdx.x;                 // b * H + h (q head)
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  const int k0 = blockIdx.y * BK;
  const size_t q_base = (size_t)bh * S * D;
  const size_t kv_base = (size_t)(b * Hkv + hk) * S * D;

  // Q and dO rows of tile t into stage st; rows past S are zero-filled
  auto fetch = [&](int t, int st) {
    const int r0 = t * BQ;
    for (int i = tid; i < BQ * D / 4; i += kDkvThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const bool ok = r0 + r < S;
      const size_t off = q_base + (size_t)(ok ? r0 + r : 0) * D + c;
      cp_async16(Qs + (st * BQ + r) * KS + c, q + off, ok);
      cp_async16(Gs + (st * BQ + r) * KS + c, dout + off, ok);
    }
    cp_async_commit();
  };

  const int n_tiles = (S + BQ - 1) / BQ;
  const int t_first = causal ? k0 / BQ : 0;  // rows below k0 see no key
  if (STAGES == 2) fetch(t_first, 0);
  for (int i = tid; i < BK * D / 4; i += kDkvThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
    if (k0 + r < S) {
      kk = *reinterpret_cast<const float4*>(k + kv_base + (size_t)(k0 + r) * D + c);
      vv = *reinterpret_cast<const float4*>(v + kv_base + (size_t)(k0 + r) * D + c);
    }
    *reinterpret_cast<float4*>(Ks + r * KS + c) = kk;
    *reinterpret_cast<float4*>(Vs + r * KS + c) = vv;
  }

  const int sj = warp * 4 + (lane >> 3);     // S phase: key group 0..15
  const int si = lane & 7;                   // S phase: row group 0..7
  const int ad = tid % DG, aj = tid / DG;    // accumulation phase
  float dka[JA2][DC][4], dva[JA2][DC][4];
#pragma unroll
  for (int a = 0; a < JA2; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) dka[a][c][e] = dva[a][c][e] = 0.f;

  for (int t = t_first; t < n_tiles; ++t) {
    const int st = STAGES == 2 ? (t - t_first) & 1 : 0;
    const int r0 = t * BQ;
    if (STAGES == 1) {
      __syncthreads();        // tile t - 1 fully consumed
      fetch(t, 0);
    }
    cp_async_wait_all();
    __syncthreads();          // tile t landed; tile t - 1 fully consumed
    if (STAGES == 2 && t + 1 < n_tiles) fetch(t + 1, st ^ 1);
    const float* Qt = Qs + st * BQ * KS;
    const float* Gt = Gs + st * BQ * KS;
    {
      // delta = dO . O - glse and lse of the tile's rows, RT threads a
      // row (O read from device memory, as the TPU kernel recomputes it)
      const int r = tid / RT, p = tid % RT;
      const bool in = r0 + r < S;
      float acc = 0.f;
      if (in) {
        const float* orow = o + q_base + (size_t)(r0 + r) * D;
        for (int c = p * 4; c < D; c += RT * 4)
          acc = dot4(*reinterpret_cast<const float4*>(Gt + r * KS + c),
                     __ldg(reinterpret_cast<const float4*>(orow + c)), acc);
      }
      acc = row_sum<RT>(acc, partner_mask<RT>());
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
    // S^T -> P, then dP^T -> dS, each into shared memory
    float pr[JA][IB];
    {
      float sacc[JA][IB];
#pragma unroll
      for (int a = 0; a < JA; ++a)
#pragma unroll
        for (int bb = 0; bb < IB; ++bb) sacc[a][bb] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 kv[JA], qv[IB];
#pragma unroll
        for (int a = 0; a < JA; ++a)
          kv[a] = *reinterpret_cast<const float4*>(Ks + (sj + 16 * a) * KS + d);
#pragma unroll
        for (int bb = 0; bb < IB; ++bb)
          qv[bb] = *reinterpret_cast<const float4*>(Qt + (si + 8 * bb) * KS + d);
#pragma unroll
        for (int a = 0; a < JA; ++a)
#pragma unroll
          for (int bb = 0; bb < IB; ++bb)
            sacc[a][bb] = dot4(kv[a], qv[bb], sacc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < JA; ++a) {
        const int j = k0 + sj + 16 * a;
#pragma unroll
        for (int bb = 0; bb < IB; ++bb) {
          const int i = si + 8 * bb;
          // rows past S have lse = +inf, so p = 0 there
          const bool ok = j < S && (!causal || j <= r0 + i);
          pr[a][bb] = ok ? expf(sacc[a][bb] * scale - lse_s[i]) : 0.f;
          Ps[(sj + 16 * a) * PS + i] = pr[a][bb];
        }
      }
    }
    {
      float dacc[JA][IB];
#pragma unroll
      for (int a = 0; a < JA; ++a)
#pragma unroll
        for (int bb = 0; bb < IB; ++bb) dacc[a][bb] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 vv[JA], gv[IB];
#pragma unroll
        for (int a = 0; a < JA; ++a)
          vv[a] = *reinterpret_cast<const float4*>(Vs + (sj + 16 * a) * KS + d);
#pragma unroll
        for (int bb = 0; bb < IB; ++bb)
          gv[bb] = *reinterpret_cast<const float4*>(Gt + (si + 8 * bb) * KS + d);
#pragma unroll
        for (int a = 0; a < JA; ++a)
#pragma unroll
          for (int bb = 0; bb < IB; ++bb)
            dacc[a][bb] = dot4(vv[a], gv[bb], dacc[a][bb]);
      }
#pragma unroll
      for (int a = 0; a < JA; ++a)
#pragma unroll
        for (int bb = 0; bb < IB; ++bb) {
          const int i = si + 8 * bb;
          dSs[(sj + 16 * a) * PS + i] =
              pr[a][bb] * (dacc[a][bb] - delta_s[i]) * scale;
        }
    }
    __syncthreads();
    // dV += P^T dO and dK += dS^T Q over the tile's rows, 4 at a time
#pragma unroll 2
    for (int i = 0; i < BQ; i += 4) {
      float4 pv[JA2], sv[JA2];
#pragma unroll
      for (int a = 0; a < JA2; ++a) {
        pv[a] = *reinterpret_cast<const float4*>(Ps + (aj + JG2 * a) * PS + i);
        sv[a] = *reinterpret_cast<const float4*>(dSs + (aj + JG2 * a) * PS + i);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int col = ad * 4 + 4 * DG * c;
          const float4 g = *reinterpret_cast<const float4*>(Gt + (i + u) * KS + col);
          const float4 qq = *reinterpret_cast<const float4*>(Qt + (i + u) * KS + col);
#pragma unroll
          for (int a = 0; a < JA2; ++a) {
            axpy4(lane4(pv[a], u), g, dva[a][c]);
            axpy4(lane4(sv[a], u), qq, dka[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < JA2; ++a) {
    const int j = k0 + aj + JG2 * a;
    if (j >= S) continue;
    const size_t out = ((size_t)bh * S + j) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = ad * 4 + 4 * DG * c;
      *reinterpret_cast<float4*>(dk + out + col) = make_float4(
          dka[a][c][0], dka[a][c][1], dka[a][c][2], dka[a][c][3]);
      *reinterpret_cast<float4*>(dv + out + col) = make_float4(
          dva[a][c][0], dva[a][c][1], dva[a][c][2], dva[a][c][3]);
    }
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

template <int D, int BK, int BQ, int STAGES>
cudaError_t launch_dkv(const Args& x) {
  constexpr int smem =
      DkvCfg<D, BK, BQ, STAGES>::kFloats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_f32<D, BK, BQ, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if ((x.S + BK - 1) / BK > 65535) return cudaErrorInvalidValue;
  dim3 grid(x.B * x.H, (x.S + BK - 1) / BK);
  flash_bwd_dkv_f32<D, BK, BQ, STAGES><<<grid, kDkvThreads, smem, x.stream>>>(
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

// dK/dV tiles per head dim (keys a block, q rows a tile, Q/dO stages):
// the dK and dV accumulators (2 * BK * D / 128 floats a thread, 64 from
// D = 64 up) stay in registers; two stages where two blocks share an SM
// (66-111 KB), one at D = 64 (71 KB), where three blocks an SM measured
// faster on the H100 than two with the copy overlapped (1.13 vs 1.23 ms at
// B8 H16 S1024)
cudaError_t run(bool dkv, int D, const Args& x) {
  switch (D) {
    case 16: return dkv ? launch_dkv<16, 64, 64, 2>(x) : launch_dq<16>(x);
    case 32: return dkv ? launch_dkv<32, 64, 64, 2>(x) : launch_dq<32>(x);
    case 64: return dkv ? launch_dkv<64, 64, 32, 1>(x) : launch_dq<64>(x);
    case 128: return dkv ? launch_dkv<128, 32, 32, 2>(x) : launch_dq<128>(x);
    case 256: return dkv ? launch_dkv<256, 16, 16, 2>(x) : launch_dq<256>(x);
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
