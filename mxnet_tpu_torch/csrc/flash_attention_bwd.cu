// Flash attention backward, for Hopper (sm_90a): dQ and dK/dV, over
// float32, bfloat16 or float16 q/k/v/o/dO.
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
// dK/dV kernel writes one f32 partial per q head, (B, H, S, D); the caller
// sums each GQA group in f32 and rounds once to k's type, as the TPU path
// sums outside its kernel. dQ comes back in q's type.
//
// What bounds it on the H100: operations. dQ does 3 products of length D
// per (q row, key) pair (6*D flops), dK/dV 4 (8*D flops); causal S = 1024
// gives ~400 flops per byte moved. Both kernels keep the TPU's two-kernel
// split: every output element is written by one thread, summed in a fixed
// order, without atomics, so a given input gives bit-identical gradients
// from run to run; a ragged S is masked (rows and keys past S never enter
// a sum).
//
// dQ (flash_bwd_dq_tc, head dims 16-256): the flash forward's design on
// the tensor cores (mxt_tc.cuh):
//  * one block of 4 warps per (q tile, b*h); a warp owns MT m-tiles of 16
//    q rows (MT = 2 for f32 up to D = 64) and their dQ accumulator in mma
//    C fragments; the block's Q
//    and dO rows sit in shared memory, and K/V tiles of BN keys stream
//    through a cp.async double buffer, one barrier a tile;
//  * per tile three products on the same mma types as the forward:
//    S = Q K^T and dP = dO V^T (rows by rows), then dQ += dS K with dS
//    taken from its C fragments as the A operand (no shared-memory trip);
//    bfloat16 / float16 round dS to the input type first, as the TPU
//    kernel does (ds.astype(k.dtype)); float32 runs 3xTF32;
//  * delta is computed once per row at block start from the block's own
//    dO rows (shared memory) and O (device memory), two lanes a row; lse
//    and delta sit in shared memory in the C fragments' row order;
//  * causal: the block stops at its last row's tile, a warp skips tiles
//    wholly above its rows, and only tiles crossing a warp's diagonal (or
//    the ragged end) pay the mask.
// BN is 32 keys (64 for half types at D = 64, 16 at D = 256): dq_bn below
// has the measurements.
//
// dK/dV (D <= 256): FA-2's outer loop, f32 FMA, gridded over (BK keys,
// b*h). 128 threads; BK = 64 at D <= 64, 32 at D = 128, 16 at D = 256, so
// that the dK and dV accumulators (2 * BK * D / 128 floats a thread, at
// most 64) stay in registers:
//  * the block's K and V rows are staged once in shared memory (widened to
//    f32); Q and dO tiles of BQ rows stream through cp.async (f32 inputs),
//    double-buffered (the next tile's copy in flight while this one is
//    used) except at D = 64, where a single buffer lets three blocks share
//    an SM and hide each other's copies; half types are widened by the
//    loading threads into the same f32 tiles;
//  * key blocks run on grid y, heads on x, so every head's longest (first)
//    causal key block is scheduled first and the short ones fill the tail;
//  * per tile four register-blocked products, each a micro-tile of outer
//    products per thread with no shuffle: S^T = K Q^T and dP^T = V dO^T
//    (a thread's JA keys x IB rows, float4 steps along D), then
//    dV += P^T dO and dK += dS^T Q (a thread's JA2 keys x 4*DC columns,
//    4 rows a step);
//  * P and dS pass between the products through shared memory; rows of
//    every tile are padded by 4 floats, so the 8 rows (or 4 keys) a warp
//    reads at once fall in different banks;
//  * lse and delta come per tile row (delta = dO . O - glse, O read from
//    device memory, as the TPU kernel recomputes it); the +inf empty-row
//    lse gives p = 0; causal: the block starts at the first q tile that
//    sees its first key (the skip from the k side), and masks j > i;
//  * GQA by index: kv head h / (H / H_kv), one partial per q head.
// Tensor cores for dK/dV are a later step.
//
// Head dims above 256 (D = 128 * NC: 384 and 512) take the "wide" kernels
// below (FP32 pipes, templated on the element type: widen at load, round
// once at store). D/16 partners per row would fill a warp at 512 (and be no
// power of two at 384), so the split is fixed and the loop runs over D in
// 128-column chunks instead:
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

#include "mxt_tc.cuh"

namespace {

constexpr int kChunk = 8;

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

// ---------------------------------------------------------------------------
// dQ on the tensor cores: one block per (64-row q tile, b*h)
// ---------------------------------------------------------------------------
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;

// m-tiles of 16 rows a warp, and keys a K/V tile (H100 measurements, B8
// H16 S1024 D64 and H8 S1000 D128 causal): f32 takes two m-tiles of 32
// keys up to D = 64 (0.720 ms; one m-tile of 64 keys: 0.744), half types
// one of 64 at D = 64 (0.1415; two of 32: 0.151; at D = 32, 64 keys
// spilled); D = 128 tiles of 32 keys (f32 0.204 against 0.256 with 16;
// f32 grids of more than two waves take 16: run()); D = 256 of 16
template <typename T, int D>
constexpr int dq_mt() {
  return !mxt_tc::Tile<T>::kHalf && D <= 64 ? 2 : 1;
}
template <typename T, int D>
constexpr int dq_bn() {
  return D == 256 ? 16 : D == 64 && mxt_tc::Tile<T>::kHalf ? 64 : 32;
}

template <typename T, int D, int BN, int MT>
struct DqTc {
  static constexpr int kRows = 16 * MT * kTcWarps;      // q rows a block
  static constexpr int LD = D + mxt_tc::Tile<T>::kPad;   // padded row
  static constexpr int kSmem =
      (2 * kRows + 4 * BN) * LD * (int)sizeof(T) + 2 * kRows * 4;
};

template <typename T, int D, int BN, int MT>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ o,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ glse, T* __restrict__ dq, int H,
                int Hkv, int S, float scale, int causal) {
  using C = DqTc<T, D, BN, MT>;
  constexpr int kRows = C::kRows, LD = C::LD, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* Qs = reinterpret_cast<T*>(tc_smem);     // [kRows][LD]
  T* Gs = Qs + kRows * LD;                   // [kRows][LD]: dO
  T* Ks = Gs + kRows * LD;                   // [2][BN][LD]
  T* Vs = Ks + 2 * BN * LD;                  // [2][BN][LD]
  float* lse_s = reinterpret_cast<float*>(Vs + 2 * BN * LD);  // log2 units
  float* delta_s = lse_s + kRows;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;                 // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  // the last q tiles first: under a causal mask they are the longest, and
  // the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int w0 = q0 + warp * 16 * MT;        // the warp's first row
  const size_t q_base = (size_t)bh * S * D;
  const T* kb = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * S * D;
  const float scale_log2 = scale * kLog2e;

  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRows, S) + BN - 1) / BN);
  mxt_tc::fetch_rows<T, D, kRows, kTcThreads>(Qs, q + q_base, q0, S, LD);
  mxt_tc::fetch_rows<T, D, kRows, kTcThreads>(Gs, dout + q_base, q0, S, LD);
  mxt_tc::fetch_rows<T, D, BN, kTcThreads>(Ks, kb, 0, S, LD);
  mxt_tc::fetch_rows<T, D, BN, kTcThreads>(Vs, vb, 0, S, LD);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  // delta = dO . O - glse and lse of the warp's rows, two lanes a row
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = (warp * MT + i) * 16 + (lane >> 1), row = q0 + r;
    float dd = 0.f;
    if (row < S) {
      const T* orow = o + q_base + (size_t)row * D;
      const T* grow = Gs + r * LD;
#pragma unroll 4
      for (int c = (lane & 1) * 4; c < D; c += 8) {
        const float4 x = mxt_ld4(orow + c), y = mxt_ld4(grow + c);
        dd = fmaf(x.x, y.x, fmaf(x.y, y.y, fmaf(x.z, y.z, fmaf(x.w, y.w,
                                                               dd))));
      }
    }
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    if ((lane & 1) == 0) {
      float ls = INFINITY, gl = 0.f;
      if (row < S) {
        ls = lse[(size_t)bh * S + row];
        if (glse != nullptr) gl = glse[(size_t)bh * S + row];
      }
      lse_s[r] = isfinite(ls) ? ls * kLog2e : INFINITY;   // empty row: p = 0
      delta_s[r] = dd - gl;
    }
  }
  __syncwarp();
  // rows g + 8 r of m-tile i
  float lse_r[MT][2], delta_r[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse_r[i][r] = lse_s[(warp * MT + i) * 16 + g + 8 * r];
      delta_r[i][r] = delta_s[(warp * MT + i) * 16 + g + 8 * r];
    }

  float acc[MT][DT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < DT; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * BN;
    cp_async_wait_all();
    __syncthreads();          // tile it landed; tile it - 1 fully consumed
    if (it + 1 < n_tiles) {
      mxt_tc::fetch_rows<T, D, BN, kTcThreads>(Ks + (st ^ 1) * BN * LD, kb,
                                               k0 + BN, S, LD);
      mxt_tc::fetch_rows<T, D, BN, kTcThreads>(Vs + (st ^ 1) * BN * LD, vb,
                                               k0 + BN, S, LD);
      cp_async_commit();
    }
    if (causal && k0 > w0 + 16 * MT - 1) continue;   // no key for its rows
    const T* Kt = Ks + st * BN * LD;
    float s[MT][NT][4], dp[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = dp[i][j][e] = 0.f;
    mxt_tc::rows_by_rows<T, D, NT, MT>(Qs + warp * 16 * MT * LD, Kt, LD, s,
                                       lane);
    mxt_tc::rows_by_rows<T, D, NT, MT>(Gs + warp * 16 * MT * LD,
                                       Vs + st * BN * LD, LD, dp, lane);
    const bool mask = k0 + BN > S || (causal && k0 + BN - 1 > w0);
#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = mxt_tc::exp2_<T>(
              fmaf(s[i][j][e], scale_log2, -lse_r[i][r]));
          if (mask) {
            const int kj = k0 + j * 8 + 2 * t + (e & 1);
            const int qi = w0 + 16 * i + g + 8 * r;
            if (kj >= S || (causal && kj > qi)) p = 0.f;
          }
          s[i][j][e] = p * (dp[i][j][e] - delta_r[i][r]) * scale;   // dS
        }
      }
    }
    mxt_tc::cols_by_rows<T, D, NT, MT>(s, Kt, LD, acc, lane);
  }

  T* out = dq + q_base;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = w0 + 16 * i + g + 8 * r;
      if (row >= S) continue;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        mxt_tc::store2(out + (size_t)row * D + n * 8 + 2 * t,
                       acc[i][n][2 * r], acc[i][n][2 * r + 1]);
    }
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

template <typename T, int D, int BK, int BQ, int STAGES>
__global__ void __launch_bounds__(kDkvThreads)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ o,
              const T* __restrict__ dout, const float* __restrict__ lse,
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

  // Q and dO rows of tile t into stage st; rows past S are zero-filled.
  // f32 by cp.async; half types widened to f32 by the loading threads
  auto fetch = [&](int t, int st) {
    const int r0 = t * BQ;
    if constexpr (std::is_same<T, float>::value) {
      for (int i = tid; i < BQ * D / 4; i += kDkvThreads) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        const bool ok = r0 + r < S;
        const size_t off = q_base + (size_t)(ok ? r0 + r : 0) * D + c;
        cp_async16(Qs + (st * BQ + r) * KS + c, q + off, ok);
        cp_async16(Gs + (st * BQ + r) * KS + c, dout + off, ok);
      }
    } else {
      // rolled: unrolled, the widening held ptxas's register budget over
      // and spilled loop invariants (H100 build)
#pragma unroll 1
      for (int i = tid; i < BQ * D / 4; i += kDkvThreads) {
        const int r = i / (D / 4), c = (i % (D / 4)) * 4;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
        if (r0 + r < S) {
          const size_t off = q_base + (size_t)(r0 + r) * D + c;
          x = mxt_ld4(q + off);
          y = mxt_ld4(dout + off);
        }
        *reinterpret_cast<float4*>(Qs + (st * BQ + r) * KS + c) = x;
        *reinterpret_cast<float4*>(Gs + (st * BQ + r) * KS + c) = y;
      }
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
      kk = mxt_ld4(k + kv_base + (size_t)(k0 + r) * D + c);
      vv = mxt_ld4(v + kv_base + (size_t)(k0 + r) * D + c);
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
        const T* orow = o + q_base + (size_t)(r0 + r) * D;
        for (int c = p * 4; c < D; c += RT * 4)
          acc = dot4(*reinterpret_cast<const float4*>(Gt + r * KS + c),
                     mxt_ld4(orow + c), acc);
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

template <typename T, int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dq_wide(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ o,
                  const T* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ glse, T* __restrict__ dq, int H,
                  int Hkv, int S, float scale, int causal) {
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

  // the block's q and dO rows; half types in a rolled loop (unrolled, the
  // widening spilled loop invariants: H100 build)
  auto stage = [&](int i) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), g = x;
    if (q0 + r < S) {
      const size_t off = q_base + (size_t)(q0 + r) * D + c;
      x = mxt_ld4(q + off);
      g = mxt_ld4(dout + off);
    }
    *reinterpret_cast<float4*>(qs + r * D + c) = x;
    *reinterpret_cast<float4*>(gs + r * D + c) = g;
  };
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < kDqRows * D / 4; i += kWideThreads)
      stage(i);
  } else {
#pragma unroll 1
    for (int i = threadIdx.x; i < kDqRows * D / 4; i += kWideThreads)
      stage(i);
  }
  __syncthreads();
  // this thread's column j of chunk c: c * 128 + j * 64 + part * 4 (+0..3)
  const float* qr = qs + r_loc * D + part * 4;
  const float* gr = gs + r_loc * D + part * 4;

  float acc[8 * NC];
  float dd = 0.f;
  const T* orow = o + q_base + (size_t)(live ? row : 0) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = c * 128 + j * 64;
      if (live)
        dd = dot4(*reinterpret_cast<const float4*>(gr + d),
                  mxt_ld4(orow + d), dd);
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
        kv4 = mxt_ld4(k + off);
        vv4 = mxt_ld4(v + off);
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
  T* out = dq + ((size_t)bh * S + row) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float* a = &acc[8 * c + 4 * j];
      mxt_st4(out + c * 128 + j * 64, make_float4(a[0], a[1], a[2], a[3]));
    }
  }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_bwd_dkv_wide(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ o,
                   const T* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ glse, float* __restrict__ dk,
                   float* __restrict__ dv, int H, int Hkv, int S, float scale,
                   int causal) {
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
  const T* kp = k + koff;
  const T* vp = v + koff;

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
        x = mxt_ld4(q + off);
        g = mxt_ld4(dout + off);
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
        const T* orow = o + q_base + (size_t)(r0 + r) * D;
        for (int c = p * 4; c < D; c += kDT * 4)
          acc = dot4(*reinterpret_cast<const float4*>(dos + r * D + c),
                     mxt_ld4(orow + c), acc);
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
          kv[j] = mxt_ld4(kp + c * 128 + j * 64);
          vv[j] = mxt_ld4(vp + c * 128 + j * 64);
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

template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float *lse, *glse;
  void *a, *b;                               // dq (T) | dk, dv (f32)
  int B, H, Hkv, S;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int D, int BN = dq_bn<T, D>(), int MT = dq_mt<T, D>()>
cudaError_t launch_dq(const Args<T>& x) {
  using C = DqTc<T, D, BN, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc<T, D, BN, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((x.S + C::kRows - 1) / C::kRows, x.B * x.H);
  flash_bwd_dq_tc<T, D, BN, MT><<<grid, kTcThreads, C::kSmem, x.stream>>>(
      x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, static_cast<T*>(x.a), x.H,
      x.Hkv, x.S, x.scale, x.causal);
  return cudaGetLastError();
}

template <typename T, int D, int BK, int BQ, int STAGES>
cudaError_t launch_dkv(const Args<T>& x) {
  constexpr int smem =
      DkvCfg<D, BK, BQ, STAGES>::kFloats * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv<T, D, BK, BQ, STAGES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if ((x.S + BK - 1) / BK > 65535) return cudaErrorInvalidValue;
  dim3 grid(x.B * x.H, (x.S + BK - 1) / BK);
  flash_bwd_dkv<T, D, BK, BQ, STAGES><<<grid, kDkvThreads, smem, x.stream>>>(
      x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, static_cast<float*>(x.a),
      static_cast<float*>(x.b), x.H, x.Hkv, x.S, x.scale, x.causal);
  return cudaGetLastError();
}

template <typename T, int NC>
cudaError_t launch_wide(bool dkv, const Args<T>& x) {
  // dK/dV: Q/dO tiles of 16 rows; dQ: K/V tiles of 8 keys and its 16
  // rows' q and dO
  const int smem = (dkv ? 2 * kWideTile : 2 * kDqTile + 2 * kDqRows) * 128
                   * NC * (int)sizeof(float);
  if (dkv) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_wide<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((x.S + 15) / 16, x.B * x.H);
    flash_bwd_dkv_wide<T, NC><<<grid, kWideThreads, smem, x.stream>>>(
        x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, static_cast<float*>(x.a),
        static_cast<float*>(x.b), x.H, x.Hkv, x.S, x.scale, x.causal);
  } else {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_wide<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid((x.S + kDqRows - 1) / kDqRows, x.B * x.H);
    flash_bwd_dq_wide<T, NC><<<grid, kWideThreads, smem, x.stream>>>(
        x.q, x.k, x.v, x.o, x.dout, x.lse, x.glse, static_cast<T*>(x.a),
        x.H, x.Hkv, x.S, x.scale, x.causal);
  }
  return cudaGetLastError();
}

// dK/dV tiles per head dim (keys a block, q rows a tile, Q/dO stages):
// the dK and dV accumulators (2 * BK * D / 128 floats a thread, 64 from
// D = 64 up) stay in registers; two stages where two blocks share an SM
// (66-111 KB), one at D = 64 (71 KB), where three blocks an SM measured
// faster on the H100 than two with the copy overlapped (1.13 vs 1.23 ms at
// B8 H16 S1024)
template <typename T>
cudaError_t run(bool dkv, int D, const Args<T>& x) {
  // f32 D = 128 with more blocks than two waves: tiles of 16 keys (two
  // blocks an SM) keep the SMs busier than 32 (one): 12.2 against 13.5 ms
  // at B8 H8 S4096; one wave (H8 S1000) runs faster with 32: 0.227
  // against 0.268 (H100)
  if (!dkv && D == 128 && std::is_same<T, float>::value) {
    int sms = 0, dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    const long blocks = (long)(x.S + 63) / 64 * x.B * x.H;
    if (blocks > 2L * sms) return launch_dq<T, 128, 16>(x);
  }
  switch (D) {
    case 16: return dkv ? launch_dkv<T, 16, 64, 64, 2>(x)
                        : launch_dq<T, 16>(x);
    case 32: return dkv ? launch_dkv<T, 32, 64, 64, 2>(x)
                        : launch_dq<T, 32>(x);
    case 64: return dkv ? launch_dkv<T, 64, 64, 32, 1>(x)
                        : launch_dq<T, 64>(x);
    case 128: return dkv ? launch_dkv<T, 128, 32, 32, 2>(x)
                         : launch_dq<T, 128>(x);
    case 256: return dkv ? launch_dkv<T, 256, 16, 16, 2>(x)
                         : launch_dq<T, 256>(x);
    case 384: return launch_wide<T, 3>(dkv, x);
    case 512: return launch_wide<T, 4>(dkv, x);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_typed(bool dkv, int D, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const void* lse, const void* glse, void* a, void* b,
                      int B, int H, int Hkv, int S, float scale, int causal,
                      cudaStream_t stream) {
  const Args<T> x{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const T*>(o),
                  static_cast<const T*>(dout),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(glse), a, b, B, H, Hkv, S,
                  scale, causal, stream};
  return run<T>(dkv, D, x);
}

cudaError_t dispatch(bool dkv, int dtype, int D, const void* q,
                     const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, const void* glse,
                     void* a, void* b, int B, int H, int Hkv, int S,
                     float scale, int causal, int device, void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (S <= 0 || B * H <= 0) return cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case MXT_F32:
      return run_typed<float>(dkv, D, q, k, v, o, dout, lse, glse, a, b, B,
                              H, Hkv, S, scale, causal, st);
    case MXT_BF16:
      return run_typed<__nv_bfloat16>(dkv, D, q, k, v, o, dout, lse, glse,
                                      a, b, B, H, Hkv, S, scale, causal, st);
    case MXT_F16:
      return run_typed<__half>(dkv, D, q, k, v, o, dout, lse, glse, a, b, B,
                               H, Hkv, S, scale, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout (B,H,S,D) and k, v (B,Hkv,S,D) of one element type (dtype:
// MXT_F32, MXT_BF16 or MXT_F16); lse (B,H,S) f32; glse (B,H,S) f32 or
// NULL; dq (B,H,S,D) of the same type: all contiguous.
extern "C" int mxt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* lse, const void* glse, void* dq,
                                int B, int H, int Hkv, int S, int D,
                                float scale, int causal, int dtype,
                                int device, void* stream) {
  return dispatch(false, dtype, D, q, k, v, o, dout, lse, glse, dq, nullptr,
                  B, H, Hkv, S, scale, causal, device, stream);
}

// as above; dk, dv (B,H,S,D) f32: one partial per q head (sum each GQA
// group, then round to k's type).
extern "C" int mxt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* lse, const void* glse, void* dk,
                                 void* dv, int B, int H, int Hkv, int S,
                                 int D, float scale, int causal, int dtype,
                                 int device, void* stream) {
  return dispatch(true, dtype, D, q, k, v, o, dout, lse, glse, dk, dv, B, H,
                  Hkv, S, scale, causal, device, stream);
}
