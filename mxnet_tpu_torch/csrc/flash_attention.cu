// Flash attention forward, for Hopper (sm_90a): float32, bfloat16 and
// float16 q/k/v.
//
// Replaces: mxnet_tpu/ops/attention.py:_flash_kernel (launched by
// _flash_pallas). Same function: out = softmax(q k^T * scale [causal]) v
// with an online softmax in f32, plus the per-row logsumexp (f32), without
// the (S, S) score matrix ever reaching device memory. GQA reads kv head
// h / (H / H_kv) directly (no repeated copy). A row with no valid key gets
// out = 0 and lse = +inf, the TPU kernel's sentinel. out comes back in the
// inputs' type, rounded once from its f32 accumulator.
//
// What bounds it on the H100: operations. Causal prefill at S = 1024 does
// 4*S^2/2*D flops per head against 16*S*D bytes, far above the card's
// flops-per-byte line. So the products run on the tensor cores
// (flash_fwd_tc, head dims 16, 32, 64, 128, 256; mxt_tc.cuh): FA-2 on
// mma.sync.
//  * One block of 4 warps per (b*h, q tile); a warp owns MT m-tiles of 16
//    q rows (MT = 2 for f32 up to D = 64, so that each K/V fragment feeds
//    two mmas), their S slice (16 MT x BN) and their O accumulator
//    (16 MT x D) in mma C fragments. The block's Q rows sit in shared
//    memory.
//  * K/V tiles of BN keys stream through a cp.async double buffer: the
//    next tile's copy is in flight while this one is used; one barrier a
//    tile.
//  * Softmax in registers, in log2 units (scale * log2 e folded into one
//    FMA with each exponent; a negative scale negates the block's Q rows
//    once, so the row max is taken on raw scores): a row's 4 lanes (a
//    quad) take its max with two shuffles a tile, and its sum once at the
//    end; no shuffle runs per (row, key) pair. P is reused as the A operand of
//    P V from its C fragments, with no trip through shared memory.
//  * bfloat16 / float16: one m16n8k16 mma a product, f32 accumulators; P
//    is rounded to the input type before P V, as the TPU kernel does
//    (p.astype(v.dtype)), while the row sum takes the unrounded p.
//  * float32: 3xTF32 (mxt_tc.cuh), near-f32 products at 3 TF32 mmas a
//    product: 165 TFLOP/s of the tensor cores' 495, against the FP32
//    pipes' 67. P is split the same way. Fresh accumulators every kFresh
//    k-steps (32 terms) keep the tensor cores' truncating sums inside the
//    f32 budget (mxt_tc.cuh): chip_smoke.py's exact_flash_* cases hold
//    the kernel within 4x the plain f32 version's float64 error.
//  * causal: the block stops at its last row's tile, a warp skips tiles
//    wholly above its rows, and only tiles that cross a warp's diagonal (or
//    the ragged end of S) pay the mask; keys past S are zero-filled.
// BN (keys a tile) is 64 for half types; 32 for f32 (16 at D = 256, where
// 32 spilled): fwd_bn below has the measurements.
// The TPU kernel's 8-lane lse replication is TPU tiling and is dropped:
// lse is (B*H, S) f32. A wgmma/TMA pipeline is a later step.
//
// Head dims above 256 (D = 128 * NC: 384 and 512) take flash_fwd_wide,
// a design on the FP32 pipes, templated on the element type (widen at
// load, round once at store): its O rows (D floats) would not fit a
// warp's registers as C fragments beside S.
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

#include "mxt_tc.cuh"

namespace {

template <typename T>
struct Args {
  const T *q, *k, *v;
  T* o;
  float* lse;
  int B, H, Hkv, S;
  float scale;
  int causal;
  cudaStream_t stream;
};

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// m-tiles of 16 rows a warp, and keys a K/V tile (H100 measurements, B8
// H16 S1024 D64 and H8 S1000 D128/D256 causal, before the f32 path's
// fresh accumulators): f32 takes two m-tiles up to D = 64, so that each
// split K/V fragment feeds two mmas (0.506 ms against 0.538 with one), and
// 32 keys, which leaves registers for the fresh accumulators (0.522 ms
// against 0.506 with 64); 16 at D = 256, where 32 spilled; half types one
// m-tile (0.117 against 0.127 with two) of 64 keys (D = 256: one block an
// SM, 0.0495 against 0.0583; D <= 32: 16 keys, where 32 and 64 spilled)
template <typename T, int D>
constexpr int fwd_mt() {
  return !mxt_tc::Tile<T>::kHalf && D <= 64 ? 2 : 1;
}
template <typename T, int D>
constexpr int fwd_bn() {
  return mxt_tc::Tile<T>::kHalf ? (D <= 32 ? 16 : 64) : D == 256 ? 16 : 32;
}

template <typename T, int D, int BN, int MT>
struct FwdTc {
  static constexpr int kRows = 16 * MT * kTcWarps;      // q rows a block
  static constexpr int LD = D + mxt_tc::Tile<T>::kPad;   // padded row
  static constexpr int kSmem = (kRows + 4 * BN) * LD * (int)sizeof(T);
};

template <typename T, int D, int BN, int MT>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int H, int Hkv, int S,
             float scale_log2, int causal) {
  using C = FwdTc<T, D, BN, MT>;
  constexpr int kRows = C::kRows, LD = C::LD, NT = BN / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* Qs = reinterpret_cast<T*>(tc_smem);     // [kRows][LD]
  T* Ks = Qs + kRows * LD;                   // [2][BN][LD]
  T* Vs = Ks + 2 * BN * LD;                  // [2][BN][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;                 // b * H + h
  const int b = bh / H;
  const int hk = (bh % H) / (H / Hkv);
  // the last q tiles first: under a causal mask they are the longest, and
  // the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int w0 = q0 + warp * 16 * MT;        // the warp's first row
  const T* kb = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vb = v + (size_t)(b * Hkv + hk) * S * D;

  int n_tiles = (S + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + kRows, S) + BN - 1) / BN);
  mxt_tc::fetch_rows<T, D, kRows, kTcThreads>(Qs, q + (size_t)bh * S * D,
                                              q0, S, LD);
  mxt_tc::fetch_rows<T, D, BN, kTcThreads>(Ks, kb, 0, S, LD);
  mxt_tc::fetch_rows<T, D, BN, kTcThreads>(Vs, vb, 0, S, LD);
  cp_async_commit();
  if (scale_log2 < 0.f) {
    // softmax(q k^T scale) = softmax((-q) k^T |scale|): negate the block's
    // Q rows once (sign bits; exact in every type), so that the row max
    // below stays one compare an element on the raw scores (a multiply
    // there made the bf16/f16 forward 8-10% slower on the H100)
    cp_async_wait_all();
    __syncthreads();
    constexpr unsigned kSign = sizeof(T) == 4 ? 0x80000000u : 0x80008000u;
    unsigned* w = reinterpret_cast<unsigned*>(Qs);
    for (int i = threadIdx.x; i < kRows * LD * (int)sizeof(T) / 4;
         i += kTcThreads)
      w[i] ^= kSign;
    scale_log2 = -scale_log2;
  }

  // per m-tile i: acc[i] the O rows, m/l[i][r] the running max (log2
  // units) and sum of rows g + 8 r
  float acc[MT][DT][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int n = 0; n < DT; ++n)
      acc[i][n][0] = acc[i][n][1] = acc[i][n][2] = acc[i][n][3] = 0.f;
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.f;
  }

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
    float s[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[i][j][0] = s[i][j][1] = s[i][j][2] = s[i][j][3] = 0.f;
    mxt_tc::rows_by_rows<T, D, NT, MT>(Qs + warp * 16 * MT * LD,
                                       Ks + st * BN * LD, LD, s, lane);
    // online softmax of the tile; masked keys (the causal diagonal, the
    // ragged end) are tested only in tiles that have any
    auto softmax = [&](auto use_mask) {
      constexpr bool kMask = decltype(use_mask)::value;
      // row g + 8 r of m-tile i sees the keys before lim[i][r], counted
      // from this lane's first key of the tile
      int lim[MT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          lim[i][r] = kMask ? (causal ? min(S, w0 + 16 * i + g + 8 * r + 1)
                                      : S) - (k0 + 2 * t)
                            : BN;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        // the row max of the raw scores (scale_log2 >= 0, see above); the
        // scale enters with the exponent
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!kMask || j * 8 + (e & 1) < lim[i][e >> 1])
              mx[e >> 1] = fmaxf(mx[e >> 1], s[i][j][e]);
        float safe[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // -inf * 0 (scale 0, no key yet) is NaN, which fmaxf drops
          const float m_new = fmaxf(m[i][r], mx[r] * scale_log2);
          safe[r] = m_new == -INFINITY ? 0.f : m_new;
          // 0 while m is -inf
          const float corr = mxt_tc::exp2_<T>(m[i][r] - safe[r]);
          l[i][r] *= corr;
#pragma unroll
          for (int n = 0; n < DT; ++n) {
            acc[i][n][2 * r] *= corr;
            acc[i][n][2 * r + 1] *= corr;
          }
          m[i][r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p =
                !kMask || j * 8 + (e & 1) < lim[i][e >> 1]
                    ? mxt_tc::exp2_<T>(
                          fmaf(s[i][j][e], scale_log2, -safe[e >> 1]))
                    : 0.f;
            s[i][j][e] = p;
            l[i][e >> 1] += p;
          }
        }
      }
    };
    if (k0 + BN > S || (causal && k0 + BN - 1 > w0))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    mxt_tc::cols_by_rows<T, D, NT, MT>(s, Vs + st * BN * LD, LD, acc, lane);
  }

  T* ob = o + (size_t)bh * S * D;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float lr = l[i][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      const int row = w0 + 16 * i + g + 8 * r;
      if (row >= S) continue;
      const float l_safe = lr == 0.f ? 1.f : lr;
#pragma unroll
      for (int n = 0; n < DT; ++n)
        mxt_tc::store2(ob + (size_t)row * D + n * 8 + 2 * t,
                       acc[i][n][2 * r] / l_safe,
                       acc[i][n][2 * r + 1] / l_safe);
      if (t == 0)
        lse[(size_t)bh * S + row] =
            lr == 0.f ? INFINITY : m[i][r] * kLn2 + logf(l_safe);
    }
  }
}

template <typename T, int D, int BN = fwd_bn<T, D>(), int MT = fwd_mt<T, D>()>
cudaError_t launch_tc(const Args<T>& x) {
  using C = FwdTc<T, D, BN, MT>;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc<T, D, BN, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((x.S + C::kRows - 1) / C::kRows, x.B * x.H);
  flash_fwd_tc<T, D, BN, MT><<<grid, kTcThreads, C::kSmem, x.stream>>>(
      x.q, x.k, x.v, x.o, x.lse, x.H, x.Hkv, x.S, x.scale * kLog2e,
      x.causal);
  mxt_counted();
  return cudaGetLastError();
}

constexpr int kWideRows = 32;    // q rows per block
constexpr int kWideSplit = 8;    // threads per row
constexpr int kWideTile = 16;    // keys per K/V tile (one softmax chunk)
constexpr int kWideThreads = kWideRows * kWideSplit;

template <typename T, int NC>
__global__ void __launch_bounds__(kWideThreads)
flash_fwd_wide(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int H, int Hkv, int S, float scale,
               int causal) {
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
  const T* qp = q + ((size_t)bh * S + (live ? row : 0)) * D + part * 4;
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
        kv4 = mxt_ld4(k + off);
        vv4 = mxt_ld4(v + off);
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
        qv[j] = mxt_ld4(qp + c * 128 + j * 32);
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
  T* op = o + ((size_t)bh * S + row) * D + part * 4;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* a = &acc[16 * c + 4 * j];
      mxt_st4(op + c * 128 + j * 32,
              make_float4(a[0] / l_safe, a[1] / l_safe, a[2] / l_safe,
                          a[3] / l_safe));
    }
  }
  if (part == 0)
    lse[(size_t)bh * S + row] = (l == 0.f) ? INFINITY : m + logf(l_safe);
}

template <typename T, int NC>
cudaError_t launch_wide(const Args<T>& x) {
  const int smem = 2 * kWideTile * 128 * NC * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wide<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((x.S + kWideRows - 1) / kWideRows, x.B * x.H);
  flash_fwd_wide<T, NC><<<grid, kWideThreads, smem, x.stream>>>(
      x.q, x.k, x.v, x.o, x.lse, x.H, x.Hkv, x.S, x.scale, x.causal);
  mxt_counted();
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int D, const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Hkv, int S, float scale,
                int causal, cudaStream_t stream) {
  const Args<T> x{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<T*>(o),
                  static_cast<float*>(lse), B, H, Hkv, S, scale, causal,
                  stream};
  switch (D) {
    case 16: return launch_tc<T, 16>(x);
    case 32: return launch_tc<T, 32>(x);
    case 64: return launch_tc<T, 64>(x);
    case 128: return launch_tc<T, 128>(x);
    case 256: return launch_tc<T, 256>(x);
    case 384: return launch_wide<T, 3>(x);
    case 512: return launch_wide<T, 4>(x);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B,H,S,D), k/v (B,Hkv,S,D), o (B,H,S,D) of one element type (dtype:
// MXT_F32, MXT_BF16 or MXT_F16); lse (B,H,S) f32; all contiguous; any
// scale.
extern "C" int mxt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Hkv, int S,
                             int D, float scale, int causal, int dtype,
                             int device, void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (S <= 0 || B * H <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case MXT_F32: return run<float>(D, q, k, v, o, lse, B, H, Hkv, S, scale,
                                    causal, st);
    case MXT_BF16: return run<__nv_bfloat16>(D, q, k, v, o, lse, B, H, Hkv,
                                             S, scale, causal, st);
    case MXT_F16: return run<__half>(D, q, k, v, o, lse, B, H, Hkv, S, scale,
                                     causal, st);
    default: return cudaErrorInvalidValue;
  }
}
