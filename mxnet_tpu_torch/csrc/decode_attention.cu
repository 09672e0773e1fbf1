// Single-token decode attention over a length-masked KV pool, for Hopper
// (sm_90a): float32, bfloat16 or float16 q and caches (one type), f32
// accumulation, softmax in f32, the output rounded once to the input type.
//
// Replaces: mxnet_tpu/ops/attention.py:_decode_kernel (launched by
// _decode_pallas). Same function: for each slot b and q head h,
// out = softmax(q . K[:len] * scale) V[:len] over the first lengths[b]
// cached positions of kv head h / G (G = H / H_kv); lengths are clamped to
// [0, S]; positions at or past the cursor are stale pool memory and never
// enter the softmax (they are not even read); a slot with lengths == 0 gets
// zeros. Any group G that divides H is taken. As the TPU kernel rounds p to
// the cache's type before its second product (p.astype(v.dtype)), the
// bf16/f16 kernel rounds P to the input type before P V.
//
// What bounds it on the H100: bytes. Each cached K/V row is used once per
// q row of its group, about 0.5 flop a byte for MHA, so the ceiling is
// streaming sum(lengths) * 2 * H_kv * D * sizeof(T) at 3.35 TB/s. The
// design fills the card, keeps 16-byte loads in flight and pays no
// shuffle per (key, head):
//  * split-KV (flash-decoding): the grid is (slot x kv head, q-head tile,
//    split). The wrapper picks the number of splits (at most kMaxSplits)
//    and the keys a split covers (a multiple of 128) on the host, from
//    B * H_kv * tiles and S alone (ops/attention.py:decode_plan): none
//    where the (slot, kv head, tile) blocks fill most of a wave of the
//    card's SMs by themselves, else enough for a few waves however few
//    pairs there are; it never reads lengths, which lie on the card.
//    The blocks do: slot b's keys fill its first n_b = ceil(lengths[b] /
//    chunk) splits (1 for an empty slot), and a split at or past
//    lengths[b] exits at once, so it costs no bytes and no merge (its
//    empty partial, m = -inf and l = 0, would weigh 0 in the merge). With
//    n_b > 1 each of the n_b blocks writes its rows' partial (m, l,
//    unnormalised acc), then counts itself in on its (slot, kv head,
//    tile)'s arrival counter; the block that arrives last merges the
//    partials in split order, writes the output and sets the counter back
//    to 0 (merge_if_last). One launch a call, and the result is
//    independent of timing: which block arrives last changes nothing (a
//    second call is bit-identical). With n_b = 1 the block writes the
//    output itself;
//  * a block holds the group's q rows (a tile of up to 16 q heads) in
//    shared memory and shares each K/V row among them;
//  * bf16/f16 (decode_half): S = Q K^T and O += P V as mma.sync m16n8k16
//    products over tiles of keys (csrc/mxt_tc.cuh, the flash forward's
//    products), q rows (zero past the group) as M and keys as N. The row
//    max and sum are taken once a tile (two shuffles a row). Warps split a
//    stage's keys (KW key groups, each with its own online softmax, merged
//    once at the end in a fixed order) and, from D = 256, the output's
//    columns (DW warps of 128 or 64 columns each, which all form the same
//    S for their key group);
//  * f32 (decode_f32): CUDA-core FMA products, one thread a key: a thread
//    forms its key's dot products with the tile's q rows over a 1/P slice
//    of D, the P slices of a score are summed in a fixed order in shared
//    memory, one warp a row takes the tile's max and sum, and threads own
//    4-column slices of the output for a group of keys in P V. Products
//    and sums are f32, as in the plain version (only their order
//    differs), so the kernel keeps f32 accuracy against float64; decode's
//    ~0.5 flop a byte (8 at a group of 16) is far under the FP32 pipes'
//    20 flop a byte, so the tensor cores would buy no time here. The row
//    count is a template (1, 4, 8 or 16 rows) so that MHA carries no
//    padded rows;
//  * K and V rows stream through a cp.async ring of 16-byte chunks (8
//    halves or 4 floats), rows past the split's end zero-filled and
//    masked, so later tiles' loads are in flight while this one's
//    products run: three stages where two blocks still fit an SM, else
//    two.

#include <math.h>

#include "mxt_tc.cuh"

namespace {

using mxt_tc::Tile;

constexpr int kRows = 16;        // q heads a block: the mma's M
constexpr int kMaxSplits = 128;  // splits a call
// the last block's merge weights: [16][splits]
constexpr int kWeightBytes = kRows * kMaxSplits * 4;

template <int N>
__device__ __forceinline__ void wait_stages() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// three stages (two tiles in flight while one is multiplied) where two
// blocks still share an SM (228 KB, 1 KB reserved a block), else two
template <int kFixed, int kStage, int kFloor>
struct Ring {
  static constexpr int at(int n) {
    return n * kStage > kFloor ? n * kStage : kFloor;
  }
  static constexpr int kStages = 2 * (kFixed + at(3) + 1024) <= 233472 ? 3
                                                                        : 2;
  static constexpr int kBytes = at(kStages);
};

// warps, key tiles and the shared-memory footprint of a bf16/f16 instance
template <typename T, int D>
struct Cfg {
  // columns a warp: D up to 128; above, 128-column slices, or 64 where
  // 128 spilled beside the S loop (D 384) in ptxas -v
  static constexpr int DC = D <= 128 ? D : D == 384 ? 64 : 128;
  static constexpr int DW = D / DC;                   // column warps
  static constexpr int KW = DW == 1 ? 4 : DW == 2 ? 2 : 1;   // key groups
  // 8-key n-tiles a warp a stage, in pairs: a stage of KW * NT * 8 keys
  static constexpr int NT = D <= 32 ? 4 : 2;
  static constexpr int BK = KW * NT * 8;              // keys a stage
  static constexpr int kThreads = 32 * DW * KW;
  static constexpr int LD = D + Tile<T>::kPad;        // padded row
  static constexpr int kQBytes = kRows * LD * (int)sizeof(T);
  static constexpr int kStageBytes = 2 * BK * LD * (int)sizeof(T);
  static constexpr int kMergeBytes = KW * kRows * (D + 2) * 4;
  using R = Ring<kQBytes, kStageBytes,
                 (kMergeBytes > kWeightBytes ? kMergeBytes : kWeightBytes)>;
  static constexpr int kStages = R::kStages;
  static constexpr int kBytes = kQBytes + R::kBytes;
  static_assert(128 % BK == 0, "a split's keys are a multiple of 128");
};

// threads and tiles of an f32 instance with NR q rows a block
template <int D, int NR>
struct CfgF {
  static constexpr int kThreads = 128;
  // keys a stage: a stage of ~33 KB from D 64 on
  static constexpr int BK = D <= 64 ? 64 : D == 128 ? 32 : D == 256 ? 16 : 8;
  static constexpr int P = kThreads / BK;     // slices of a dot product
  static constexpr int DP = D / P;            // columns a slice
  static constexpr int CG = D / 4;            // 4-column output slices
  static constexpr int KG = CG >= kThreads ? 1 : kThreads / CG;  // key groups
  static constexpr int KPT = BK / KG;         // keys a thread in P V
  static constexpr int LD = D + Tile<float>::kPad;
  static constexpr int kQBytes = NR * LD * 4;
  static constexpr int kScoreBytes = P * NR * BK * 4;     // [P][NR][BK]
  static constexpr int kRowBytes = 3 * kRows * 4;         // corr, m, l
  static constexpr int kFixed = kQBytes + kScoreBytes + kRowBytes;
  static constexpr int kStageBytes = 2 * BK * LD * 4;
  static constexpr int kMergeBytes = KG * NR * D * 4;     // [KG][NR][D]
  using R = Ring<kFixed, kStageBytes,
                 (kMergeBytes > kWeightBytes ? kMergeBytes : kWeightBytes)>;
  static constexpr int kStages = R::kStages;
  static constexpr int kBytes = kFixed + R::kBytes;
  static_assert(P * BK == kThreads && DP % 4 == 0 && BK % KG == 0,
                "one thread a (key, slice); whole keys a key group");
  static_assert(128 % BK == 0, "a split's keys are a multiple of 128");
};

// Where each block of the grid (B * Hkv, tiles, splits) works: keys
// [start, end) of slot b, end = min(lengths[b], start + chunk), of the
// slot's nsplit splits that hold keys (1 if it has none); q heads [h0, h0
// + ng) (ng of the tile's 16); its arrival counter
struct Part {
  int b, split, splits, nsplit, start, end, ng, h0, slot;
  __device__ Part(const int* lengths, int Hkv, int S, int group,
                  int chunk) {
    const int bhk = blockIdx.x, hk = bhk % Hkv;
    b = bhk / Hkv;
    const int len = min(max(lengths[b], 0), S);
    split = blockIdx.z;
    splits = gridDim.z;
    nsplit = max(1, (len + chunk - 1) / chunk);
    start = split * chunk;
    end = min(len, start + chunk);
    const int g0 = blockIdx.y * kRows;
    ng = min(kRows, group - g0);
    h0 = hk * group + g0;
    slot = bhk * gridDim.y + blockIdx.y;
  }
  __device__ size_t row(int r, int H) const { return (size_t)b * H + h0 + r; }
};

// A slot with no key: zeros (its only split)
template <typename T>
__device__ __forceinline__ void put_zeros(const Part& w, int H, int D, T* o) {
  for (int i = threadIdx.x; i < w.ng * D; i += blockDim.x)
    o[w.row(0, H) * D + i] = mxt_round<T>(0.f);
}

// One element of the block's result: the output itself when the slot's
// keys fit one split, else its partial (m and l once a row)
template <typename T>
__device__ __forceinline__ void put(const Part& w, int H, int D, int r,
                                    int d, float m, float l, float acc, T* o,
                                    float* pm, float* pl, float* pacc) {
  const size_t row = w.row(r, H);
  if (w.nsplit > 1) {
    pacc[(row * w.splits + w.split) * D + d] = acc;
    if (d == 0) {
      pm[row * w.splits + w.split] = m;
      pl[row * w.splits + w.split] = l;
    }
  } else {
    o[row * D + d] = mxt_round<T>(acc / l);   // l >= 1: start < end
  }
}

// After every thread has written its part of the block's partial: count
// the block in; the last of the (slot, kv head, tile)'s nsplit splits to
// arrive merges them in split order, writes the output and sets the
// counter back to 0 for the next call. A warp a row turns the splits' m
// and l into weights (one trip to L2), then each thread merges 4 columns
// of a row at a time, its splits' loads in flight together. Not inlined:
// the merge keeps its registers apart from the kernel's main loop (ptxas
// spilled a few bytes when it was inlined into the f32 kernels).
// `scratch`: kWeightBytes of shared memory the block is done with.
template <typename T>
__device__ __noinline__ void merge_if_last(const Part& w, int H, int D,
                                          T* o, const float* pm,
                                          const float* pl, const float* pacc,
                                          int* count, float* scratch) {
  __shared__ int last;
  __threadfence();                 // this block's partial, device-wide
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(count + w.slot, 1) == w.nsplit - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int kPer = kMaxSplits / 32;       // splits a lane
  const int n = w.nsplit, lane = threadIdx.x & 31;
  float* wt = scratch;                        // [16][n]: 2^(m_s - mt) / lt
  for (int r = threadIdx.x >> 5; r < w.ng; r += blockDim.x >> 5) {
    const float* m = pm + w.row(r, H) * w.splits;
    const float* l = pl + w.row(r, H) * w.splits;
    float ms[kPer], ls[kPer], mt = -INFINITY;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      const int s = lane + 32 * e;
      ms[e] = s < n ? __ldcg(m + s) : -INFINITY;
      ls[e] = s < n ? __ldcg(l + s) : 0.f;
      mt = fmaxf(mt, ms[e]);
    }
#pragma unroll
    for (int o2 = 16; o2; o2 >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o2));
    float lt = 0.f;                           // every split holds keys
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      ms[e] = exp2f(ms[e] - mt);              // 0 past the splits
      lt += ls[e] * ms[e];
    }
#pragma unroll
    for (int o2 = 16; o2; o2 >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, o2);
#pragma unroll
    for (int e = 0; e < kPer; ++e)
      if (lane + 32 * e < n) wt[r * n + lane + 32 * e] = ms[e] / lt;
  }
  __syncthreads();
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < w.ng * D4; i += blockDim.x) {
    const int r = i / D4, c = (i % D4) * 4;
    const size_t row = w.row(r, H);
    const float* a = pacc + row * w.splits * D + c;
    float4 ot = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float f = wt[r * n + s];
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          a + (size_t)s * D));
      ot.x += f * x.x;
      ot.y += f * x.y;
      ot.z += f * x.z;
      ot.w += f * x.w;
    }
    mxt_st4(o + row * D + c, ot);
  }
  if (threadIdx.x == 0) count[w.slot] = 0;
}

// bf16/f16: S and P V on mma.sync (see the note at the top).
template <typename T, int D>
__global__ void __launch_bounds__(Cfg<T, D>::kThreads)
decode_half(const T* __restrict__ q, const T* __restrict__ k,
            const T* __restrict__ v, const int* __restrict__ lengths,
            T* __restrict__ o, float* __restrict__ pm,
            float* __restrict__ pl, float* __restrict__ pacc,
            int* __restrict__ count, int H, int Hkv, int S,
            float scale_log2, int group, int chunk) {
  using C = Cfg<T, D>;
  constexpr int DW = C::DW, KW = C::KW, DC = C::DC, NT = C::NT, BK = C::BK;
  constexpr int LD = C::LD, kThreads = C::kThreads;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  T* qs = reinterpret_cast<T*>(decode_smem);                 // [16][LD]
  unsigned char* ring = decode_smem + C::kQBytes;
  const Part w(lengths, Hkv, S, group, chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (w.split >= w.nsplit) return;           // past the slot's keys
  if (w.start >= w.end) {                    // an empty slot
    put_zeros<T>(w, H, D, o);
  } else {
    const int bhk = blockIdx.x, start = w.start, end = w.end, ng = w.ng;
    const T* kb = k + (size_t)bhk * S * D;
    const T* vb = v + (size_t)bhk * S * D;
    const int ntiles = (end - start + BK - 1) / BK;
    // tile `tile` (if there is one) into ring buffer tile % kStages; a
    // commit group either way
    auto fetch = [&](int tile) {
      if (tile < ntiles) {
        T* ks = reinterpret_cast<T*>(ring +
                                     tile % C::kStages * C::kStageBytes);
        T* vs = ks + BK * LD;
        const int r0 = start + tile * BK;
        mxt_tc::fetch_rows<T, D, BK, kThreads>(ks, kb, r0, end, LD);
        mxt_tc::fetch_rows<T, D, BK, kThreads>(vs, vb, r0, end, LD);
      }
      cp_async_commit();
    };
    for (int i = 0; i + 1 < C::kStages; ++i) fetch(i);

    // the tile's q rows, zeros past the group
    for (int i = tid; i < kRows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      qs[r * LD + c] = r < ng ? q[w.row(r, H) * D + c] : mxt_round<T>(0.f);
    }

    const int kw = warp / DW, dw = warp % DW;
    const int g = lane >> 2, t = lane & 3;
    float acc[1][DC / 8][4];
#pragma unroll
    for (int n = 0; n < DC / 8; ++n)
      acc[0][n][0] = acc[0][n][1] = acc[0][n][2] = acc[0][n][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};     // rows g and g + 8
    float l[2] = {0.f, 0.f};                 // this thread's share

    for (int it = 0; it < ntiles; ++it) {
      wait_stages<C::kStages - 2>();
      // tile it (and q) landed; every warp is done with tile it - 1,
      // whose buffer the next fetch refills
      __syncthreads();
      fetch(it + C::kStages - 1);
      const T* ks = reinterpret_cast<const T*>(
          ring + (it % C::kStages) * C::kStageBytes) + kw * NT * 8 * LD;
      const T* vs = ks + BK * LD;
      float s[1][NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        s[0][n][0] = s[0][n][1] = s[0][n][2] = s[0][n][3] = 0.f;
      mxt_tc::rows_by_rows<T, D, NT, 1>(qs, ks, LD, s, lane);
      const int j0 = start + it * BK + kw * NT * 8 + 2 * t;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = j0 + n * 8 + (e & 1) < end;
          s[0][n][e] = ok ? s[0][n][e] * scale_log2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[0][n][e]);
        }
      float corr[2], mn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mn[r] = fmaxf(m[r], mx[r]);
        corr[r] = m[r] == -INFINITY ? 0.f : exp2f(m[r] - mn[r]);
        m[r] = mn[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = s[0][n][e] == -INFINITY
                              ? 0.f : exp2f(s[0][n][e] - mn[e >> 1]);
          s[0][n][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < DC / 8; ++n) {
        acc[0][n][0] *= corr[0];
        acc[0][n][1] *= corr[0];
        acc[0][n][2] *= corr[1];
        acc[0][n][3] *= corr[1];
      }
      mxt_tc::cols_by_rows<T, DC, NT, 1>(s, vs + dw * DC, LD, acc, lane);
    }

    // the key groups' states merged in group order through shared memory
    // (the ring is dead once every warp is past its last tile)
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    float* red = reinterpret_cast<float*>(ring);        // [KW][16][D]
    float* red_m = red + KW * kRows * D;                // [KW][16]
    float* red_l = red_m + KW * kRows;                  // [KW][16]
    if (dw == 0 && t == 0) {
      red_m[kw * kRows + g] = m[0];
      red_m[kw * kRows + g + 8] = m[1];
      red_l[kw * kRows + g] = l[0];
      red_l[kw * kRows + g + 8] = l[1];
    }
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
      float* row = red + (kw * kRows + g) * D + dw * DC + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(row) =
          make_float2(acc[0][n][0], acc[0][n][1]);
      *reinterpret_cast<float2*>(row + 8 * D) =
          make_float2(acc[0][n][2], acc[0][n][3]);
    }
    __syncthreads();
    for (int i = tid; i < ng * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float mt = -INFINITY;
#pragma unroll
      for (int kg = 0; kg < KW; ++kg) mt = fmaxf(mt, red_m[kg * kRows + r]);
      float lt = 0.f, ot = 0.f;
#pragma unroll
      for (int kg = 0; kg < KW; ++kg) {
        const float mw = red_m[kg * kRows + r];
        if (mw == -INFINITY) continue;        // a group past the end
        const float f = exp2f(mw - mt);
        lt += red_l[kg * kRows + r] * f;
        ot += red[(kg * kRows + r) * D + d] * f;
      }
      put<T>(w, H, D, r, d, mt, lt, ot, o, pm, pl, pacc);
    }
  }
  if (w.nsplit > 1)
    merge_if_last<T>(w, H, D, o, pm, pl, pacc, count,
                     reinterpret_cast<float*>(ring));
}

// f32: FMA products, one thread a (key, slice of D) for S and a (group of
// keys, 4 columns) for P V; NR q rows a block (ng <= NR).
template <int D, int NR>
__global__ void __launch_bounds__(128)
decode_f32(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const int* __restrict__ lengths,
           float* __restrict__ o, float* __restrict__ pm,
           float* __restrict__ pl, float* __restrict__ pacc,
           int* __restrict__ count, int H, int Hkv, int S, float scale_log2,
           int group, int chunk) {
  using C = CfgF<D, NR>;
  constexpr int BK = C::BK, P = C::P, DP = C::DP, CG = C::CG, KG = C::KG;
  constexpr int KPT = C::KPT, LD = C::LD, kThreads = C::kThreads;
  constexpr int NR4 = (NR + 3) / 4;          // rows a warp in the softmax
  extern __shared__ __align__(16) unsigned char decode_smem[];
  float* qs = reinterpret_cast<float*>(decode_smem);        // [NR][LD]
  float* sp = qs + NR * LD;          // [P][NR][BK] scores; [NR][BK] P
  float* corr_s = sp + P * NR * BK;                          // [16]
  float* row_m = corr_s + kRows;                             // [16]
  float* row_l = row_m + kRows;                              // [16]
  unsigned char* ring = decode_smem + C::kFixed;
  const Part w(lengths, Hkv, S, group, chunk);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (w.split >= w.nsplit) return;           // past the slot's keys
  if (w.start >= w.end) {                    // an empty slot
    put_zeros<float>(w, H, D, o);
  } else {
    const int bhk = blockIdx.x, start = w.start, end = w.end, ng = w.ng;
    const float* kb = k + (size_t)bhk * S * D;
    const float* vb = v + (size_t)bhk * S * D;
    const int ntiles = (end - start + BK - 1) / BK;
    auto fetch = [&](int tile) {
      if (tile < ntiles) {
        float* ks = reinterpret_cast<float*>(
            ring + tile % C::kStages * C::kStageBytes);
        const int r0 = start + tile * BK;
        mxt_tc::fetch_rows<float, D, BK, kThreads>(ks, kb, r0, end, LD);
        mxt_tc::fetch_rows<float, D, BK, kThreads>(ks + BK * LD, vb, r0,
                                                   end, LD);
      }
      cp_async_commit();
    };
    for (int i = 0; i + 1 < C::kStages; ++i) fetch(i);

    // the tile's q rows, zeros past the group: every loop below runs all
    // NR rows (no branch on ng inside them); rows past ng are never stored
    for (int i = tid; i < NR * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      *reinterpret_cast<float4*>(qs + r * LD + c) =
          r < ng ? *reinterpret_cast<const float4*>(q + w.row(r, H) * D + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }

    const int j = tid % BK, p = tid / BK;    // S: key j, slice p
    const int cg = tid % CG, kg = tid / CG;  // P V: columns 4 cg, key group
    const bool pv = tid < CG * KG;
    float acc[NR][4];
#pragma unroll
    for (int r = 0; r < NR; ++r)
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    float m[NR4], l[NR4];                    // the softmax warp's rows
#pragma unroll
    for (int i = 0; i < NR4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }

    for (int it = 0; it < ntiles; ++it) {
      wait_stages<C::kStages - 2>();
      __syncthreads();                       // tile it landed; it - 1 done
      fetch(it + C::kStages - 1);
      const float* ks = reinterpret_cast<const float*>(
          ring + (it % C::kStages) * C::kStageBytes);
      const float* vs = ks + BK * LD;
      {                                      // S's slice p of key j
        float s[NR];
#pragma unroll
        for (int r = 0; r < NR; ++r) s[r] = 0.f;
        const float* kr = ks + j * LD + p * DP;
        const float* qr = qs + p * DP;
#pragma unroll
        for (int c = 0; c < DP; c += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float4 qv =
                *reinterpret_cast<const float4*>(qr + r * LD + c);
            s[r] = fmaf(qv.x, kv.x, s[r]);
            s[r] = fmaf(qv.y, kv.y, s[r]);
            s[r] = fmaf(qv.z, kv.z, s[r]);
            s[r] = fmaf(qv.w, kv.w, s[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < NR; ++r) sp[(p * NR + r) * BK + j] = s[r];
      }
      __syncthreads();
      // the tile's max and sum, one warp a row: P over sp[0]
      // (a warp's rows side by side, so their shuffles overlap; a row
      // past the group computes on zero scores and is never stored)
      const int kt = start + it * BK;
      constexpr int KL = (BK + 31) / 32;
      float sv[NR4][KL], mx[NR4];
#pragma unroll
      for (int i = 0; i < NR4; ++i) {
        const int r = (warp + 4 * i) % NR;
        mx[i] = -INFINITY;
#pragma unroll
        for (int e = 0; e < KL; ++e) {
          const int jj = lane + 32 * e;
          float t = -INFINITY;
          if (jj < BK && kt + jj < end) {
            t = 0.f;
#pragma unroll
            for (int pp = 0; pp < P; ++pp) t += sp[(pp * NR + r) * BK + jj];
            t *= scale_log2;
          }
          sv[i][e] = t;
          mx[i] = fmaxf(mx[i], t);
        }
      }
#pragma unroll
      for (int o2 = 16; o2; o2 >>= 1)
#pragma unroll
        for (int i = 0; i < NR4; ++i)
          mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], o2));
      float sum[NR4], c[NR4];
#pragma unroll
      for (int i = 0; i < NR4; ++i) {
        const int r = (warp + 4 * i) % NR;
        const float mn = fmaxf(m[i], mx[i]);  // finite: the tile has a key
        c[i] = m[i] == -INFINITY ? 0.f : exp2f(m[i] - mn);
        m[i] = mn;
        sum[i] = 0.f;
#pragma unroll
        for (int e = 0; e < KL; ++e) {
          const int jj = lane + 32 * e;
          const float pe =
              sv[i][e] == -INFINITY ? 0.f : exp2f(sv[i][e] - mn);
          if (jj < BK && warp + 4 * i < NR) sp[r * BK + jj] = pe;
          sum[i] += pe;
        }
      }
#pragma unroll
      for (int o2 = 16; o2; o2 >>= 1)
#pragma unroll
        for (int i = 0; i < NR4; ++i)
          sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o2);
#pragma unroll
      for (int i = 0; i < NR4; ++i) {
        l[i] = l[i] * c[i] + sum[i];
        if (lane == 0 && warp + 4 * i < NR) corr_s[warp + 4 * i] = c[i];
      }
      __syncthreads();
      if (pv) {                              // O += P V, keys of group kg
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float c = corr_s[r];
          acc[r][0] *= c;
          acc[r][1] *= c;
          acc[r][2] *= c;
          acc[r][3] *= c;
        }
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) {
          const int jk = kg * KPT + jj;
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + jk * LD + 4 * cg);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            const float pr = sp[r * BK + jk];
            acc[r][0] = fmaf(pr, vv.x, acc[r][0]);
            acc[r][1] = fmaf(pr, vv.y, acc[r][1]);
            acc[r][2] = fmaf(pr, vv.z, acc[r][2]);
            acc[r][3] = fmaf(pr, vv.w, acc[r][3]);
          }
        }
      }
    }

    // the key groups' sums added in group order (they share the row max)
    __syncthreads();
    float* red = reinterpret_cast<float*>(ring);            // [KG][NR][D]
    if (pv) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        *reinterpret_cast<float4*>(red + (kg * NR + r) * D + 4 * cg) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < NR4; ++i) {
      const int r = warp + 4 * i;
      if (r < ng && lane == 0) {
        row_m[r] = m[i];
        row_l[r] = l[i];
      }
    }
    __syncthreads();
    for (int i = tid; i < ng * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float ot = 0.f;
#pragma unroll
      for (int g = 0; g < KG; ++g) ot += red[(g * NR + r) * D + d];
      put<float>(w, H, D, r, d, row_m[r], row_l[r], ot, o, pm, pl, pacc);
    }
  }
  if (w.nsplit > 1)
    merge_if_last<float>(w, H, D, o, pm, pl, pacc, count,
                         reinterpret_cast<float*>(ring));
}

template <typename T>
struct Args {
  const T *q, *k, *v;
  const int* lengths;
  T* o;
  float *pm, *pl, *pacc;
  int* count;
  int B, H, Hkv, S, chunk, splits;
  float scale_log2;
  int device;
  cudaStream_t stream;
};

// one instance's launch; its shared-memory opt-in once a device
template <auto kernel, typename T>
cudaError_t go(int threads, int bytes, const Args<T>& x) {
  static bool opted[64] = {false};
  if (x.device < 0 || x.device >= 64 || !opted[x.device]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    if (x.device >= 0 && x.device < 64) opted[x.device] = true;
  }
  const int group = x.H / x.Hkv;
  dim3 grid(x.B * x.Hkv, (group + kRows - 1) / kRows, x.splits);
  const bool split = x.splits > 1;
  kernel<<<grid, threads, bytes, x.stream>>>(
      x.q, x.k, x.v, x.lengths, x.o, split ? x.pm : nullptr,
      split ? x.pl : nullptr, split ? x.pacc : nullptr,
      split ? x.count : nullptr, x.H, x.Hkv, x.S, x.scale_log2, group,
      x.chunk);
  mxt_counted();
  return cudaGetLastError();
}

template <int D, int NR>
cudaError_t go_f32(const Args<float>& x) {
  using C = CfgF<D, NR>;
  return go<&decode_f32<D, NR>>(C::kThreads, C::kBytes, x);
}

template <typename T, int D>
cudaError_t launch(const Args<T>& x) {
  if constexpr (Tile<T>::kHalf) {
    using C = Cfg<T, D>;
    return go<&decode_half<T, D>>(C::kThreads, C::kBytes, x);
  } else {
    const int group = x.H / x.Hkv;
    const int ng = group < kRows ? group : kRows;  // q rows a block, at most
    if (ng == 1) return go_f32<D, 1>(x);
    if (ng <= 4) return go_f32<D, 4>(x);
    if (ng <= 8) return go_f32<D, 8>(x);
    return go_f32<D, 16>(x);
  }
}

template <typename T>
cudaError_t run(int D, const Args<T>& x) {
  switch (D) {
    case 16: return launch<T, 16>(x);
    case 32: return launch<T, 32>(x);
    case 64: return launch<T, 64>(x);
    case 128: return launch<T, 128>(x);
    case 256: return launch<T, 256>(x);
    case 384: return launch<T, 384>(x);
    case 512: return launch<T, 512>(x);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_as(int D, const void* q, const void* k, const void* v,
                   const void* lengths, void* o, void* pm, void* pl,
                   void* pacc, void* count, int B, int H, int Hkv, int S,
                   int chunk, int splits, float scale, int device,
                   cudaStream_t stream) {
  const Args<T> x{static_cast<const T*>(q), static_cast<const T*>(k),
                  static_cast<const T*>(v), static_cast<const int*>(lengths),
                  static_cast<T*>(o), static_cast<float*>(pm),
                  static_cast<float*>(pl), static_cast<float*>(pacc),
                  static_cast<int*>(count), B, H, Hkv, S, chunk, splits,
                  scale * 1.4426950408889634f, device, stream};
  return run<T>(D, x);
}

}  // namespace

// q (B,H,D), k/v (B,Hkv,S,D), o (B,H,D) of one element type (dtype:
// MXT_F32, MXT_BF16 or MXT_F16), 16-byte aligned; lengths (B,) int32; all
// contiguous. splits (1..128) blocks of `chunk` keys (a multiple of 128)
// per (slot, kv head, tile of 16 q heads), splits * chunk >= S. With
// splits > 1: pm and pl (B,H,splits) and pacc (B,H,splits,D) f32 scratch,
// and count, one int32 a (slot, kv head, tile), all 0 (the kernel leaves
// them 0 again); calls that share count must run in order (one stream).
// One launch.
extern "C" int mxt_decode_attention(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* pm, void* pl, void* pacc,
                                    void* count, int B, int H, int Hkv,
                                    int S, int D, int chunk, int splits,
                                    float scale, int dtype, int device,
                                    void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (B * Hkv <= 0) return cudaSuccess;
  if (Hkv <= 0 || H % Hkv || splits < 1 || splits > kMaxSplits ||
      chunk < 128 || chunk % 128 || (long long)chunk * splits < S ||
      (H / Hkv + kRows - 1) / kRows > 65535 ||
      (splits > 1 && (!pm || !pl || !pacc || !count)))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case MXT_F32:
      return run_as<float>(D, q, k, v, lengths, o, pm, pl, pacc, count, B,
                           H, Hkv, S, chunk, splits, scale, device, st);
    case MXT_BF16:
      return run_as<__nv_bfloat16>(D, q, k, v, lengths, o, pm, pl, pacc,
                                   count, B, H, Hkv, S, chunk, splits, scale,
                                   device, st);
    case MXT_F16:
      return run_as<__half>(D, q, k, v, lengths, o, pm, pl, pacc, count, B,
                            H, Hkv, S, chunk, splits, scale, device, st);
    default: return cudaErrorInvalidValue;
  }
}
