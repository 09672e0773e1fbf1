// Weight-only quantized matmul, float32 or bfloat16 activations x int8 /
// fp8-e4m3 weights, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/quantization.py:_qmm_kernel (launched by
// _qmm_pallas). Same function: out[m, n] = (sum_k x[m, k] * widen(q[k, n]))
// * scale[n], f32 accumulation, the per-column scale applied once in the
// epilogue (it factors out of the contraction), out in x's dtype. The wide
// weight never exists in device memory. Two kernels, one launch a call;
// the wrapper picks one by shape (ops/quantization.py:_qmm_route):
//
// Both run on the bf16 tensor cores with exact products: every int8 value
// (|q| <= 127) and every e4m3 value is a bf16 value, and an f32 x is the
// exact sum of three bf16 pieces (hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid)), so sum over pieces of piece @ bf16(q), accumulated in
// f32 by mma.sync.m16n8k16, forms every product x * q exactly and differs
// from an f32 FMA loop only in the order of the sums. bf16 x is one piece.
// Weights are widened in registers without the conversion pipe (16
// conversions a clock an SM): int8 by a byte permute under the exponent of
// 2^23 and one subtraction; e4m3 by moving its 7 exponent+mantissa bits
// under a float's and scaling by 2^120 (exact, subnormals too; 0x7f / 0xff
// give NaN as e4m3fn says).
//
// qmm_small — decode (M <= 16; any shape the other does not take).
// What bounds it: bytes. The narrow weight is read once for 2*M flops a
// byte, so the ceiling is K*N bytes at 3.35 TB/s (1.25 us for a 1024 x 4096
// layer). An FMA loop would spend ~10 instructions a weight at M = 8 (8
// FMAs and the widening) and could not keep pace with HBM on the
// vocabulary head; here the tensor cores take the products, with the
// weight as the mma's A (16 columns x 16 k) and x as its B (16 k x 8 slots,
// two n tiles for 9..16 slots), so a weight costs its widening and a
// fraction of an mma.
//  * a block of 4 warps owns 128 columns and one K split; each warp streams
//    its own k steps of 16 rows (steps w, w + 4, ...) through cp.async
//    stages of its own (3 at up to 8 slots, where 4 blocks share an SM; 4
//    at 16): each row segment is copied as the aligned 16-byte
//    chunks around it (8, or 9 where rows are not 16-byte aligned, as for
//    the head's odd N = 50257), so every load is a full 16-byte copy and
//    none is made byte by byte;
//  * a thread reads 16 columns of 4 rows from its stage (one 16-byte read a
//    row, or 5 words and a funnel shift, the same for every step, where
//    rows are unaligned) and builds 8 mma A fragments from them: the mma's
//    k pairs are rows t and t + 4 (t + 8 and t + 12), its m pairs columns
//    2T and 2T + 1 of the thread's 16;
//  * x (the split's rows, 512 at a time) is staged by 16-byte cp.async,
//    in x's own dtype, padded so a warp reads it without bank conflicts,
//    and split into pieces where it is read;
//  * the grid is (column tiles, K splits, 16-row tiles of x); K is split
//    (up to 8 ways) while the blocks are fewer than the SMs. A tile's splits
//    form one thread-block cluster: each block sums its warps in warp order
//    through shared memory, then every block of the cluster finishes a
//    slice of the tile, reading the others' sums through distributed
//    shared memory (DSMEM) in split order: one launch, no atomics, no
//    workspace, and a second call gives bit-identical results.
//
// qmm_tc — prefill (M > 16; N % 16 == 0, K % 4 (f32) or % 8 (bf16), all
// pointers 16-byte aligned). What bounds it: operations, on the tensor
// cores as above.
//  * 128 x 128 output blocks, 256 threads (8 warps of 64 x 32), K in
//    tiles of 32: x and narrow-w tiles double-buffered by cp.async; each
//    tile is then split (x) and widened (w) into bf16 tiles in shared
//    memory, padded so ldmatrix reads them without bank conflicts (x rows
//    of 80 bytes, w rows of 272; w is read with ldmatrix.trans);
//  * the scale multiplies the f32 accumulators in the epilogue;
//  * where the output tiles fill less than the card (a narrow N at large
//    K: (1000, 4096) x (4096, 1024) has 64 tiles), K is split over a
//    cluster of up to 4 blocks, whose f32 tiles are summed in split order
//    through distributed shared memory (one launch, deterministic).
// Its bound is 3 * 2MNK / 989 TFLOP/s for f32 x (the FP32 pipes' would be
// 2MNK / 67 TFLOP/s: the pieces cost 3 tensor-core products for a 15x
// faster pipe). wgmma and TMA are a later step.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mxt_common.cuh"

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// widening
// ---------------------------------------------------------------------------

// the 4 bytes of w as floats, byte 0 first
template <int KIND>
__device__ __forceinline__ void widen4(uint32_t w, float* f) {
  if (KIND == 0) {
    // q ^ 0x80 is q + 128 as an unsigned byte u; 0x4b0000uu is 2^23 + u
    const uint32_t u = w ^ 0x80808080u;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7440 + i))
             - 8388736.f;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // byte i on top: sign at bit 31, exponent+mantissa at 24..30, moved
      // to 20..26 (a float's exponent low bits and mantissa top bits)
      const uint32_t t = __byte_perm(w, 0u, 0x0444 | (i << 12));
      const float v = __uint_as_float((t & 0x80000000u) |
                                      ((t >> 4) & 0x07f00000u))
                      * 1.329227995784916e36f;      // 2^120
      f[i] = ((t & 0x7f000000u) == 0x7f000000u) ? __int_as_float(0x7fc00000)
                                                 : v;
    }
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// SMs of a device, asked once (the launchers size their grids by it)
inline int sm_count(int device) {
  static int sms[64] = {0};
  if (device < 0 || device >= 64) return 132;
  if (sms[device] == 0 &&
      cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    return 132;
  return sms[device];
}

// a kernel's dynamic shared memory opt-in, set once per device
template <typename F>
cudaError_t opt_in_smem(F kernel, int bytes, int device, bool* done) {
  if (device >= 0 && device < 64 && done[device]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && device >= 0 && device < 64) done[device] = true;
  return e;
}

// ---------------------------------------------------------------------------
// qmm_tc: bf16 tensor cores, f32 x as three exact bf16 pieces
// ---------------------------------------------------------------------------
constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kTcThreads = 256;
constexpr int kAStride = kBK + 8;          // bf16 per x-piece row: 80 bytes
constexpr int kBStride = kBN + 8;          // bf16 per wide-w row: 272 bytes
constexpr int kRedStride = kBN + 4;        // f32 per row of a split's tile

template <typename XT>
struct TcSmem {
  static constexpr bool kF32 = sizeof(XT) == 4;
  static constexpr int kPieces = kF32 ? 3 : 1;
  // f32: raw x stages [2][kBM][kBK] f32, split into kPieces tiles;
  // bf16: cp.async lands in the piece tiles directly, double-buffered
  static constexpr int kRawX = kF32 ? 2 * kBM * kBK * 4 : 0;
  static constexpr int kRawW = 2 * kBK * kBN;
  static constexpr int kPieceBytes = kBM * kAStride * 2;
  static constexpr int kPiecesBytes = (kF32 ? kPieces : 2) * kPieceBytes;
  static constexpr int kWide = kBK * kBStride * 2;
  static constexpr int kTiles = kRawX + kRawW + kPiecesBytes + kWide;
  // the K-split epilogue reuses the space for the f32 tile
  static constexpr int kRed = kBM * kRedStride * 4;
  static constexpr int kBytes = kTiles > kRed ? kTiles : kRed;
};


__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t* r) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t* r) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats that are bf16 values (low 16 bits zero) as one bf16x2 word
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// x = hi + mid + lo exactly, each a bf16 value (rounded to nearest)
__device__ __forceinline__ void split3(float x, float* p) {
  const float hi = __bfloat162float(__float2bfloat16_rn(x));
  const float r = x - hi;
  const float mid = __bfloat162float(__float2bfloat16_rn(r));
  p[0] = hi;
  p[1] = mid;
  p[2] = __bfloat162float(__float2bfloat16_rn(r - mid));
}

template <int KIND, typename XT>
__global__ void __launch_bounds__(kTcThreads)
qmm_tc(const XT* __restrict__ x, const uint8_t* __restrict__ w,
       const float* __restrict__ scale, XT* __restrict__ out, int M, int N,
       int K) {
  using L = TcSmem<XT>;
  constexpr int P = L::kPieces;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  float* raw_x = reinterpret_cast<float*>(tc_smem);          // f32 only
  uint8_t* raw_w = tc_smem + L::kRawX;                         // [2][kBK][kBN]
  __nv_bfloat16* pieces =
      reinterpret_cast<__nv_bfloat16*>(tc_smem + L::kRawX + L::kRawW);
  __nv_bfloat16* wide = reinterpret_cast<__nv_bfloat16*>(
      tc_smem + L::kRawX + L::kRawW + L::kPiecesBytes);        // [kBK][kBStride]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  // K split z of gridDim.z (one cluster): k tiles [kt0, kt1)
  const int n_all = (K + kBK - 1) / kBK;
  const int per_split = (n_all + gridDim.z - 1) / gridDim.z;
  const int kt0 = min(n_all, (int)blockIdx.z * per_split);
  const int kt1 = min(n_all, kt0 + per_split);

  auto fetch = [&](int kt, int stage) {
    const int k0 = kt * kBK;
    if constexpr (L::kF32) {
      // x tile [kBM][kBK] f32: 8 chunks of 16 bytes a row
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kTcThreads; ++i) {
        const int c = tid + i * kTcThreads;
        const int r = c >> 3, kc = (c & 7) * 4;
        const bool ok = bm + r < M && k0 + kc < K;
        cp_async16(raw_x + (stage * kBM + r) * kBK + kc,
                   ok ? x + (size_t)(bm + r) * K + k0 + kc : x, ok);
      }
    } else {
      // x tile lands in the piece buffer of this stage: 4 chunks a row
#pragma unroll
      for (int i = 0; i < kBM * kBK / 8 / kTcThreads; ++i) {
        const int c = tid + i * kTcThreads;
        const int r = c >> 2, kc = (c & 3) * 8;
        const bool ok = bm + r < M && k0 + kc < K;
        cp_async16(pieces + (stage * kBM + r) * kAStride + kc,
                   ok ? x + (size_t)(bm + r) * K + k0 + kc : x, ok);
      }
    }
    {
      // narrow w tile [kBK][kBN] bytes: 8 chunks of 16 a row, one a thread
      const int r = tid >> 3, nc = (tid & 7) * 16;
      const bool ok = k0 + r < K && bn + nc < N;
      cp_async16(raw_w + (stage * kBK + r) * kBN + nc,
                 ok ? w + (size_t)(k0 + r) * N + bn + nc : w, ok);
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  if (kt0 < kt1) fetch(kt0, 0);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) & 1;
    cp_async_wait_all();
    __syncthreads();          // tile kt landed; tile kt - 1 fully consumed
    if (kt + 1 < kt1) fetch(kt + 1, stage ^ 1);
    // widen w: 16 bytes a thread into 16 bf16 of row r
    {
      const int r = tid >> 3, nc = (tid & 7) * 16;
      const uint4 b = *reinterpret_cast<const uint4*>(
          raw_w + (stage * kBK + r) * kBN + nc);
      const uint32_t words[4] = {b.x, b.y, b.z, b.w};
      uint32_t packed[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float f[4];
        widen4<KIND>(words[j], f);
        packed[2 * j] = pack_exact(f[0], f[1]);
        packed[2 * j + 1] = pack_exact(f[2], f[3]);
      }
      uint4* dst = reinterpret_cast<uint4*>(wide + r * kBStride + nc);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    if constexpr (L::kF32) {
      // split x: 16 floats a thread into the three piece tiles
#pragma unroll
      for (int i = 0; i < kBM * kBK / 4 / kTcThreads; ++i) {
        const int c = tid + i * kTcThreads;
        const int r = c >> 3, kc = (c & 7) * 4;
        const float4 v = *reinterpret_cast<const float4*>(
            raw_x + (stage * kBM + r) * kBK + kc);
        float a[3], b[3], cc[3], d[3];
        split3(v.x, a); split3(v.y, b); split3(v.z, cc); split3(v.w, d);
#pragma unroll
        for (int p = 0; p < 3; ++p)
          *reinterpret_cast<uint2*>(pieces + (p * kBM + r) * kAStride + kc) =
              make_uint2(pack_exact(a[p], b[p]), pack_exact(cc[p], d[p]));
      }
    }
    __syncthreads();
    const __nv_bfloat16* xa = L::kF32 ? pieces : pieces + stage * kBM * kAStride;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[4][2];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        uint32_t r[4];
        ldsm_x4_t(wide + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kBStride
                       + wn + nb * 16 + (lane >> 4) * 8, r);
        b[2 * nb][0] = r[0]; b[2 * nb][1] = r[1];
        b[2 * nb + 1][0] = r[2]; b[2 * nb + 1][1] = r[3];
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t a[4];
          ldsm_x4(xa + (p * kBM + wm + mi * 16 + (lane & 7)
                        + ((lane >> 3) & 1) * 8) * kAStride
                     + kk + (lane >> 4) * 8, a);
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a, b[ni]);
        }
      }
    }
  }

  // epilogue: c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at row g + 8
  const int g = lane >> 2, t = lane & 3;
  if (gridDim.z > 1) {
    // K splits: each block's tile into its shared memory, then every block
    // of the cluster sums a slice of rows over the splits, in split order
    cg::cluster_group cluster = cg::this_cluster();
    float* red = reinterpret_cast<float*>(tc_smem);       // [kBM][kRedStride]
    __syncthreads();                         // the tiles are dead
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              red + (wm + mi * 16 + g + 8 * h) * kRedStride + wn + ni * 8 +
              2 * t) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    cluster.sync();
    const int splits = gridDim.z;
    const int rows = (kBM + splits - 1) / splits;
    const int r1 = min(kBM, (int)(blockIdx.z + 1) * rows);
    for (int e = blockIdx.z * rows * kBN + tid; e < r1 * kBN;
         e += kTcThreads) {
      const int r = e / kBN, c = e % kBN;
      const int gm = bm + r, gn = bn + c;
      float sum = 0.f;
      for (int z = 0; z < splits; ++z)
        sum += cluster.map_shared_rank(red, z)[r * kRedStride + c];
      if (gm < M && gn < N) store(out + (size_t)gm * N + gn, sum * scale[gn]);
    }
    cluster.sync();                          // keep red alive for the others
    return;
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int gn = bn + wn + ni * 8 + 2 * t;
    if (gn >= N) continue;                   // N % 16 == 0: gn + 1 < N too
    const float s0 = scale[gn], s1 = scale[gn + 1];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = bm + wm + mi * 16 + g + 8 * h;
        if (gm >= M) continue;
        XT* o = out + (size_t)gm * N + gn;
        store(o, acc[mi][ni][2 * h] * s0);
        store(o + 1, acc[mi][ni][2 * h + 1] * s1);
      }
    }
  }
}

template <int KIND, typename XT>
cudaError_t run_tc(const XT* x, const uint8_t* w, const float* scale,
                   XT* out, int M, int N, int K, int device,
                   cudaStream_t stream) {
  constexpr int smem = TcSmem<XT>::kBytes;
  static bool opted[64] = {false};
  cudaError_t e = opt_in_smem(qmm_tc<KIND, XT>, smem, device, opted);
  if (e != cudaSuccess) return e;
  const int sms = sm_count(device);
  // split K (a cluster of up to 4) while the tiles fill less than two
  // blocks an SM and each split keeps >= 256 of K, e.g. (1000, 4096) x
  // (4096, 1024): 64 tiles x 4 splits
  const int tiles = ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  int splits = 1;
  while (splits < 4 && 2 * tiles * splits <= 2 * sms &&
         K >= 2 * splits * 256)
    splits *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_tc<KIND, XT>, x, w, scale, out, M, N, K);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// qmm_small: decode on the bf16 tensor cores, weight rows staged by cp.async
// ---------------------------------------------------------------------------
constexpr int kSmallThreads = 128;         // 4 warps
constexpr int kSmallCols = 128;            // a block's column tile
constexpr int kSmallRowBytes = 160;        // a staged row: 9 chunks + padding
constexpr int kSmallStageBytes = 16 * kSmallRowBytes;
constexpr int kSmallChunk = 512;           // x rows staged at a time

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a staged x row: KC values of x's dtype plus padding that puts the 8 rows
// a warp reads (slot g, value t + 4i) in distinct banks
template <typename XT>
__host__ __device__ constexpr int small_x_stride(int kc) {
  return kc + (sizeof(XT) == 4 ? 4 : 8);
}

// shared memory of qmm_small: the staged x (later the warps' partials), then
// every warp's weight stages
// cp.async stages of a warp: 3 where 4 blocks share an SM (8 slots), 4
// where 2 do (16 slots, twice the accumulators)
__host__ __device__ constexpr int small_stages(int nt) {
  return nt == 1 ? 3 : 4;
}

template <int MT, typename XT>
__host__ __device__ constexpr int small_smem_bytes() {
  constexpr int x = MT * small_x_stride<XT>(kSmallChunk) * (int)sizeof(XT);
  constexpr int red = 4 * MT * kSmallCols * 4;
  return (x > red ? x : red) +
         4 * small_stages(MT / 8) * kSmallStageBytes;
}

template <int KIND, int NT, int P, bool ALIGNED, typename XT>
__global__ void __launch_bounds__(kSmallThreads, NT == 1 ? 4 : 2)
qmm_small(const XT* __restrict__ x, const uint8_t* __restrict__ w,
          const float* __restrict__ scale, XT* __restrict__ out, int M,
          int N, int K) {
  constexpr int MT = 8 * NT;
  constexpr int KC = kSmallChunk;
  constexpr int kSmallStages = small_stages(NT);
  constexpr int XS = small_x_stride<XT>(KC);
  constexpr int NCH = ALIGNED ? 8 : 9;       // 16-byte chunks a weight row
  extern __shared__ __align__(16) unsigned char small_smem[];
  XT* xs = reinterpret_cast<XT*>(small_smem);   // [slot][k], raw x
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* stages = small_smem + small_smem_bytes<MT, XT>() -
                          (4 - warp) * kSmallStages * kSmallStageBytes;
  const int c0 = blockIdx.x * kSmallCols;
  const int m0 = blockIdx.z * MT;
  const int splits = gridDim.y;              // the cluster: one column tile
  const int span = ((K + splits - 1) / splits + 15) & ~15;
  const int kb = min(K, (int)blockIdx.y * span), ke = min(K, kb + span);
  const uintptr_t wbase = reinterpret_cast<uintptr_t>(w);
  const uintptr_t wend = wbase + (size_t)K * N;

  float acc[NT][8][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int T = 0; T < 8; ++T)
      acc[nt][T][0] = acc[nt][T][1] = acc[nt][T][2] = acc[nt][T][3] = 0.f;

  // A k step's rows start 16 * N bytes apart from the last one's, so the
  // offset of a row segment within its aligned 16 bytes is the same at
  // every step: the chunks a lane copies and the words a thread reads are
  // set once, as offsets from the step's first row.
  const uintptr_t wb0 = wbase + (size_t)kb * N + c0;
  constexpr int kIssue = (16 * NCH + 31) / 32;  // chunks a lane copies
  int coff[kIssue];                             // from the step's first row
#pragma unroll
  for (int j = 0; j < kIssue; ++j) {
    const int idx = min(lane + 32 * j, 16 * NCH - 1);
    const int r = idx / NCH, ch = idx - r * NCH;
    coff[j] = r * N - static_cast<int>((wb0 + (size_t)r * N) & 15) + 16 * ch;
  }
  int roff[4], rsh[4];                          // row t + 4i: byte, shift
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sft = ALIGNED ? 0 : static_cast<int>(
        (wb0 + (size_t)(t + 4 * i) * N) & 15);
    roff[i] = (t + 4 * i) * kSmallRowBytes + (sft & ~3) + 16 * g;
    rsh[i] = (sft & 3) * 8;
  }

  // rows kr0 .. kr0 + 15 (those below kend) of the tile's columns into
  // stage buffer buf: the aligned 16-byte chunks around each row segment
  auto issue = [&](int kr0, int kend, int buf) {
    unsigned char* dst = stages + buf * kSmallStageBytes;
    const uintptr_t rb = wb0 + (size_t)(kr0 - kb) * N;
    // every chunk inside w and every row inside the chunk of x
    const bool all = kr0 + 16 <= kend &&
                     (size_t)(kr0 + 16) * N + c0 + 16 * NCH <= (size_t)K * N;
#pragma unroll
    for (int j = 0; j < kIssue; ++j) {
      const int idx = lane + 32 * j;
      if (idx < 16 * NCH) {
        const int r = idx / NCH, ch = idx - r * NCH;
        const uintptr_t ca = rb + coff[j];
        const bool ok = all || (kr0 + r < kend && ca < wend);
        cp_async16(dst + r * kSmallRowBytes + 16 * ch,
                   ok ? reinterpret_cast<const void*>(ca)
                      : static_cast<const void*>(w), ok);
      }
    }
  };

  // one k step of 16 rows: the mma's logical k (2t, 2t + 1, 2t + 8, 2t + 9)
  // are rows t, t + 4, t + 8, t + 12; its m (g, g + 8) of tile T are
  // columns 16g + 2T and 16g + 2T + 1; its n are the x rows (slots)
  auto compute = [&](int buf, int kx) {
    const unsigned char* src = stages + buf * kSmallStageBytes;
    uint32_t wd[4][4];                       // [row t + 4i][word]: 16 columns
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ALIGNED) {
        const uint4 v = *reinterpret_cast<const uint4*>(src + roff[i]);
        wd[i][0] = v.x; wd[i][1] = v.y; wd[i][2] = v.z; wd[i][3] = v.w;
      } else {
        const uint32_t* p = reinterpret_cast<const uint32_t*>(src + roff[i]);
        uint32_t v[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) v[j] = p[j];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wd[i][j] = __funnelshift_r(v[j], v[j + 1], rsh[i]);
      }
    }
    // B: x[slot g][rows t, t + 4, t + 8, t + 12]
    uint32_t b[NT][P][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const XT* xr = xs + (nt * 8 + g) * XS + kx + t;
      if constexpr (P == 3) {
        float a[4][3];
#pragma unroll
        for (int i = 0; i < 4; ++i) split3(xr[4 * i], a[i]);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          b[nt][p][0] = pack_exact(a[0][p], a[1][p]);
          b[nt][p][1] = pack_exact(a[2][p], a[3][p]);
        }
      } else {                               // bf16 x: its own bits
        const uint16_t* u = reinterpret_cast<const uint16_t*>(xr);
        b[nt][0][0] = u[0] | (uint32_t)u[4] << 16;
        b[nt][0][1] = u[8] | (uint32_t)u[12] << 16;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float f[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) widen4<KIND>(wd[i][q], f[i]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {          // tile 2q + h: bytes 2h, 2h + 1
        const uint32_t a[4] = {pack_exact(f[0][2 * h], f[1][2 * h]),
                               pack_exact(f[0][2 * h + 1], f[1][2 * h + 1]),
                               pack_exact(f[2][2 * h], f[3][2 * h]),
                               pack_exact(f[2][2 * h + 1], f[3][2 * h + 1])};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int p = 0; p < P; ++p) mma_bf16(acc[nt][2 * q + h], a, b[nt][p]);
      }
    }
  };

  for (int cb = kb; cb < ke; cb += KC) {
    const int n = min(KC, ke - cb);
    const int steps = (n + 15) >> 4;
    const int mine = steps > warp ? (steps - warp + 3) >> 2 : 0;
    __syncthreads();                         // the previous chunk is used
    // x rows [cb, cb + 16 steps) as [slot][k], zeros past the chunk and
    // past M: 16-byte cp.async where x's rows allow it, else loads
    const int rows = 16 * steps;
    constexpr int kv = 16 / sizeof(XT);      // values a 16-byte copy
    if (K % kv == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      for (int i = tid; i < MT * rows / kv; i += kSmallThreads) {
        const int m = i / (rows / kv), kk = (i - m * (rows / kv)) * kv;
        const bool ok = m0 + m < M && kk < n;
        cp_async16(xs + m * XS + kk, ok ? x + (size_t)(m0 + m) * K + cb + kk
                                        : x, ok);
      }
    } else {
      for (int kk = tid; kk < rows; kk += kSmallThreads) {
        XT v[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          v[m] = (m0 + m < M && kk < n) ? x[(size_t)(m0 + m) * K + cb + kk]
                                        : XT(0.f);
#pragma unroll
        for (int m = 0; m < MT; ++m) xs[m * XS + kk] = v[m];
      }
    }
    cp_async_commit();
    // the warp's first weight stages in flight with x
#pragma unroll
    for (int i = 0; i < kSmallStages - 1; ++i) {
      if (i < mine) issue(cb + 16 * (warp + 4 * i), cb + n, i);
      cp_async_commit();
    }
    cp_async_wait<kSmallStages - 1>();       // x has landed
    __syncthreads();
    for (int i = 0; i < mine; ++i) {
      const int nx = i + kSmallStages - 1;
      if (nx < mine)
        issue(cb + 16 * (warp + 4 * nx), cb + n, nx % kSmallStages);
      cp_async_commit();
      cp_async_wait<kSmallStages - 1>();
      __syncwarp();
      compute(i % kSmallStages, 16 * (warp + 4 * i));
      __syncwarp();                          // the buffer may be refilled
    }
  }

  // the warps' partials summed in warp order, then the splits' across the
  // cluster in split order; each block finishes a slice of the tile
  __syncthreads();                           // x is dead
  float* red = reinterpret_cast<float*>(small_smem);  // [warp][MT][cols]
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int T = 0; T < 8; ++T) {
      const int col = 16 * g + 2 * T, s0 = nt * 8 + 2 * t;
      float* r = red + (warp * MT + s0) * kSmallCols + col;
      *reinterpret_cast<float2*>(r) = make_float2(acc[nt][T][0], acc[nt][T][2]);
      *reinterpret_cast<float2*>(r + kSmallCols) =
          make_float2(acc[nt][T][1], acc[nt][T][3]);
    }
  __syncthreads();
  constexpr int tile = MT * kSmallCols;
  for (int e = tid; e < tile; e += kSmallThreads)
    red[e] = ((red[e] + red[tile + e]) + red[2 * tile + e]) + red[3 * tile + e];
  cluster.sync();
  const int per = (tile + splits - 1) / splits;
  const int e1 = min(tile, (int)(blockIdx.y + 1) * per);
  for (int e = blockIdx.y * per + tid; e < e1; e += kSmallThreads) {
    const int m = e / kSmallCols, c = e - m * kSmallCols;
    const int gm = m0 + m, gn = c0 + c;
    float s = 0.f;
    if (splits == 1)
      s = red[e];
    else
      for (int r = 0; r < splits; ++r) s += cluster.map_shared_rank(red, r)[e];
    if (gm < M && gn < N) store(out + (size_t)gm * N + gn, s * scale[gn]);
  }
  cluster.sync();                            // keep red alive for the others
}

template <int KIND, int NT, bool ALIGNED, typename XT>
cudaError_t launch_small_as(const XT* x, const uint8_t* w, const float* scale,
                            XT* out, int M, int N, int K, int device,
                            cudaStream_t stream) {
  constexpr int MT = 8 * NT;
  constexpr int P = sizeof(XT) == 4 ? 3 : 1;
  const int sms = sm_count(device);
  const int m_tiles = (M + MT - 1) / MT;
  const long long tiles =
      (long long)((N + kSmallCols - 1) / kSmallCols) * m_tiles;
  // K split over a cluster of up to 8 while the blocks are fewer than the
  // SMs and every split keeps >= 128 rows (2 k steps a warp)
  int splits = 1;
  while (splits < 8 && tiles * splits < sms && K >= 256 * splits)
    splits *= 2;
  constexpr int smem = small_smem_bytes<MT, XT>();
  static bool opted[64] = {false};
  cudaError_t e =
      opt_in_smem(qmm_small<KIND, NT, P, ALIGNED, XT>, smem, device, opted);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + kSmallCols - 1) / kSmallCols, splits, m_tiles);
  cfg.blockDim = dim3(kSmallThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, qmm_small<KIND, NT, P, ALIGNED, XT>, x, w,
                         scale, out, M, N, K);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int KIND, typename XT>
cudaError_t run_small(const XT* x, const uint8_t* w, const float* scale,
                      XT* out, int M, int N, int K, int device,
                      cudaStream_t stream) {
  // rows 16-byte aligned: each row segment is 8 chunks, read as they land
  const bool aligned =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (M <= 8)
    return aligned ? launch_small_as<KIND, 1, true>(x, w, scale, out, M, N,
                                                    K, device, stream)
                   : launch_small_as<KIND, 1, false>(x, w, scale, out, M, N,
                                                     K, device, stream);
  return aligned ? launch_small_as<KIND, 2, true>(x, w, scale, out, M, N, K,
                                                  device, stream)
                 : launch_small_as<KIND, 2, false>(x, w, scale, out, M, N, K,
                                                   device, stream);
}

template <typename XT>
cudaError_t dispatch(int route, int kind, const void* x, const void* w,
                     const void* scale, void* out, int M, int N, int K,
                     int device, cudaStream_t st) {
  auto xp = static_cast<const XT*>(x);
  auto wb = static_cast<const uint8_t*>(w);
  auto sf = static_cast<const float*>(scale);
  auto op = static_cast<XT*>(out);
  if (route == 0) {
    if (kind == 0) return run_small<0>(xp, wb, sf, op, M, N, K, device, st);
    return run_small<1>(xp, wb, sf, op, M, N, K, device, st);
  }
  if (kind == 0) return run_tc<0>(xp, wb, sf, op, M, N, K, device, st);
  return run_tc<1>(xp, wb, sf, op, M, N, K, device, st);
}

}  // namespace

// x (M,K) f32 (xdtype 0) or bf16 (xdtype 1); w (K,N) int8 (kind 0) or
// fp8-e4m3 bytes (kind 1); scale (N,) f32; out (M,N) in x's dtype; all
// contiguous. route 0: qmm_small (any shape, M tiles of up to 16 past
// (M+15)/16 <= 65535); route 1: qmm_tc (N % 16 == 0, K % 4 (f32) or % 8
// (bf16), x, w and out 16-byte aligned). One launch either way.
extern "C" int mxt_quantized_matmul(const void* x, const void* w,
                                    const void* scale, void* out, int M,
                                    int N, int K, int kind, int xdtype,
                                    int route, int device, void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (kind < 0 || kind > 1 || xdtype < 0 || xdtype > 1 || route < 0 ||
      route > 1)
    return cudaErrorInvalidValue;
  if (route == 0 && ((M + 15) / 16 > 65535 || N >= (1 << 27)))
    return cudaErrorInvalidValue;
  if (route == 1 && (N % 16 || K % (xdtype ? 8 : 4) ||
                     (M + kBM - 1) / kBM > 65535))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (xdtype == 0)
    return dispatch<float>(route, kind, x, w, scale, out, M, N, K, device,
                           st);
  return dispatch<__nv_bfloat16>(route, kind, x, w, scale, out, M, N, K,
                                 device, st);
}
