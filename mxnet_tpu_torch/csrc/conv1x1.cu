// Fused 1x1 convolution with a BN-apply (+residual) (+ReLU) prologue and a
// BN-statistics epilogue, for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/conv_fused.py:_c1x1_kernel (launched by
// conv1x1). Same function, per image n:
//   xf      = x[n] * scale + shift (+ residual[n])  (f32; only with bn_in)
//   xf      = max(xf, 0)                            (relu_in)
//   x'      = xf rounded to x's dtype                (as the TPU kernel does)
//   y[n]    = w @ x'                                 (f32 sums of products
//                                                     exact in the pair's
//                                                     common widening)
//   stored  = y rounded to x's dtype
//   part[n, pt, 0/1, co] = sum / sum of squares of the stored values of
//             P-tile pt, in f32
// Layout: x (N, Ci, P = H*W), w (Co, Ci), y (N, Co, P); x and w are f32,
// bf16 or f16 each, the residual too; y has x's dtype. The caller sums
// the partials over (n, pt), as the JAX function does after its
// pallas_call.
//
// What bounds it on the H100: bytes. ResNet-50's 1x1 shapes at batch 128
// in bf16 do 2*Ci*Co flops per 2*(Ci + Co) bytes of each spatial position,
// 32 to 410 flops per byte, below or near the tensor cores' ~295 line; the
// least time is reading x (and the residual) once and writing y once. An
// FMA loop on the f32 pipes (this kernel until it moved to the tensor
// cores) is ten times slower than that. conv1x1_tc:
//  * output tiles of 128 channels x 128 positions, 8 warps of 64 x 32,
//    mma.sync m16n8k16 with f32 accumulators, fragments by ldmatrix (x's
//    tile read with .trans); a persistent grid (as many blocks as the SMs
//    hold) walks the (N, Co tiles, P tiles) tiles, and each block runs its
//    tiles' Ci chunks of 32 as one stream of steps;
//  * each step's raw x, w (and residual) chunk is staged by 16-byte
//    cp.async in a ring of three or four stages, so later chunks, the next
//    tile's first ones included, load while this one is worked on; a row
//    of x whose positions do not start on 16 bytes (P = 196 or 49 in
//    bf16) is copied as the 16-byte granules that hold it and read at its
//    offset; w of the mma's own type lands in the operand layout directly;
//  * each chunk then goes from the ring into a set of operand tiles,
//    padded so ldmatrix reads them without bank conflicts: the BN-apply
//    (+residual) (+ReLU) prologue in f32 on the way (two roundings, as
//    x * scale + shift in the JAX function, then rounded to x's dtype),
//    and each value as exact pieces of the mma's type. The pair's product
//    must be exact in its common widening, as JAX promotes mixed pairs to
//    f32: the same half type on both sides is one product (bf16, or f16
//    on the f16 tensor cores); an f16 operand against bf16 is two exact
//    bf16 pieces (hi = bf16(v), lo = v - hi: 8 + 3 bits); an f32 operand
//    is three exact bf16 pieces (as qmm_small splits f32 x), so f32 x bf16
//    takes 3 products and f32 x f16 six. Where y is f32 the chunk's
//    products go to fresh accumulators added in f32 after each chunk (the
//    tensor cores' own sums truncate). Two operand sets: a step converts
//    its chunk into one while it multiplies the previous chunk from the
//    other, one barrier a step;
//  * the epilogue rounds y, stores it (a full tile through each warp's
//    staging rows as 16-byte stores where the rows start on 16 bytes and
//    shared memory holds the rows, else element by element), and sums
//    each channel's stored values over the tile's positions (two
//    shuffles, then the four column warps in order through shared memory)
//    into the block's own slot of the partials: one writer per element and
//    no atomics, so the statistics are the same on every run;
//  * two blocks an SM where both sides are one half type (at most 128
//    registers a thread);
//  * ragged P (3136, 784, 196, 49 are no multiples of 128), Co and Ci
//    edges are masked: padding enters no sum and is never stored.
// What the H100 showed (chip_smoke.py, PERF.md): every phase of a step
// (staging, conversion, products, epilogue) costs about the same and none
// dominates; bulk (TMA) copies in place of cp.async changed nothing. The
// next step is wgmma with the operands read from shared memory.
// f32 x with f32 w keeps the FMA kernel of the first port (conv1x1_fma:
// 64 x 64 tiles, 4 x 4 f32 micro-tiles a thread); moving it to the tensor
// cores (3xTF32 with fresh accumulators, as the flash kernels, or nine
// bf16 pieces) is a later step.

#include <algorithm>

#include "mxt_tc.cuh"

namespace {

// ---------------------------------------------------------------------------
// the residual, of any of the three types
// ---------------------------------------------------------------------------
__device__ __forceinline__ float load_res(const void* res, int code,
                                          size_t off) {
  if (code == MXT_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(res)[off]);
  if (code == MXT_F16)
    return __half2float(static_cast<const __half*>(res)[off]);
  return static_cast<const float*>(res)[off];
}

// v rounded to T and back: what a store of T then a load would give
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return mxt_f32(mxt_round<T>(v));
}

// ---------------------------------------------------------------------------
// conv1x1_fma: f32 x, f32 w
// ---------------------------------------------------------------------------
constexpr int kFmaBM = 64;       // output channels per block
constexpr int kFmaBN = 64;       // spatial positions per block
constexpr int kFmaBK = 16;       // input channels per chunk
constexpr int kFmaThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kFmaThreads)
conv1x1_fma(const float* __restrict__ x, const float* __restrict__ w,
            const float* __restrict__ scale, const float* __restrict__ shift,
            const void* __restrict__ res, int res_code, int relu,
            float* __restrict__ y, float* __restrict__ part, int Ci, int Co,
            int P) {
  __shared__ __align__(16) float xs[kFmaBK][kFmaBN];
  __shared__ __align__(16) float ws[kFmaBK][kFmaBM + 4];   // padded

  const int p0 = blockIdx.x * kFmaBN;
  const int c0 = blockIdx.y * kFmaBM;
  const int n = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t xoff = (size_t)n * Ci * P;
  const bool prologue = scale != nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Ci; k0 += kFmaBK) {
    __syncthreads();                         // previous chunk consumed
#pragma unroll
    for (int e = tid; e < kFmaBK * kFmaBN; e += kFmaThreads) {
      const int r = e / kFmaBN, c = e % kFmaBN;   // input channel, position
      const int ci = k0 + r, p = p0 + c;
      float v = 0.f;
      if (ci < Ci && p < P) {
        const size_t off = xoff + (size_t)ci * P + p;
        v = x[off];
        if (prologue) {
          v = __fadd_rn(__fmul_rn(v, scale[ci]), shift[ci]);
          if (res != nullptr) v += load_res(res, res_code, off);
          if (relu) v = fmaxf(v, 0.f);
        }
      }
      xs[r][c] = v;
    }
#pragma unroll
    for (int e = tid; e < kFmaBK * kFmaBM; e += kFmaThreads) {
      const int r = e / kFmaBK, c = e % kFmaBK;   // output, input channel
      const int co = c0 + r, ci = k0 + c;
      ws[c][r] = (co < Co && ci < Ci) ? w[(size_t)co * Ci + ci] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmaBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&ws[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  const unsigned half = 0xffffu << (threadIdx.x & 16);   // this ty's lanes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = c0 + ty * 4 + i;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx * 4 + j;
      const float yc = acc[i][j];
      if (co < Co && p < P) {
        y[((size_t)n * Co + co) * P + p] = yc;
        s1 += yc;
        s2 = fmaf(yc, yc, s2);
      }
    }
    if (part != nullptr) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(half, s1, off);
        s2 += __shfl_xor_sync(half, s2, off);
      }
      if (tx == 0 && co < Co) {
        float* slot = part + ((size_t)n * gridDim.x + blockIdx.x) * 2 * Co;
        slot[co] = s1;
        slot[Co + co] = s2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// conv1x1_tc: the tensor cores, exact pieces
// ---------------------------------------------------------------------------
constexpr int kBM = 128;         // output channels per block
constexpr int kBN = 128;         // spatial positions per block
constexpr int kBK = 32;          // input channels per chunk
constexpr int kThreads = 256;    // 8 warps of 64 x 32
constexpr int kAStride = kBK + 8;    // mma-type elements a w-piece row
constexpr int kBStride = kBN + 8;    // mma-type elements an x-piece row

// the mma's type: f16 when both sides are f16, else bf16
template <typename TX, typename TW>
using MmaT = typename std::conditional<
    std::is_same<TX, __half>::value && std::is_same<TW, __half>::value,
    __half, __nv_bfloat16>::type;

// exact pieces of a T value in the mma's type M
template <typename T, typename M>
constexpr int pieces() {
  return sizeof(T) == 4 ? 3 : std::is_same<T, M>::value ? 1 : 2;
}

// v as NP values of M that sum to it exactly (rounded to nearest in turn)
template <typename M, int NP>
__device__ __forceinline__ void split_n(float v, float* p) {
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    p[i] = round_to<M>(v);
    v -= p[i];
  }
}

// the bits of an element of T: loads and copies move these
template <typename T>
using RawT = typename std::conditional<sizeof(T) == 4, float,
                                       unsigned short>::type;

// a staged row of x or the residual: kBN elements of esz bytes and the
// 16 bytes that align its first granule
__host__ __device__ constexpr int raw_row(int esz) { return kBN * esz + 16; }

constexpr int kMaxStages = 4;

template <typename TX, typename TW>
struct TcSmem {
  using M = MmaT<TX, TW>;
  static constexpr int PX = pieces<TX, M>();
  static constexpr int PW = pieces<TW, M>();
  // w of the mma's own type is its own single piece: it is staged straight
  // into the operand layout, one tile a stage; other w are staged raw and
  // split into one set of piece tiles
  static constexpr bool kWDirect = std::is_same<TW, M>::value;
  static constexpr int kWStage =
      kWDirect ? kBM * kAStride * 2 : kBM * kBK * (int)sizeof(TW);
  static constexpr int kXStage = kBK * raw_row(sizeof(TX));
  // piece tiles, two sets: one being written while the other is multiplied
  static constexpr int kPieceW = kWDirect ? 0 : PW * kBM * kAStride * 2;
  static constexpr int kPieceX = PX * kBK * kBStride * 2;
  static constexpr int kRed = 2 * 4 * kBM * 4;   // the statistics' sums
  // each warp's staging rows for y: 32 rows of its 32 columns, padded
  static constexpr int kYRow = 32 + 16 / (int)sizeof(TX);
  static constexpr int kStageY = 8 * 32 * kYRow * (int)sizeof(TX);
  // a ring stage: w, x, and the residual's rows (res_esz bytes an element)
  __host__ __device__ static constexpr int stage(int res_esz) {
    return kWStage + kXStage + (res_esz ? kBK * raw_row(res_esz) : 0);
  }
  static constexpr int bytes(int res_esz, int stages, bool stage_y) {
    return stages * stage(res_esz) + 2 * (kPieceW + kPieceX) + kRed +
           (stage_y ? kStageY : 0);
  }
  // blocks an SM: two where both sides are one half type (at most 128
  // registers a thread), else one
  static constexpr int kBlocks = sizeof(TX) == 2 && PX * PW == 1 ? 2 : 1;
};

// kR x kC elements of E at (r0, c0) of a row-major matrix (row stride ld
// elements; rows < nr and columns < nc valid, the rest zero) into a
// [kR][dld] tile: 16-byte cp.async when every row starts on 16 bytes and
// nc is a multiple of 16 / sizeof(E) (vec), else element loads
template <typename E, int kR, int kC>
__device__ __forceinline__ void load_tile(E* dst, int dld, const E* src,
                                          size_t ld, int r0, int c0, int nr,
                                          int nc, bool vec) {
  constexpr int kV = 16 / (int)sizeof(E);
  if (vec) {
#pragma unroll
    for (int i = threadIdx.x; i < kR * kC / kV; i += kThreads) {
      const int r = i / (kC / kV), c = (i % (kC / kV)) * kV;
      const bool ok = r0 + r < nr && c0 + c < nc;
      cp_async16(dst + r * dld + c,
                 ok ? src + (size_t)(r0 + r) * ld + c0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kR * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      dst[r * dld + c] = r0 + r < nr && c0 + c < nc
                             ? src[(size_t)(r0 + r) * ld + c0 + c] : E(0);
    }
  }
}

// rows [k0, k0 + kBK) (those below Ci) of a (Ci, P) matrix of ESZ-byte
// elements at base, positions [p0, min(p0 + kBN, P)), each row as the
// 16-byte granules that hold it, into staged rows of raw_row(ESZ) bytes:
// every copy is a full 16-byte cp.async whatever P is (196 and 49 leave
// rows on 8 and 2 bytes). A granule that holds a byte of the tensor lies
// in the tensor's pages, so the bytes around a row are safe to read; the
// row's first element sits at its address's offset within 16 bytes.
template <int ESZ>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const unsigned char* base, int k0,
                                          int Ci, int P, int p0) {
  constexpr int kG = kBN * ESZ / 16 + 1;     // granules a row, at most
  const int pe = min(p0 + kBN, P);
  for (int i = threadIdx.x; i < kBK * kG; i += kThreads) {
    const int r = i / kG, j = i - r * kG;
    if (k0 + r >= Ci) continue;
    const uintptr_t row = reinterpret_cast<uintptr_t>(base) +
                          (size_t)(k0 + r) * P * ESZ;
    const uintptr_t g = ((row + (size_t)p0 * ESZ) & ~uintptr_t(15)) + 16 * j;
    if (g < row + (size_t)pe * ESZ)
      cp_async16(dst + r * raw_row(ESZ) + 16 * j,
                 reinterpret_cast<const void*>(g), true);
  }
}

// 8 consecutive staged elements of T as floats: 16-byte reads where they
// start on 16 bytes, else one element a read
template <typename T>
__device__ __forceinline__ void load8(const unsigned char* p, float* v) {
  if (reinterpret_cast<uintptr_t>(p) % 16 == 0) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 4) {
      const uint4 u2 = *reinterpret_cast<const uint4*>(p + 16);
      const uint32_t w[8] = {u.x, u.y, u.z, u.w, u2.x, u2.y, u2.z, u2.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __uint_as_float(w[j]);
    } else {
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (std::is_same<T, __nv_bfloat16>::value) {
          v[2 * j] = __uint_as_float(w[j] << 16);
          v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        } else {
          v[2 * j] = mxt_h2f(w[j]);
          v[2 * j + 1] = mxt_h2f(w[j] >> 16);
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = mxt_f32(reinterpret_cast<const T*>(p)[j]);
  }
}

// 8 values, as NP pieces of M each, into rows of NP piece tiles (piece
// tiles `stride` elements apart)
// (one piece: packing rounds to nearest, so v may be any f32 value)
template <typename M, int NP>
__device__ __forceinline__ void put8(const float* v, M* dst, int stride) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint32_t u[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (NP == 1) {
        u[j] = mxt_tc::pack2<M>(v[2 * j], v[2 * j + 1]);
      } else {
        float lo[NP], hi[NP];
        split_n<M, NP>(v[2 * j], lo);
        split_n<M, NP>(v[2 * j + 1], hi);
        u[j] = mxt_tc::pack2<M>(lo[p], hi[p]);
      }
    }
    *reinterpret_cast<uint4*>(dst + p * stride) =
        make_uint4(u[0], u[1], u[2], u[3]);
  }
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A persistent grid: block b takes output tiles b, b + gridDim.x, ... of
// (N x Co tiles x P tiles), P tiles fastest, and runs their Ci chunks as one
// stream of steps through a ring of `stages` (3 or 4) stages, so the next
// tile's first chunks are in flight while this tile's epilogue runs. vec:
// bit 1, w's rows start on 16 bytes; bit 8, y's full tiles leave through
// the staging rows (their rows start on 16 bytes, and smem holds them).
// With w of the mma's type the products read w from its ring stage.
template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads, TcSmem<TX, TW>::kBlocks)
conv1x1_tc(const TX* __restrict__ x, const TW* __restrict__ w,
           const float* __restrict__ scale, const float* __restrict__ shift,
           const void* __restrict__ res, int res_code, int res_esz,
           int relu, int vec, int stages, TX* __restrict__ y,
           float* __restrict__ part, int N, int Ci, int Co, int P) {
  using L = TcSmem<TX, TW>;
  using M = typename L::M;
  constexpr int PX = L::PX, PW = L::PW;
  constexpr int XE = (int)sizeof(TX);
  constexpr bool kFresh = XE == 4;           // y in f32
  extern __shared__ __align__(16) unsigned char conv_smem[];
  const int stage = L::stage(res_esz);
  unsigned char* after = conv_smem + stages * stage;
  // piece tiles of set i: w at after + i * (kPieceW + kPieceX) ([PW][kBM]
  // [kAStride]), then x ([PX][kBK][kBStride])
  float* red =
      reinterpret_cast<float*>(after + 2 * (L::kPieceW + L::kPieceX));
  TX* ystage = reinterpret_cast<TX*>(red + 2 * 4 * kBM) +
               (threadIdx.x >> 5) * 32 * L::kYRow;      // this warp's rows

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const int g = lane >> 2, t = lane & 3;
  const bool prologue = scale != nullptr;
  const bool with_res = prologue && res != nullptr;
  const int tiles_p = (P + kBN - 1) / kBN, tiles_c = (Co + kBM - 1) / kBM;
  const int tiles = N * tiles_c * tiles_p;
  const int nk = (Ci + kBK - 1) / kBK;
  const int mine = blockIdx.x < tiles
                       ? (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x : 0;
  const int steps = mine * nk;
  // tile i of this block: its image, first channel and first position
  auto where = [&](int i, int& n, int& c0, int& p0) {
    const int tile = blockIdx.x + i * gridDim.x;
    p0 = (tile % tiles_p) * kBN;
    c0 = (tile / tiles_p % tiles_c) * kBM;
    n = tile / (tiles_p * tiles_c);
  };
  // step `step` into ring stage step % stages; a group either way. Steps
  // are fetched in order: the cursor (fi, fkc) finds a tile once
  int fi = 0, fkc = 0, fn = 0, fc0 = 0, fp0 = 0, fst = 0;
  auto fetch = [&](int step) {
    if (step < steps) {
      if (fkc == 0) where(fi, fn, fc0, fp0);
      const int n = fn, c0 = fc0, p0 = fp0, k0 = fkc * kBK;
      if (++fkc == nk) {
        fkc = 0;
        ++fi;
      }
      unsigned char* st = conv_smem + fst * stage;
      fst = fst + 1 == stages ? 0 : fst + 1;
      const size_t xoff = (size_t)n * Ci * P;
      load_tile<RawT<TW>, kBM, kBK>(reinterpret_cast<RawT<TW>*>(st),
                                    L::kWDirect ? kAStride : kBK,
                                    reinterpret_cast<const RawT<TW>*>(w), Ci,
                                    c0, k0, Co, Ci, vec & 1);
      load_rows<XE>(st + L::kWStage,
                    reinterpret_cast<const unsigned char*>(x + xoff), k0, Ci,
                    P, p0);
      if (with_res) {
        const unsigned char* rb =
            static_cast<const unsigned char*>(res) + xoff * res_esz;
        if (res_esz == 4)
          load_rows<4>(st + L::kWStage + L::kXStage, rb, k0, Ci, P, p0);
        else
          load_rows<2>(st + L::kWStage + L::kXStage, rb, k0, Ci, P, p0);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4], fresh[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = fresh[i][j][e] = 0.f;

  // the chunk's products (PW x PX a pair of fragments) into dst
  auto products = [&](const M* pw, const M* px, float (&dst)[4][4][4]) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t b[PX][4][2];
#pragma unroll
      for (int q = 0; q < PX; ++q)
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          uint32_t f[4];
          mxt_tc::ldsm_x4_t(px + q * kBK * kBStride +
                                (kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                    kBStride +
                                wn + nb * 16 + (lane >> 4) * 8,
                            f);
          b[q][2 * nb][0] = f[0]; b[q][2 * nb][1] = f[1];
          b[q][2 * nb + 1][0] = f[2]; b[q][2 * nb + 1][1] = f[3];
        }
#pragma unroll
      for (int q = 0; q < PW; ++q)
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          uint32_t a[4];
          mxt_tc::ldsm_x4(pw + q * kBM * kAStride +
                              (wm + mi * 16 + (lane & 7) +
                               ((lane >> 3) & 1) * 8) * kAStride +
                              kk + (lane >> 4) * 8,
                          a);
#pragma unroll
          for (int r = 0; r < PX; ++r)
#pragma unroll
            for (int ni = 0; ni < 4; ++ni)
              mxt_tc::mma16<M>(dst[mi][ni], a, b[r][ni]);
        }
    }
  };

  // step s's chunk from its ring stage into piece set s & 1; steps come
  // in order (cursor ti, tkc)
  int ti = 0, tkc = 0, tn = 0, tc0 = 0, tp0 = 0, tst = 0;
  auto transform = [&](int step) {
    if (tkc == 0) where(ti, tn, tc0, tp0);
    const int n = tn, p0 = tp0, k0 = tkc * kBK;
    if (++tkc == nk) {
      tkc = 0;
      ++ti;
    }
    const unsigned char* st = conv_smem + tst * stage;
    tst = tst + 1 == stages ? 0 : tst + 1;
    unsigned char* set = after + (step & 1) * (L::kPieceW + L::kPieceX);
    M* px = reinterpret_cast<M*>(set + L::kPieceW);
    if constexpr (!L::kWDirect) {
      // w: 8 values of row r a thread, twice, as PW pieces
      M* pw = reinterpret_cast<M*>(set);
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        const int r = tid >> 1, cb = (tid & 1) * 8 + 16 * h;
        float v[8];
        load8<TW>(st + (r * kBK + cb) * (int)sizeof(TW), v);
        put8<M, PW>(v, pw + r * kAStride + cb, kBM * kAStride);
      }
    }
    // x: 8 positions of input channel r a thread, twice, the prologue
    // applied, rounded to x's dtype, as PX pieces (x of the mma's type:
    // the packing is the rounding); masks only on a ragged chunk
    constexpr bool kPackRounds = PX == 1;
    const bool full = p0 + kBN <= P && k0 + kBK <= Ci;
    const int r = tid >> 3;
    const int ci = k0 + r;
    const size_t at = (size_t)n * Ci * P + (size_t)ci * P + p0;
    const unsigned char* sx = st + L::kWStage + r * raw_row(XE) +
                              ((reinterpret_cast<uintptr_t>(x) + at * XE) &
                               15);
    const unsigned char* sr = nullptr;
    float sc = 0.f, sh = 0.f;
    if (prologue && ci < Ci) {
      sc = scale[ci];
      sh = shift[ci];
      if (with_res)
        sr = st + L::kWStage + L::kXStage + r * raw_row(res_esz) +
             ((reinterpret_cast<uintptr_t>(res) + at * res_esz) & 15);
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int cb = (tid & 7) * 8 + 64 * h;
      float v[8], rv[8];
      load8<TX>(sx + cb * XE, v);
      if (sr != nullptr) {
        if (res_code == MXT_F32)
          load8<float>(sr + cb * 4, rv);
        else if (res_code == MXT_BF16)
          load8<__nv_bfloat16>(sr + cb * 2, rv);
        else
          load8<__half>(sr + cb * 2, rv);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float u = v[j];
        if (prologue) {
          u = __fadd_rn(__fmul_rn(u, sc), sh);
          if (sr != nullptr) u += rv[j];
          if (relu) u = fmaxf(u, 0.f);
          if constexpr (!kPackRounds) u = round_to<TX>(u);
        }
        v[j] = full || (ci < Ci && p0 + cb + j < P) ? u : 0.f;
      }
      put8<M, PX>(v, px + r * kBStride + cb, kBK * kBStride);
    }
  };

  // the block's next tile (its last chunk multiplied): round, store, and
  // sum each row's stored values; c0, c1 at (row g, cols 2t, 2t + 1), c2,
  // c3 at row g + 8. A full tile whose rows start on 16 bytes goes out
  // through the warp's staging rows, 32 rows at a time, as 16-byte stores
  // (64 contiguous bytes a row, where the fragments alone give 16); any
  // other tile by element. The four column warps' sums meet in shared
  // memory.
  int ei = 0;
  auto epilogue = [&]() {
    int n, c0, p0;
    where(ei++, n, c0, p0);
    const bool full = c0 + kBM <= Co && p0 + kBN <= P;
    const bool staged_y = full && (vec & 8);
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int m2 = 0; m2 < 2; ++m2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int mi = 2 * pass + m2;
          const int rr = m2 * 16 + g + 8 * h;            // staging row
          const int row = wm + mi * 16 + g + 8 * h, co = c0 + row;
          TX* yrow = y + ((size_t)n * Co + co) * P + p0 + wn + 2 * t;
          float s1 = 0.f, s2 = 0.f;
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            // the pair rounded once to y's type (the stored values)
            float a = acc[mi][ni][2 * h], bb = acc[mi][ni][2 * h + 1];
            uint32_t word = 0;
            if constexpr (XE == 2) {
              word = mxt_tc::pack2<TX>(a, bb);
              if constexpr (std::is_same<TX, __nv_bfloat16>::value) {
                a = __uint_as_float(word << 16);
                bb = __uint_as_float(word & 0xffff0000u);
              } else {
                a = mxt_h2f(word);
                bb = mxt_h2f(word >> 16);
              }
            }
            if (staged_y) {
              TX* d = ystage + rr * L::kYRow + ni * 8 + 2 * t;
              if constexpr (XE == 2)
                *reinterpret_cast<uint32_t*>(d) = word;
              else
                mxt_tc::store2(d, a, bb);
              s1 += a + bb;
              s2 = fmaf(a, a, fmaf(bb, bb, s2));
            } else {
              const int p = p0 + wn + ni * 8 + 2 * t;
              if (co < Co && p < P) {
                yrow[ni * 8] = mxt_round<TX>(a);
                s1 += a;
                s2 = fmaf(a, a, s2);
                if (p + 1 < P) {
                  yrow[ni * 8 + 1] = mxt_round<TX>(bb);
                  s1 += bb;
                  s2 = fmaf(bb, bb, s2);
                }
              }
            }
          }
          s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
          s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
          s2 += __shfl_xor_sync(0xffffffffu, s2, 2);
          if (t == 0) {
            red[(warp & 3) * kBM + row] = s1;
            red[(4 + (warp & 3)) * kBM + row] = s2;
          }
        }
      if (staged_y) {
        // the warp's 32 rows x 32 columns out, 16 bytes a lane a store
        constexpr int kCh = 32 * XE / 16;          // 16-byte chunks a row
        __syncwarp();
#pragma unroll
        for (int c = lane; c < 32 * kCh; c += 32) {
          const int r = c / kCh, cc = c % kCh * (16 / XE);
          *reinterpret_cast<uint4*>(
              y + ((size_t)n * Co + c0 + wm + 32 * pass + r) * P + p0 + wn +
              cc) = *reinterpret_cast<const uint4*>(ystage + r * L::kYRow +
                                                    cc);
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    if (part == nullptr) return;             // uniform: no barrier skipped
    __syncthreads();
    if (tid < kBM && c0 + tid < Co) {
      const int co = c0 + tid;
      float* slot = part + ((size_t)n * tiles_p + p0 / kBN) * 2 * Co;
      slot[co] = ((red[tid] + red[kBM + tid]) + red[2 * kBM + tid]) +
                 red[3 * kBM + tid];
      slot[Co + co] = ((red[4 * kBM + tid] + red[5 * kBM + tid]) +
                       red[6 * kBM + tid]) + red[7 * kBM + tid];
    }
  };

  // Software-pipelined over steps: iteration s waits for step s's data,
  // then (after one barrier) refills the ring stage of step s - 2, turns
  // step s into piece set s & 1, and multiplies step s - 1 from the other
  // set (w of the mma's type from step s - 1's ring stage), so each warp's
  // conversions and its products of the previous chunk run in one phase.
  // The barrier orders the rest: step s - 2's stage and step s - 1's
  // pieces and epilogue are done with before the next iteration reuses
  // their buffers. stages >= 3: stages - 2 steps are in flight.
  for (int i = 0; i + 2 < stages; ++i) fetch(i);
  int mkc = 0;                     // chunk of the tile being multiplied
  const unsigned char* prev_st = conv_smem;   // ring stage of step - 1
  for (int step = 0; step <= steps; ++step) {
    if (step < steps) {
      if (stages == 4)
        wait_groups<1>();
      else
        wait_groups<0>();
    }
    __syncthreads();
    fetch(step + stages - 2);      // the stage of step - 2: consumed
    const unsigned char* cur_st = conv_smem + tst * stage;
    if (step < steps) transform(step);
    if (step > 0) {
      const unsigned char* set =
          after + ((step - 1) & 1) * (L::kPieceW + L::kPieceX);
      const M* pw = reinterpret_cast<const M*>(L::kWDirect ? prev_st : set);
      const M* px = reinterpret_cast<const M*>(set + L::kPieceW);
      if constexpr (kFresh) {
        products(pw, px, fresh);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[i][j][e] += fresh[i][j][e];
              fresh[i][j][e] = 0.f;
            }
      } else {
        products(pw, px, acc);
      }
      if (++mkc == nk) {
        mkc = 0;
        epilogue();
      }
    }
    prev_st = cur_st;
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
struct Args {
  const void *x, *w;
  const float *scale, *shift;
  const void* res;
  int res_code, relu;
  void* y;
  float* part;
  int N, Ci, Co, P, device;
  cudaStream_t stream;
};

inline int esz_of(int code) { return code == MXT_F32 ? 4 : 2; }

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename TX, typename TW>
cudaError_t launch_tc(const Args& a) {
  using L = TcSmem<TX, TW>;
  constexpr int kSmMem = 233472, kBlockMax = 232448, kReserve = 1024;
  const int res_esz = a.res ? esz_of(a.res_code) : 0;
  // y's rows start on 16 bytes: full tiles may leave through the warps'
  // staging rows; then the deepest ring (4 or 3 stages), with the staging
  // rows where they fit, that keeps L::kBlocks blocks on an SM, else 3
  // stages and one block (every pair fits it)
  const bool rows16 = (a.P * (int)sizeof(TX)) % 16 == 0 && aligned16(a.y);
  int stages = 3;
  bool stage_y = false;
  const struct { int s; bool sy; } order[4] = {
      {4, true}, {3, true}, {4, false}, {3, false}};
  for (const auto& o : order) {
    const int b = L::bytes(res_esz, o.s, o.sy);
    if ((o.sy && !rows16) || b > kBlockMax ||
        L::kBlocks * (b + kReserve) > kSmMem)
      continue;
    stages = o.s;
    stage_y = o.sy;
    break;
  }
  const int smem = L::bytes(res_esz, stages, stage_y);
  // per device: opted in, SMs, and blocks an SM for each residual size
  // (0, 2, 4 bytes) with and without the staging rows
  static int opted[64] = {0}, sms[64] = {0}, per_sm[64][10] = {};
  const int shape = res_esz + (stage_y ? 5 : 0);
  const int dev = a.device >= 0 && a.device < 64 ? a.device : 0;
  if (!opted[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        conv1x1_tc<TX, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kBlockMax);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                               a.device);
    if (e != cudaSuccess) return e;
    opted[dev] = 1;
  }
  if (!per_sm[dev][shape]) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm[dev][shape], conv1x1_tc<TX, TW>, kThreads, smem);
    if (e != cudaSuccess) return e;
  }
  // 16-byte copies of w's rows (Ci); y through the staging rows
  const int vec =
      ((a.Ci * (int)sizeof(TW)) % 16 == 0 && aligned16(a.w) ? 1 : 0) |
      (stage_y ? 8 : 0);
  const long long tiles = (long long)a.N * ((a.Co + kBM - 1) / kBM) *
                          ((a.P + kBN - 1) / kBN);
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  const int blocks = (int)std::min<long long>(
      tiles, (long long)sms[dev] * std::max(per_sm[dev][shape], 1));
  conv1x1_tc<TX, TW><<<blocks, kThreads, smem, a.stream>>>(
      static_cast<const TX*>(a.x), static_cast<const TW*>(a.w), a.scale,
      a.shift, a.res, a.res_code, res_esz, a.relu, vec, stages,
      static_cast<TX*>(a.y), a.part, a.N, a.Ci, a.Co, a.P);
  mxt_counted();
  return cudaGetLastError();
}

cudaError_t launch_fma(const Args& a) {
  dim3 grid((a.P + kFmaBN - 1) / kFmaBN, (a.Co + kFmaBM - 1) / kFmaBM, a.N);
  conv1x1_fma<<<grid, kFmaThreads, 0, a.stream>>>(
      static_cast<const float*>(a.x), static_cast<const float*>(a.w),
      a.scale, a.shift, a.res, a.res_code, a.relu,
      static_cast<float*>(a.y), a.part, a.Ci, a.Co, a.P);
  mxt_counted();
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_x(const Args& a, int w_code) {
  switch (w_code) {
    case MXT_F32:
      if constexpr (std::is_same<TX, float>::value)
        return cudaErrorInvalidValue;        // conv1x1_fma's pair
      else
        return launch_tc<TX, float>(a);
    case MXT_BF16: return launch_tc<TX, __nv_bfloat16>(a);
    case MXT_F16: return launch_tc<TX, __half>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The positions a block covers, which sets the partials' second axis: Pt =
// ceil(P / tile); f32 x with f32 w takes the FMA kernel's 64, every other
// pair the tensor-core kernel's 128.
extern "C" int mxt_conv1x1_tile(int x_code, int w_code) {
  return x_code == MXT_F32 && w_code == MXT_F32 ? kFmaBN : kBN;
}

// x (N,Ci,P), w (Co,Ci), res (N,Ci,P) or NULL: each MXT_F32, MXT_BF16 or
// MXT_F16 (x_code, w_code, res_code); scale/shift (Ci,) f32 or both NULL
// (no prologue); y (N,Co,P) of x's dtype; part (N, Pt, 2, Co) f32 or NULL:
// all contiguous. Pt must be ceil(P / mxt_conv1x1_tile(x_code, w_code)).
extern "C" int mxt_conv1x1(const void* x, const void* w, const void* scale,
                           const void* shift, const void* res, void* y,
                           void* part, int N, int Ci, int Co, int P, int Pt,
                           int x_code, int w_code, int res_code, int relu,
                           int device, void* stream) {
  const int tile = mxt_conv1x1_tile(x_code, w_code);
  if (Pt != (P + tile - 1) / tile) return cudaErrorInvalidValue;
  if (x_code < 0 || x_code > 2 || w_code < 0 || w_code > 2 ||
      (res && (res_code < 0 || res_code > 2)))
    return cudaErrorInvalidValue;
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return e;
  if (N <= 0 || Co <= 0 || P <= 0) return cudaSuccess;
  if (N > 65535 || (Co + kFmaBM - 1) / kFmaBM > 65535)
    return cudaErrorInvalidValue;      // the FMA kernel's grid
  const Args a{x, w, static_cast<const float*>(scale),
               static_cast<const float*>(shift), res, res_code, relu, y,
               static_cast<float*>(part), N, Ci, Co, P, device,
               static_cast<cudaStream_t>(stream)};
  switch (x_code) {
    case MXT_F32:
      return w_code == MXT_F32 ? launch_fma(a) : launch_x<float>(a, w_code);
    case MXT_BF16: return launch_x<__nv_bfloat16>(a, w_code);
    default: return launch_x<__half>(a, w_code);
  }
}
