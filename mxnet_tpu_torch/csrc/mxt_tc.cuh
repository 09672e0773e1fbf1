// Warp-level tensor-core products of the flash forward and dQ kernels
// (flash_attention.cu, flash_attention_bwd.cu), on mma.sync.
//
// A warp owns MT tiles of 16 rows (m-tiles). Its f32 accumulators are mma
// C fragments, per m-tile: lane
// (g = lane / 4, t = lane % 4) holds, of every 8-column tile n, the
// elements (g, 8n + 2t), (g, 8n + 2t + 1), (g + 8, 8n + 2t), (g + 8, 8n +
// 2t + 1), as acc[n][0..3]. Operands come from row-major tiles in shared
// memory, rows padded (kPad) so that the 8 rows a load touches fall in
// different banks.
//
// bfloat16 / float16 operands: one mma.sync.m16n8k16 a product, f32
// accumulators; fragments by ldmatrix (.trans where the reduction runs
// along the tile's rows).
// float32 operands: 3xTF32. Each operand x is split into big = tf32(x)
// and small = tf32(x - big) (round to nearest), and a product is
// small*big + big*small + big*big on mma.sync.m16n8k8.tf32 with f32
// accumulators: x - big - small is within 2^-22 |x|, and the dropped
// small*small term within 2^-22 of |x||y|, so the products carry about
// the precision of f32 ones, on tensor cores that run 495 TFLOP/s
// against the FP32 pipes' 67. The tensor cores' own additions truncate
// (round toward zero), and over a long chain that bias outgrew the f32
// error budget (5x the plain f32 version's float64 error at S = 200 on
// the H100): so the f32 path starts a fresh accumulator every kFresh
// k-steps (32 terms) and adds it to the running sum with an f32 add,
// which rounds to nearest.
#pragma once

#include "mxt_common.cuh"

namespace mxt_tc {

constexpr int kFresh = 4;   // f32 path: k-steps of 8 a fresh accumulator

template <typename T>
struct Tile {
  static constexpr bool kHalf = !std::is_same<T, float>::value;
  static constexpr int kPad = kHalf ? 8 : 4;   // elements a padded row
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

template <typename T>
__device__ __forceinline__ void mma16(float* c, const uint32_t* a,
                                      const uint32_t* b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = big + small + (a rest within 2^-22 |x|), both TF32 values
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small)
      : "f"(x - __uint_as_float(big)));
}

// acc[n] += A . B[n] for N independent 8-column tiles in three TF32
// passes (small*big, big*small, big*big), each pass over all N tiles, so
// that consecutive mmas never wait on one another's accumulator
template <int N>
__device__ __forceinline__ void mma3(float (*acc)[4], const uint32_t* ab,
                                     const uint32_t* as,
                                     const uint32_t (*bb)[2],
                                     const uint32_t (*bs)[2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], as, bb[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ab, bs[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(acc[n], ab, bb[n]);
}

// 2^x: exp2f for f32 (within 2 ulps); for half types the MUFU instruction
// alone (flushes denormal results to 0), since P is rounded to 8 or 11
// bits before its product anyway
template <typename T>
__device__ __forceinline__ float exp2_(float x) {
  if constexpr (Tile<T>::kHalf) {
    float r;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(x));
    return r;
  } else {
    return exp2f(x);
  }
}

// two f32 values rounded to one bf16x2 / f16x2 word (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  else
    asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// acc[i] (16 x 8 NT) += A_i (16 x D) . B (8 NT x D)^T for the warp's MT
// m-tiles: A_i's rows at a + 16 i ld (a: the warp's first row), B's at b,
// row stride ld elements. Each B fragment is loaded (and split) once for
// all MT m-tiles. S = Q K^T and dP = dO V^T.
template <typename T, int D, int NT, int MT>
__device__ __forceinline__ void rows_by_rows(const T* a, const T* b, int ld,
                                             float (*acc)[NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (Tile<T>::kHalf) {
    static_assert(NT % 2 == 0, "pairs of 8-column tiles");
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldsm_x4(a + (16 * i + (lane & 15)) * ld + kk + (lane >> 4) * 8,
                af[i]);
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t bf[4];
        ldsm_x4(b + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk
                    + ((lane >> 3) & 1) * 8, bf);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16<T>(acc[i][n], af[i], bf);
          mma16<T>(acc[i][n + 1], af[i], bf + 2);
        }
      }
    }
  } else {
    constexpr int KC = D / 8 < kFresh ? D / 8 : kFresh;   // k-steps a chunk
    // chunks one at a time up to D = 64 (unrolled, ptxas spilled at
    // MT = 2), two at a time above, so that one chunk's loads overlap the
    // other's mmas (H100 build and timings)
    auto chunk = [&](int k0) {
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
          part[i][n][0] = part[i][n][1] = part[i][n][2] = part[i][n][3] = 0.f;
#pragma unroll
      for (int kk = k0; kk < k0 + 8 * KC; kk += 8) {
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const T* ai = a + 16 * i * ld;
          split(ai[g * ld + kk + t], ab[i][0], as[i][0]);
          split(ai[(g + 8) * ld + kk + t], ab[i][1], as[i][1]);
          split(ai[g * ld + kk + t + 4], ab[i][2], as[i][2]);
          split(ai[(g + 8) * ld + kk + t + 4], ab[i][3], as[i][3]);
        }
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split(b[(n * 8 + g) * ld + kk + t], bb[n][0], bs[n][0]);
          split(b[(n * 8 + g) * ld + kk + t + 4], bb[n][1], bs[n][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) mma3<NT>(part[i], ab[i], as[i], bb, bs);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] += part[i][n][e];
    };
    if constexpr (D <= 64) {
#pragma unroll 1
      for (int k0 = 0; k0 < D; k0 += 8 * KC) chunk(k0);
    } else {
#pragma unroll 2
      for (int k0 = 0; k0 < D; k0 += 8 * KC) chunk(k0);
    }
  }
}

// acc[i] (16 x D) += P_i (16 x 8 NT, C fragments) . B (8 NT x D) for the
// warp's MT m-tiles: B's rows at b, row stride ld. O += P V and
// dQ += dS K. Half types round P to T (the TPU kernel's
// p.astype(v.dtype)); f32 splits it. The f32 path takes the mma's
// reduction index t as key 2t and t + 4 as key 2t + 1, which makes a C
// fragment an A fragment as it stands; B is read in the same order.
template <typename T, int D, int NT, int MT>
__device__ __forceinline__ void cols_by_rows(const float (*p)[NT][4],
                                             const T* b, int ld,
                                             float (*acc)[D / 8][4],
                                             int lane) {
  const int g = lane >> 2, t = lane & 3;
  if constexpr (Tile<T>::kHalf) {
    static_assert(NT % 2 == 0 && D % 16 == 0, "pairs of 8-column tiles");
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        af[i][0] = pack2<T>(p[i][j][0], p[i][j][1]);
        af[i][1] = pack2<T>(p[i][j][2], p[i][j][3]);
        af[i][2] = pack2<T>(p[i][j + 1][0], p[i][j + 1][1]);
        af[i][3] = pack2<T>(p[i][j + 1][2], p[i][j + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bf[4];
        ldsm_x4_t(b + (j * 8 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld
                      + n * 8 + (lane >> 4) * 8, bf);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma16<T>(acc[i][n], af[i], bf);
          mma16<T>(acc[i][n + 1], af[i], bf + 2);
        }
      }
    }
  } else {
    // groups of NG 8-column tiles, each over the keys in fresh chunks of
    // kFresh 8-key steps (P is split again for each group); 2 tiles at
    // D = 256, where 8 and 4 spilled beside the 128 accumulator registers
    constexpr int NG = D / 8 < 8 ? D / 8 : D >= 256 ? 2 : 8;
    constexpr int JC = NT < kFresh ? NT : kFresh;          // k-steps a chunk
#pragma unroll
    for (int n0 = 0; n0 < D / 8; n0 += NG) {
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += JC) {
        float part[MT][NG][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NG; ++n)
            part[i][n][0] = part[i][n][1] = part[i][n][2] = part[i][n][3] =
                0.f;
#pragma unroll
        for (int j = j0; j < j0 + JC; ++j) {
          uint32_t ab[MT][4], as[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            split(p[i][j][0], ab[i][0], as[i][0]);
            split(p[i][j][2], ab[i][1], as[i][1]);
            split(p[i][j][1], ab[i][2], as[i][2]);
            split(p[i][j][3], ab[i][3], as[i][3]);
          }
          uint32_t bb[NG][2], bs[NG][2];
#pragma unroll
          for (int n = 0; n < NG; ++n) {
            split(b[(j * 8 + 2 * t) * ld + (n0 + n) * 8 + g], bb[n][0],
                  bs[n][0]);
            split(b[(j * 8 + 2 * t + 1) * ld + (n0 + n) * 8 + g], bb[n][1],
                  bs[n][1]);
          }
#pragma unroll
          for (int i = 0; i < MT; ++i)
            mma3<NG>(part[i], ab[i], as[i], bb, bs);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NG; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][n0 + n][e] += part[i][n][e];
      }
    }
  }
}

// rows [r0, r0 + R) of a (S, D) matrix of T into a padded tile (row stride
// ld) by 16-byte cp.async; rows past S are zero-filled
template <typename T, int D, int R, int kThreads>
__device__ __forceinline__ void fetch_rows(T* dst, const T* src, int r0,
                                           int S, int ld) {
  constexpr int kCh = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int kEl = 16 / (int)sizeof(T);
#pragma unroll 4
  for (int i = threadIdx.x; i < R * kCh; i += kThreads) {
    const int r = i / kCh, c = (i % kCh) * kEl;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * ld + c, src + (size_t)(ok ? r0 + r : 0) * D + c,
               ok);
  }
}

// two elements of a C fragment row, rounded once to T
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<__nv_bfloat16>(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<__half>(a, b);
}

}  // namespace mxt_tc
