// Greedy non-maximum suppression of Proposal / MultiProposal for Hopper
// (sm_90a): the keep mask of each image's score-sorted boxes, box i kept
// unless an earlier kept box has IoU >= threshold with it.
//
// Replaces no TPU kernel: the JAX package runs this NMS as an XLA
// fori_loop over the rows (mxnet_tpu/ops/contrib.py:286 _nms_keep, called
// by _proposal_one at :1148), one vectorised suppression a row. On the
// card that is a row at a time from the host: at Faster R-CNN's 12,000
// pre-NMS boxes, 12,000 iterations of a few launches a step. Here it is
// two launches and no host read:
//   1. mask: a block compares 64 rows with 64 columns of one image and
//      sets bit j of word (row, column block) where a later box's IoU
//      with the row reaches the threshold (blocks below the diagonal
//      exit: the sweep never reads them);
//   2. sweep: one block an image walks the rows in order, a 64-row chunk
//      at a time, keeping the "removed" words in shared memory (12,000
//      boxes: 188 words). One thread resolves the chunk's rows from its
//      diagonal word, then every thread ORs the chunk's kept rows' words
//      into the later words it owns.
// The IoU is the plain version's (ops/contrib.py _pair_iou) operation for
// operation, each product, sum and the division an explicitly rounded
// intrinsic (nvcc would contract a * b + c into one FMA), in the boxes'
// type (float32 or float64), so the keep mask equals the plain version's
// bit for bit. The caller shifts the far corners by +1 (the +1-width
// pixel convention) before either version.
//
// What bounds it: the sweep's dependence from row to row, not bytes or
// operations: the mask kernel reads n boxes and writes n * n / 128 bytes
// (18 MB at n = 12,000), and the IoUs are n^2 / 2 of ~12 flops; the sweep
// walks n / 64 chunks in sequence.
#include <stdint.h>

#include "mxt_common.cuh"

namespace {

constexpr int kTile = 64;

template <typename T>
__device__ __forceinline__ T area(const T* b) {
  const T w = sub_rn(b[2], b[0]);
  const T h = sub_rn(b[3], b[1]);
  return (w < T(0) || h < T(0)) ? T(0) : mul_rn(w, h);
}

// _pair_iou of two corner boxes >= thresh
template <typename T>
__device__ __forceinline__ bool iou_ge(const T* a, const T* b, T thresh) {
  const T lx = a[0] > b[0] ? a[0] : b[0];
  const T ly = a[1] > b[1] ? a[1] : b[1];
  const T rx = a[2] < b[2] ? a[2] : b[2];
  const T ry = a[3] < b[3] ? a[3] : b[3];
  T wx = sub_rn(rx, lx);
  T wy = sub_rn(ry, ly);
  wx = wx > T(0) ? wx : T(0);
  wy = wy > T(0) ? wy : T(0);
  const T inter = mul_rn(wx, wy);
  const T uni = sub_rn(add_rn(area(a), area(b)), inter);
  const T iou = uni <= T(0) ? T(0) : div_rn(inter, uni);
  return iou >= thresh;
}

// grid (column blocks, row blocks, images), kTile threads
template <typename T>
__global__ void nms_mask(const T* __restrict__ boxes, int n, int words,
                         T thresh, unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, img = blockIdx.z;
  if (cb < rb) return;
  __shared__ T cols[kTile * 4];
  const T* base = boxes + 4LL * n * img;
  const int c0 = cb * kTile;
  const int nc = min(kTile, n - c0);
  if (threadIdx.x < nc)
    for (int k = 0; k < 4; ++k)
      cols[threadIdx.x * 4 + k] = base[4LL * (c0 + threadIdx.x) + k];
  __syncthreads();
  const int row = rb * kTile + threadIdx.x;
  if (row >= n) return;
  T a[4];
  for (int k = 0; k < 4; ++k) a[k] = base[4LL * row + k];
  unsigned long long bits = 0;
  for (int j = 0; j < nc; ++j)
    if (c0 + j > row && iou_ge(a, cols + 4 * j, thresh)) bits |= 1ULL << j;
  mask[(static_cast<long long>(img) * n + row) * words + cb] = bits;
}

// grid (images), any block size; dynamic shared memory: words * 8 bytes
__global__ void nms_sweep(const unsigned long long* __restrict__ mask, int n,
                          int words, bool* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  __shared__ unsigned long long diag[kTile];
  __shared__ unsigned long long kept_word;
  const int img = blockIdx.x;
  const unsigned long long* m = mask + static_cast<long long>(img) * n * words;
  for (int w = threadIdx.x; w < words; w += blockDim.x) removed[w] = 0;
  __syncthreads();
  for (int j = 0; j < words; ++j) {
    const int r0 = j * kTile;
    const int cnt = min(kTile, n - r0);
    if (threadIdx.x < cnt)
      diag[threadIdx.x] = m[static_cast<long long>(r0 + threadIdx.x) * words + j];
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long rem = removed[j], kept = 0;
      for (int t = 0; t < cnt; ++t)
        if (!((rem >> t) & 1ULL)) {
          kept |= 1ULL << t;
          rem |= diag[t];
        }
      removed[j] = rem;
      kept_word = kept;
    }
    __syncthreads();
    const unsigned long long kept = kept_word;
    if (threadIdx.x < cnt)
      keep[static_cast<long long>(img) * n + r0 + threadIdx.x] =
          (kept >> threadIdx.x) & 1ULL;
    for (int w = j + 1 + threadIdx.x; w < words; w += blockDim.x) {
      unsigned long long acc = 0, k = kept;
      while (k) {
        const int t = __ffsll(static_cast<long long>(k)) - 1;
        k &= k - 1;
        acc |= m[static_cast<long long>(r0 + t) * words + w];
      }
      removed[w] |= acc;
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t run(const void* boxes, int b, int n, double thresh, void* mask,
                void* keep, cudaStream_t st) {
  const int words = (n + kTile - 1) / kTile;
  dim3 grid(words, words, b);
  nms_mask<T><<<grid, kTile, 0, st>>>(static_cast<const T*>(boxes), n, words,
                                      static_cast<T>(thresh),
                                      static_cast<unsigned long long*>(mask));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  mxt_counted();
  const size_t smem = sizeof(unsigned long long) * words;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(nms_sweep,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  nms_sweep<<<b, 256, smem, st>>>(
      static_cast<const unsigned long long*>(mask), n, words,
      static_cast<bool*>(keep));
  e = cudaGetLastError();
  if (e == cudaSuccess) mxt_counted();
  return e;
}

}  // namespace

extern "C" {

// boxes (b, n, 4) contiguous, float32 (f64 = 0) or float64 (f64 = 1);
// mask: b * n * ceil(n / 64) 64-bit words of scratch; keep: (b, n) bool.
int mxt_proposal_nms(const void* boxes, int f64, int b, int n, double thresh,
                     void* mask, void* keep, int device, void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (b <= 0 || n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  e = f64 ? run<double>(boxes, b, n, thresh, mask, keep, st)
          : run<float>(boxes, b, n, thresh, mask, keep, st);
  return static_cast<int>(e);
}

}  // extern "C"
