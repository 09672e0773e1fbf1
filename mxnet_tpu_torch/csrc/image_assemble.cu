// Batch assembly of ImageRecordIter on the card: resize of the short side,
// crop, mirror, HWC -> CHW into the batch slot, as uint8 or as float32
// with mean/std. One launch a batch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is the card's counterpart of the JAX
// package's native C++ pipeline, ProcessRecord (src/runtime_native.cc:
// 357-430) after the JPEG decode, which ran on the host. Same function,
// bit for bit: ResizeBilinearRGB's float arithmetic (l.259: the pixel
// centre mapping (y + 0.5) * (src / dst) - 0.5 clamped at 0, truncation,
// the four-tap sum in its order, + 0.5 and truncation to uint8), the crop
// at offsets the host draws with the pipeline's xorshift64* per record
// (image/assemble.py), the mirror, and (x - mean) * (1 / std) in float32.
// Every product and sum is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, ...): nvcc would otherwise contract a * b + c into one FMA
// and round once where the host rounds twice.
//
// Input: the batch's decoded images, interleaved RGB uint8, packed one
// after another in one device buffer (nvJPEG writes them there), and one
// descriptor an image. Output: (B, 3, H, W).
//
// What bounds it: bytes. It reads each image's crop window (up to four
// source pixels an output pixel when it resizes, from L2 mostly) and
// writes B * 3 * H * W bytes (x4 in float32); no arithmetic is heavy. A
// thread makes one output pixel's three channels; a block covers 256
// pixels of one image, the grid's y is the image. Neighbouring threads
// write neighbouring addresses of each channel plane (coalesced); the
// reads are 3-byte strided (a later PR may stage rows in shared memory).
#include <stdint.h>

#include "mxt_common.cuh"

struct MxtImgDesc {
  long long src;   // byte offset of the image in the packed buffer
  int sh, sw;      // decoded height, width
  int rh, rw;      // after the resize of the short side (= sh, sw: none)
  int y0, x0;      // crop origin in the resized image
  int mirror;      // 1: the crop is read right to left
  int pad_;
};

namespace {

// ResizeBilinearRGB's value of resized pixel (y, x), channel ch.
__device__ __forceinline__ uint8_t resized_px(const uint8_t* img, int sh,
                                              int sw, int rh, int rw, int y,
                                              int x, int ch) {
  const float ys = __fdiv_rn(static_cast<float>(sh), static_cast<float>(rh));
  const float xs = __fdiv_rn(static_cast<float>(sw), static_cast<float>(rw));
  float fy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), ys),
                       0.5f);
  if (fy < 0) fy = 0;
  int y0 = static_cast<int>(fy);
  if (y0 > sh - 1) y0 = sh - 1;
  const int y1 = y0 + 1 < sh ? y0 + 1 : sh - 1;
  const float wy = __fsub_rn(fy, static_cast<float>(y0));
  float fx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), xs),
                       0.5f);
  if (fx < 0) fx = 0;
  int x0 = static_cast<int>(fx);
  if (x0 > sw - 1) x0 = sw - 1;
  const int x1 = x0 + 1 < sw ? x0 + 1 : sw - 1;
  const float wx = __fsub_rn(fx, static_cast<float>(x0));
  const float v00 = img[(static_cast<long long>(y0) * sw + x0) * 3 + ch];
  const float v01 = img[(static_cast<long long>(y0) * sw + x1) * 3 + ch];
  const float v10 = img[(static_cast<long long>(y1) * sw + x0) * 3 + ch];
  const float v11 = img[(static_cast<long long>(y1) * sw + x1) * 3 + ch];
  const float owy = __fsub_rn(1.0f, wy), owx = __fsub_rn(1.0f, wx);
  float v = __fmul_rn(__fmul_rn(v00, owy), owx);
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, owy), wx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), owx));
  v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
  return static_cast<uint8_t>(__fadd_rn(v, 0.5f));
}

template <typename T>
__global__ void __launch_bounds__(256)
    assemble(const uint8_t* __restrict__ raw,
             const MxtImgDesc* __restrict__ desc, T* __restrict__ out, int H,
             int W, float m0, float m1, float m2, float s0, float s1,
             float s2) {
  const int b = blockIdx.y;
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= H * W) return;
  const MxtImgDesc d = desc[b];
  const int y = pix / W, xo = pix - y * W;
  const int ry = d.y0 + y;
  const int rx = d.x0 + (d.mirror ? W - 1 - xo : xo);
  const uint8_t* img = raw + d.src;
  const bool resize = d.rh != d.sh || d.rw != d.sw;
  const long long plane = static_cast<long long>(H) * W;
  T* o = out + static_cast<long long>(b) * 3 * plane + pix;
  const float mean[3] = {m0, m1, m2}, sinv[3] = {s0, s1, s2};
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const uint8_t v =
        resize ? resized_px(img, d.sh, d.sw, d.rh, d.rw, ry, rx, ch)
               : img[(static_cast<long long>(ry) * d.sw + rx) * 3 + ch];
    if constexpr (sizeof(T) == 1) {
      o[ch * plane] = v;
    } else {
      o[ch * plane] =
          __fmul_rn(__fsub_rn(static_cast<float>(v), mean[ch]), sinv[ch]);
    }
  }
}

}  // namespace

extern "C" {

// `n` images of `desc` (device memory) from `raw` into `out` (n, 3, H, W):
// uint8 where `f32` is 0, else float32 (x - mean[c]) * stdinv[c].
int mxt_image_assemble(const void* raw, const void* desc, void* out, int n,
                       int H, int W, int f32, float m0, float m1, float m2,
                       float s0, float s1, float s2, int device,
                       void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (n <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 grid((H * W + 255) / 256, n);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(raw);
  const MxtImgDesc* d = static_cast<const MxtImgDesc*>(desc);
  if (f32) {
    assemble<float><<<grid, 256, 0, st>>>(r, d, static_cast<float*>(out), H,
                                          W, m0, m1, m2, s0, s1, s2);
  } else {
    assemble<uint8_t><<<grid, 256, 0, st>>>(r, d, static_cast<uint8_t*>(out),
                                            H, W, m0, m1, m2, s0, s1, s2);
  }
  e = cudaGetLastError();
  if (e == cudaSuccess) mxt_counted();
  return static_cast<int>(e);
}

}  // extern "C"
