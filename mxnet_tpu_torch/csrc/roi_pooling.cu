// ROIPooling forward and backward for Hopper (sm_90a): the max over each
// of a roi's pooled_size bins of the feature map, and its gradient.
//
// Replaces no TPU kernel: the JAX package computes ROIPooling as plain
// XLA (mxnet_tpu/ops/contrib.py:528, a masked max over the whole
// feature map for every roi). At Faster R-CNN's second stage (128 rois x
// 512 channels x 7 x 7 bins over a 37 x 62 map) that intermediate is
// about 4 GB a step, so the port scans each bin's rows and columns here
// instead. Same function as the plain version (ops/rcnn.py,
// roi_pooling_plain):
//   - corners round half away from zero (C round()), bin i of a side
//     covers [start + floor(i * size / n), start + ceil((i + 1) * size / n))
//     clipped to the map, computed in the rois' type (float32 for half
//     rois) with explicitly rounded intrinsics, so nvcc contracts nothing;
//   - an empty bin gives 0; the rois get no gradient;
//   - the gradient at ties is the JAX op's two-stage max (over W, then
//     over H): a bin's cotangent g is split evenly among the rows whose
//     maximum reaches the bin's, and within each such row evenly among
//     the columns that reach it, g / (n_rows * n_cols_row) each.
//
// Layout: data (N, C, H, W) and the output (R, C, PH, PW) contiguous,
// rois (R, 5) contiguous [batch index, x1, y1, x2, y2]. One thread an
// output element (r, c, ph, pw); neighbouring threads are neighbouring
// pw, so they read neighbouring columns of one row. The backward adds
// into a float32 (float64 for double data) gradient with atomicAdd; the
// wrapper zeroes it and rounds it to the data's type.
//
// What bounds it: bytes. The forward reads each bin's window once (the
// bins of a roi tile it, with a row or column of overlap where the
// floor/ceil bounds meet) and writes R * C * PH * PW values; the
// backward reads the window up to three times (max, the rows' maxima,
// the tied columns) and adds into the tied elements only.
#include <stdint.h>

#include "mxt_common.cuh"

namespace {

enum { F32 = 0, BF16 = 1, F16 = 2, F64 = 3 };

// sign(v) * floor(|v| + 0.5)
template <typename C>
__device__ __forceinline__ C round_half_away(C v) {
  const C r = floor(add_rn(fabs(v), C(0.5)));
  return v < C(0) ? -r : (v > C(0) ? r : C(0));
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }
__device__ __forceinline__ double widen(double x) { return x; }

// a value of the data's type, widened, stored back (exact: it is one of
// the data's values, or 0)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(double* p, double v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The bin's window [h0, h1) x [w0, w1) and its image, from the roi.
struct Window {
  int b, h0, h1, w0, w1;
};

template <typename C>
__device__ __forceinline__ void side(C start, C size, int i, int nbins,
                                     int length, int* lo, int* hi) {
  C a = add_rn(start, floor(div_rn(mul_rn(C(i), size), C(nbins))));
  C b = add_rn(start, ceil(div_rn(mul_rn(C(i + 1), size), C(nbins))));
  a = a < C(0) ? C(0) : (a > C(length) ? C(length) : a);
  b = b < C(0) ? C(0) : (b > C(length) ? C(length) : b);
  *lo = static_cast<int>(a);
  *hi = static_cast<int>(b);
}

template <typename C>
__device__ __forceinline__ Window window(const C* roi, C scale, int n, int h,
                                         int w, int ph, int pw, int iph,
                                         int ipw) {
  Window win;
  int b = static_cast<int>(roi[0]);
  win.b = b < 0 ? 0 : (b > n - 1 ? n - 1 : b);
  const C x1 = round_half_away(mul_rn(roi[1], scale));
  const C y1 = round_half_away(mul_rn(roi[2], scale));
  const C x2 = round_half_away(mul_rn(roi[3], scale));
  const C y2 = round_half_away(mul_rn(roi[4], scale));
  C rh = add_rn(sub_rn(y2, y1), C(1));
  C rw = add_rn(sub_rn(x2, x1), C(1));
  rh = rh > C(1) ? rh : C(1);
  rw = rw > C(1) ? rw : C(1);
  side(y1, rh, iph, ph, h, &win.h0, &win.h1);
  side(x1, rw, ipw, pw, w, &win.w0, &win.w1);
  return win;
}

template <typename T, typename C>
__global__ void roi_pool_fwd(const T* __restrict__ data,
                             const C* __restrict__ rois, T* __restrict__ out,
                             C scale, int n, int c, int h, int w, int r,
                             int ph, int pw) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(r) * c * ph * pw;
  if (idx >= total) return;
  const int ipw = static_cast<int>(idx % pw);
  const int iph = static_cast<int>((idx / pw) % ph);
  const int ic = static_cast<int>((idx / (pw * ph)) % c);
  const int ir = static_cast<int>(idx / (static_cast<long long>(pw) * ph * c));
  const Window win = window(rois + 5LL * ir, scale, n, h, w, ph, pw, iph, ipw);
  if (win.h0 >= win.h1 || win.w0 >= win.w1) {
    put(out + idx, 0.f);
    return;
  }
  const T* img = data + (static_cast<long long>(win.b) * c + ic) * h * w;
  auto m = widen(img[static_cast<long long>(win.h0) * w + win.w0]);
  for (int y = win.h0; y < win.h1; ++y) {
    const T* row = img + static_cast<long long>(y) * w;
    for (int x = win.w0; x < win.w1; ++x) {
      const auto v = widen(row[x]);
      m = v > m ? v : m;
    }
  }
  put(out + idx, m);
}

// A = float for float / bf16 / f16 data, double for double.
template <typename T, typename C, typename A>
__global__ void roi_pool_bwd(const T* __restrict__ data,
                             const C* __restrict__ rois,
                             const T* __restrict__ gout, A* __restrict__ gacc,
                             C scale, int n, int c, int h, int w, int r,
                             int ph, int pw) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long total = static_cast<long long>(r) * c * ph * pw;
  if (idx >= total) return;
  const A g = static_cast<A>(widen(gout[idx]));
  if (g == A(0)) return;
  const int ipw = static_cast<int>(idx % pw);
  const int iph = static_cast<int>((idx / pw) % ph);
  const int ic = static_cast<int>((idx / (pw * ph)) % c);
  const int ir = static_cast<int>(idx / (static_cast<long long>(pw) * ph * c));
  const Window win = window(rois + 5LL * ir, scale, n, h, w, ph, pw, iph, ipw);
  if (win.h0 >= win.h1 || win.w0 >= win.w1) return;
  const long long base = (static_cast<long long>(win.b) * c + ic) * h * w;
  const T* img = data + base;
  auto m = widen(img[static_cast<long long>(win.h0) * w + win.w0]);
  for (int y = win.h0; y < win.h1; ++y)
    for (int x = win.w0; x < win.w1; ++x) {
      const auto v = widen(img[static_cast<long long>(y) * w + x]);
      m = v > m ? v : m;
    }
  // rows whose maximum over the bin's columns reaches the bin's maximum
  int n_rows = 0;
  for (int y = win.h0; y < win.h1; ++y) {
    bool hit = false;
    for (int x = win.w0; x < win.w1 && !hit; ++x)
      hit = widen(img[static_cast<long long>(y) * w + x]) == m;
    n_rows += hit;
  }
  for (int y = win.h0; y < win.h1; ++y) {
    int n_cols = 0;
    for (int x = win.w0; x < win.w1; ++x)
      n_cols += widen(img[static_cast<long long>(y) * w + x]) == m;
    if (n_cols == 0) continue;
    const A share = g / static_cast<A>(n_rows * n_cols);
    for (int x = win.w0; x < win.w1; ++x)
      if (widen(img[static_cast<long long>(y) * w + x]) == m)
        atomicAdd(gacc + base + static_cast<long long>(y) * w + x, share);
  }
}

template <typename T, typename C>
cudaError_t fwd(const void* data, const void* rois, void* out, double scale,
                int n, int c, int h, int w, int r, int ph, int pw,
                cudaStream_t st) {
  const long long total = static_cast<long long>(r) * c * ph * pw;
  const int blocks = static_cast<int>((total + 255) / 256);
  roi_pool_fwd<T, C><<<blocks, 256, 0, st>>>(
      static_cast<const T*>(data), static_cast<const C*>(rois),
      static_cast<T*>(out), static_cast<C>(scale), n, c, h, w, r, ph, pw);
  return cudaGetLastError();
}

template <typename T, typename C, typename A>
cudaError_t bwd(const void* data, const void* rois, const void* gout,
                void* gacc, double scale, int n, int c, int h, int w, int r,
                int ph, int pw, cudaStream_t st) {
  const long long total = static_cast<long long>(r) * c * ph * pw;
  const int blocks = static_cast<int>((total + 255) / 256);
  roi_pool_bwd<T, C, A><<<blocks, 256, 0, st>>>(
      static_cast<const T*>(data), static_cast<const C*>(rois),
      static_cast<const T*>(gout), static_cast<A*>(gacc),
      static_cast<C>(scale), n, c, h, w, r, ph, pw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: F32, BF16, F16 or F64 (the data's); rois_f64: 1 if the rois are
// float64 (then the data is float64 too), else float32.
int mxt_roi_pool_fwd(const void* data, const void* rois, void* out,
                     int dtype, int rois_f64, double scale, int n, int c,
                     int h, int w, int r, int ph, int pw, int device,
                     void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(r) * c * ph * pw == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F64 && rois_f64)
    e = fwd<double, double>(data, rois, out, scale, n, c, h, w, r, ph, pw, st);
  else if (dtype == F64 || rois_f64)
    return static_cast<int>(cudaErrorInvalidValue);
  else if (dtype == F32)
    e = fwd<float, float>(data, rois, out, scale, n, c, h, w, r, ph, pw, st);
  else if (dtype == BF16)
    e = fwd<__nv_bfloat16, float>(data, rois, out, scale, n, c, h, w, r, ph,
                                  pw, st);
  else if (dtype == F16)
    e = fwd<__half, float>(data, rois, out, scale, n, c, h, w, r, ph, pw, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == cudaSuccess) mxt_counted();
  return static_cast<int>(e);
}

// gacc: (N, C, H, W) zeros, float32 (float64 for F64 data).
int mxt_roi_pool_bwd(const void* data, const void* rois, const void* gout,
                     void* gacc, int dtype, int rois_f64, double scale, int n,
                     int c, int h, int w, int r, int ph, int pw, int device,
                     void* stream) {
  cudaError_t e = mxt_set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (static_cast<long long>(r) * c * ph * pw == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == F64 && rois_f64)
    e = bwd<double, double, double>(data, rois, gout, gacc, scale, n, c, h, w,
                                    r, ph, pw, st);
  else if (dtype == F64 || rois_f64)
    return static_cast<int>(cudaErrorInvalidValue);
  else if (dtype == F32)
    e = bwd<float, float, float>(data, rois, gout, gacc, scale, n, c, h, w, r,
                                 ph, pw, st);
  else if (dtype == BF16)
    e = bwd<__nv_bfloat16, float, float>(data, rois, gout, gacc, scale, n, c,
                                         h, w, r, ph, pw, st);
  else if (dtype == F16)
    e = bwd<__half, float, float>(data, rois, gout, gacc, scale, n, c, h, w, r,
                                  ph, pw, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == cudaSuccess) mxt_counted();
  return static_cast<int>(e);
}

}  // extern "C"
