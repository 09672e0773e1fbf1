// JPEG decode and encode on the card through nvJPEG (the CUDA toolkit's
// libnvjpeg), behind a plain C interface for ctypes.
//
// mxt-link: -lnvjpeg
//
// Replaces no TPU kernel: the JAX package decodes on the host, with OpenCV
// or PIL (mxnet_tpu/image/image.py:25-46, recordio.py:218-241) or with
// libjpeg in its native pipeline (src/runtime_native.cc:170-241). Here
// the decode runs in nvJPEG's default backend (Huffman on the calling host
// thread, the inverse DCT and the colour conversion on the card), and the
// pixels land in device memory, where the batch-assembly kernel
// (image_assemble.cu) reads them. mxt_jpeg_hardware_status only asks
// whether nvJPEG would make a handle for the card's hardware JPEG decoder;
// nothing decodes through one.
//
// A codec context is one handle, one decoder state and one encoder state:
// the Python side keeps one per thread (image/codec.py), as nvJPEG wants a
// state per thread. Every entry returns 0, a CUDA error (< 1000), or 1000
// plus an nvjpegStatus_t; mxt_jpeg_error_string names either.
#include <nvjpeg.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include "mxt_common.cuh"

namespace {

constexpr int kJpegErr = 1000;

struct Codec {
  int device = 0;
  nvjpegHandle_t handle = nullptr;      // default backend
  nvjpegJpegState_t state = nullptr;
  nvjpegEncoderState_t enc = nullptr;
  nvjpegEncoderParams_t params = nullptr;
};

inline int js(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_SUCCESS ? 0 : kJpegErr + static_cast<int>(s);
}

#define MXT_TRY(expr)          \
  do {                         \
    const int _e = (expr);     \
    if (_e) return _e;         \
  } while (0)

}  // namespace

extern "C" {

const char* mxt_jpeg_error_string(int err) {
  if (err < kJpegErr) return cudaGetErrorString(static_cast<cudaError_t>(err));
  switch (err - kJpegErr) {
    case NVJPEG_STATUS_NOT_INITIALIZED: return "nvJPEG: not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "nvJPEG: invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "nvJPEG: bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "nvJPEG: JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "nvJPEG: allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "nvJPEG: execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "nvJPEG: backend not on this card";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "nvJPEG: internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "nvJPEG: not implemented for this backend";
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM: return "nvJPEG: incomplete bitstream";
    default: return "nvJPEG: unknown status";
  }
}

void mxt_jpeg_destroy(void* p) {
  Codec* c = static_cast<Codec*>(p);
  if (!c) return;
  mxt_set_device(c->device);
  if (c->params) nvjpegEncoderParamsDestroy(c->params);
  if (c->enc) nvjpegEncoderStateDestroy(c->enc);
  if (c->state) nvjpegJpegStateDestroy(c->state);
  if (c->handle) nvjpegDestroy(c->handle);
  delete c;
}

// A codec on `device`. `flags` go to nvjpegCreateEx (e.g.
// NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION).
int mxt_jpeg_create(int device, int flags, void** out) {
  *out = nullptr;
  MXT_TRY(static_cast<int>(mxt_set_device(device)));
  Codec* c = new Codec();
  c->device = device;
  int e = js(nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                            static_cast<unsigned>(flags), &c->handle));
  if (!e) e = js(nvjpegJpegStateCreate(c->handle, &c->state));
  if (!e) e = js(nvjpegEncoderStateCreate(c->handle, &c->enc, nullptr));
  if (!e) e = js(nvjpegEncoderParamsCreate(c->handle, &c->params, nullptr));
  if (e) {
    mxt_jpeg_destroy(c);
    return e;
  }
  *out = c;
  return 0;
}

// How nvJPEG answers a request for a handle on the hardware JPEG decoder
// of `device`: 0 where it would make one (the handle is destroyed at
// once), else 1000 plus its status, or a CUDA error.
int mxt_jpeg_hardware_status(int device, int flags) {
  MXT_TRY(static_cast<int>(mxt_set_device(device)));
  nvjpegHandle_t h = nullptr;
  const nvjpegStatus_t st =
      nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr,
                     static_cast<unsigned>(flags), &h);
  if (st == NVJPEG_STATUS_SUCCESS) nvjpegDestroy(h);
  return js(st);
}

// Components, chroma subsampling (nvjpegChromaSubsampling_t) and the first
// component's width and height of an encoded image (a host buffer).
int mxt_jpeg_info(void* p, const unsigned char* data, size_t len, int* comps,
                  int* subsampling, int* width, int* height) {
  Codec* c = static_cast<Codec*>(p);
  int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
  nvjpegChromaSubsampling_t ss;
  MXT_TRY(js(nvjpegGetImageInfo(c->handle, data, len, comps, &ss, w, h)));
  *subsampling = static_cast<int>(ss);
  *width = w[0];
  *height = h[0];
  return 0;
}

// One image from a host buffer into device memory at `out` (rows of
// `pitch` bytes) in `fmt` (nvjpegOutputFormat_t: RGBI / BGRI interleave
// three channels, Y is one), on `stream`. Returns once the card has the
// bitstream's decoded coefficients queued; the caller syncs the stream
// before it frees `data`.
int mxt_jpeg_decode(void* p, const unsigned char* data, size_t len, int fmt,
                    unsigned char* out, size_t pitch, void* stream) {
  Codec* c = static_cast<Codec*>(p);
  MXT_TRY(static_cast<int>(mxt_set_device(c->device)));
  nvjpegImage_t img;
  memset(&img, 0, sizeof(img));
  img.channel[0] = out;
  img.pitch[0] = pitch;
  return js(nvjpegDecode(c->handle, c->state, data, len,
                         static_cast<nvjpegOutputFormat_t>(fmt), &img,
                         static_cast<cudaStream_t>(stream)));
}

// `n` images from host buffers into device memory in one batched call,
// interleaved `fmt` only. The state is initialized for each call: single
// decodes share it.
int mxt_jpeg_decode_batch(void* p, int n, const unsigned char* const* data,
                          const size_t* lens, unsigned char* const* outs,
                          const size_t* pitches, int fmt, void* stream) {
  Codec* c = static_cast<Codec*>(p);
  MXT_TRY(static_cast<int>(mxt_set_device(c->device)));
  MXT_TRY(js(nvjpegDecodeBatchedInitialize(
      c->handle, c->state, n, 1, static_cast<nvjpegOutputFormat_t>(fmt))));
  nvjpegImage_t* imgs =
      static_cast<nvjpegImage_t*>(calloc(n, sizeof(nvjpegImage_t)));
  if (!imgs) return static_cast<int>(cudaErrorMemoryAllocation);
  for (int i = 0; i < n; ++i) {
    imgs[i].channel[0] = outs[i];
    imgs[i].pitch[0] = pitches[i];
  }
  const int e = js(nvjpegDecodeBatched(c->handle, c->state, data, lens, imgs,
                                       static_cast<cudaStream_t>(stream)));
  free(imgs);
  return e;
}

// Encode one interleaved 8-bit image in device memory (`channels` 3: RGB,
// or BGR where `bgr`, with 4:2:0 chroma as OpenCV's default; 1: gray) at
// `quality`, on `stream` (the one that wrote `img`). Waits for it, then
// *len is the bitstream's length; mxt_jpeg_encode_fetch copies it out.
int mxt_jpeg_encode(void* p, const unsigned char* img, int width, int height,
                    int channels, size_t pitch, int quality, int bgr,
                    void* stream, size_t* len) {
  Codec* c = static_cast<Codec*>(p);
  MXT_TRY(static_cast<int>(mxt_set_device(c->device)));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXT_TRY(js(nvjpegEncoderParamsSetQuality(c->params, quality, st)));
  MXT_TRY(js(nvjpegEncoderParamsSetOptimizedHuffman(c->params, 0, st)));
  nvjpegImage_t src;
  memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(img);
  src.pitch[0] = pitch;
  if (channels == 1) {
    MXT_TRY(js(nvjpegEncoderParamsSetSamplingFactors(c->params,
                                                     NVJPEG_CSS_GRAY, st)));
    MXT_TRY(js(nvjpegEncodeYUV(c->handle, c->enc, c->params, &src,
                               NVJPEG_CSS_GRAY, width, height, st)));
  } else {
    MXT_TRY(js(nvjpegEncoderParamsSetSamplingFactors(c->params,
                                                     NVJPEG_CSS_420, st)));
    MXT_TRY(js(nvjpegEncodeImage(c->handle, c->enc, c->params, &src,
                                 bgr ? NVJPEG_INPUT_BGRI : NVJPEG_INPUT_RGBI,
                                 width, height, st)));
  }
  MXT_TRY(js(nvjpegEncodeRetrieveBitstream(c->handle, c->enc, nullptr, len,
                                           st)));
  return static_cast<int>(cudaStreamSynchronize(st));
}

int mxt_jpeg_encode_fetch(void* p, unsigned char* out, size_t* len,
                          void* stream) {
  Codec* c = static_cast<Codec*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MXT_TRY(js(nvjpegEncodeRetrieveBitstream(c->handle, c->enc, out, len, st)));
  return static_cast<int>(cudaStreamSynchronize(st));
}

}  // extern "C"
