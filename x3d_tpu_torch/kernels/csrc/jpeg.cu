// The input pipeline's codec on the card: a plain C interface over nvJPEG,
// plus the host-side CRC-32C that checks TFRecord framing.
//
//   x3d_jpeg_create    an nvJPEG handle on the backend asked for, with one
//                      encoder state
//   x3d_jpeg_state_create / _destroy
//                      a batched-decode state: one for each stream that
//                      decodes, since nvJPEG orders a state's work only
//                      within the stream it is used on
//   x3d_jpeg_decode    a batch of JPEG bitstreams (host memory) into RGB
//                      interleaved frames at given device addresses, with a
//                      state on its stream; every header is checked first
//                      against the size the caller planned with
//   x3d_jpeg_encode    one RGB interleaved frame on the device into a
//                      baseline JPEG (4:2:0, the given quality) in host
//                      memory
//   x3d_crc32c         CRC-32C (Castagnoli) of host bytes, slicing by 8
//
// Replaces, on the card, what the JAX package's input path did on the host:
// tf.io.decode_jpeg / libjpeg's decode (x3d_tpu/data/pipeline.py:135,
// x3d_tpu/native/clip_loader.cc:350-382), tf.io.encode_jpeg in the shard
// writer (x3d_tpu/data/tfrecords.py:40) and the CRC of tf.io's TFRecord
// framing.  There is no TPU kernel behind any of them.
//
// Every function returns 0 or an error: an nvJPEG status (1-9), a CUDA
// error plus 1000, or one of the codes below.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kErrSizeMismatch = 2001;   // header disagrees with the plan
constexpr int kErrComponents = 2002;     // not a 1- or 3-component JPEG
constexpr int kErrBufferSmall = 2003;    // encoded bitstream over capacity

struct Codec {
  nvjpegHandle_t handle = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int quality = -1;
};

struct DecodeState {
  nvjpegJpegState_t state = nullptr;
  int batch = 0;                 // the batch size the state was set up for
};

uint32_t g_crc_table[8][256];

bool crc_init() {
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
    g_crc_table[0][i] = c;
  }
  for (int t = 1; t < 8; ++t)
    for (int i = 0; i < 256; ++i)
      g_crc_table[t][i] = (g_crc_table[t - 1][i] >> 8) ^
                          g_crc_table[0][g_crc_table[t - 1][i] & 0xff];
  return true;
}

}  // namespace

extern "C" int x3d_jpeg_create(int backend, void** out) {
  Codec* c = new Codec();
  nvjpegStatus_t s = nvjpegCreateEx(static_cast<nvjpegBackend_t>(backend),
                                    nullptr, nullptr, 0, &c->handle);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderStateCreate(c->handle, &c->enc_state, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsCreate(c->handle, &c->enc_params, nullptr);
  if (s == NVJPEG_STATUS_SUCCESS)
    s = nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_420,
                                              nullptr);
  if (s != NVJPEG_STATUS_SUCCESS) {
    if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
    if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
    if (c->handle) nvjpegDestroy(c->handle);
    delete c;
    *out = nullptr;
    return static_cast<int>(s);
  }
  *out = c;
  return 0;
}

extern "C" int x3d_jpeg_destroy(void* codec) {
  Codec* c = static_cast<Codec*>(codec);
  if (!c) return 0;
  nvjpegEncoderParamsDestroy(c->enc_params);
  nvjpegEncoderStateDestroy(c->enc_state);
  nvjpegDestroy(c->handle);
  delete c;
  return 0;
}

extern "C" int x3d_jpeg_state_create(void* codec, void** out) {
  DecodeState* d = new DecodeState();
  nvjpegStatus_t s =
      nvjpegJpegStateCreate(static_cast<Codec*>(codec)->handle, &d->state);
  if (s != NVJPEG_STATUS_SUCCESS) {
    delete d;
    *out = nullptr;
    return static_cast<int>(s);
  }
  *out = d;
  return 0;
}

extern "C" int x3d_jpeg_state_destroy(void* state) {
  DecodeState* d = static_cast<DecodeState*>(state);
  if (!d) return 0;
  nvjpegJpegStateDestroy(d->state);
  delete d;
  return 0;
}

// Decode n bitstreams: data[i] (host, lengths[i] bytes) into the device
// frame at outputs[i], heights[i] x widths[i] x 3 bytes, rows packed.  On a
// header that is not a JPEG, or disagrees with the planned size, *bad is
// set to its index and nothing is decoded.  The state is used on this
// stream alone.
extern "C" int x3d_jpeg_decode(void* codec, void* state, int n,
                               const void* data, const void* lengths,
                               const void* outputs, const void* heights,
                               const void* widths, void* bad, void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  DecodeState* d = static_cast<DecodeState*>(state);
  const unsigned char* const* ptrs =
      static_cast<const unsigned char* const*>(data);
  const size_t* lens = static_cast<const size_t*>(lengths);
  const unsigned long long* outs =
      static_cast<const unsigned long long*>(outputs);
  const int* hs = static_cast<const int*>(heights);
  const int* ws = static_cast<const int*>(widths);
  int* bad_index = static_cast<int*>(bad);
  *bad_index = -1;
  if (n <= 0) return 0;
  for (int i = 0; i < n; ++i) {
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t s =
        nvjpegGetImageInfo(c->handle, ptrs[i], lens[i], &comps, &sub, w, h);
    if (s != NVJPEG_STATUS_SUCCESS) {
      *bad_index = i;
      return static_cast<int>(s);
    }
    if (comps != 1 && comps != 3) {
      *bad_index = i;
      return kErrComponents;
    }
    if (w[0] != ws[i] || h[0] != hs[i]) {
      *bad_index = i;
      return kErrSizeMismatch;
    }
  }
  if (d->batch != n) {
    nvjpegStatus_t s = nvjpegDecodeBatchedInitialize(c->handle, d->state, n, 1,
                                                     NVJPEG_OUTPUT_RGBI);
    if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
    d->batch = n;
  }
  nvjpegImage_t* images = new nvjpegImage_t[n];
  std::memset(images, 0, sizeof(nvjpegImage_t) * n);
  for (int i = 0; i < n; ++i) {
    images[i].channel[0] = reinterpret_cast<unsigned char*>(outs[i]);
    images[i].pitch[0] = static_cast<size_t>(ws[i]) * 3;
  }
  nvjpegStatus_t s = nvjpegDecodeBatched(c->handle, d->state, ptrs, lens,
                                         images,
                                         static_cast<cudaStream_t>(stream));
  delete[] images;
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

// Encode one height x width RGB interleaved frame (device, rows packed)
// into dst (host, cap bytes); *length gets the bitstream's size.  Waits
// for the stream: the bitstream is read back to the host.
extern "C" int x3d_jpeg_encode(void* codec, const void* rgb, int height,
                               int width, int quality, void* dst,
                               unsigned long long cap, void* length,
                               void* stream) {
  Codec* c = static_cast<Codec*>(codec);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  nvjpegStatus_t s;
  if (c->quality != quality) {
    s = nvjpegEncoderParamsSetQuality(c->enc_params, quality, st);
    if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
    c->quality = quality;
  }
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(
      static_cast<const unsigned char*>(rgb));
  src.pitch[0] = static_cast<size_t>(width) * 3;
  s = nvjpegEncodeImage(c->handle, c->enc_state, c->enc_params, &src,
                        NVJPEG_INPUT_RGBI, width, height, st);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  size_t n = 0;
  s = nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, nullptr, &n, st);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  *static_cast<unsigned long long*>(length) = n;
  if (n > cap) return kErrBufferSmall;
  cudaError_t e = cudaStreamSynchronize(st);
  if (e != cudaSuccess) return 1000 + static_cast<int>(e);
  s = nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state,
                                    static_cast<unsigned char*>(dst), &n, st);
  if (s != NVJPEG_STATUS_SUCCESS) return static_cast<int>(s);
  e = cudaStreamSynchronize(st);
  return e == cudaSuccess ? 0 : 1000 + static_cast<int>(e);
}

namespace {

uint32_t crc32c(const unsigned char* p, unsigned long long n) {
  static const bool ready = crc_init();   // once, thread-safe
  (void)ready;
  uint32_t crc = 0xFFFFFFFFu;
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, p, 4);
    std::memcpy(&hi, p + 4, 4);
    lo ^= crc;
    crc = g_crc_table[7][lo & 0xff] ^ g_crc_table[6][(lo >> 8) & 0xff] ^
          g_crc_table[5][(lo >> 16) & 0xff] ^ g_crc_table[4][lo >> 24] ^
          g_crc_table[3][hi & 0xff] ^ g_crc_table[2][(hi >> 8) & 0xff] ^
          g_crc_table[1][(hi >> 16) & 0xff] ^ g_crc_table[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_crc_table[0][(crc ^ *p++) & 0xff] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // namespace

extern "C" int x3d_crc32c(const void* data, unsigned long long n,
                          void* out) {
  *static_cast<unsigned int*>(out) =
      crc32c(static_cast<const unsigned char*>(data), n);
  return 0;
}
