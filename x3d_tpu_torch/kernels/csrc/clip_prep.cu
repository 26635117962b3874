// The clip kernel: decoded frames -> the model's input batch, in one pass.
//
// For every output element (clip frame m, y, x, channel c) of an NDHWC
// batch (N, T, S, S, 3), with M = N * T clip frames, it samples clip frame
// m's decoded frame (RGB interleaved, rows of `pitch` bytes, reached
// through the map table's pointer) by that clip frame's bilinear map:
//
//   xs   = flip ? S - 1 - x : x
//   in_y = (float(y  + off_y) + 0.5f) * scale_y - 0.5f      (likewise x)
//   y0   = clamp(floor(in_y), 0, win_h - 1),  y1 = min(ceil(in_y), win_h - 1)
//   ly   = in_y - floor(in_y)
//   top  = p(y0, x0) + (p(y0, x1) - p(y0, x0)) * lx
//   bot  = p(y1, x0) + (p(y1, x1) - p(y1, x0)) * lx
//   v    = top + (bot - top) * ly
//
// with rows and columns counted inside the window (win_y, win_x, win_h,
// win_w) of the frame: tf.image.resize's bilinear with half-pixel centres,
// its lerps in its order, in float32.  v is truncated to uint8 as tf.cast
// does, and written as is (out_kind 2) or normalised as the port's
// utils.normalize does, (u / 255 - mean[c]) / std[c], in float32 (0) or
// rounded to bfloat16 (1).
//
// It is the spatial half of the JAX package's input pipeline
// (x3d_tpu/data/pipeline.py:142-238: the fast crop's decode_and_crop +
// resize + flip for training, transforms.py:108-192's short-side resize
// and uniform crops for eval) fused with its on-device cast and
// normalisation (x3d_tpu/data/device.py:17-28).  No TPU kernel stands
// behind it: on the TPU these ran in tf.data on the host and in XLA.
//
// This file is compiled with -fmad=false (kernels/_build.py): a contracted
// multiply-add rounds once where TensorFlow and the plain version round
// twice, and the result would move by a level now and then.
//
// One thread an output pixel (its three channels); a block's threads are
// consecutive pixels of one clip frame, so the writes are coalesced and
// the four taps of neighbouring threads share cache lines.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

struct ClipMap {          // 48 bytes; mirrors ops/clip_prep.MAP_DTYPE
  long long src;          // the decoded frame's first byte
  int pitch;              // bytes a frame row
  int win_y, win_x, win_h, win_w;
  int off_y, off_x;
  int flip;
  float scale_y, scale_x;
};
static_assert(sizeof(ClipMap) == 48, "ClipMap must match MAP_DTYPE");

struct Norm {
  float mean[3], std[3];
};

__device__ __forceinline__ void taps(int i, int off, float scale, int win,
                                     int* lo, int* hi, float* lerp) {
  const float in = (float)(i + off) + 0.5f;
  const float pos = in * scale - 0.5f;
  const float f = floorf(pos);
  *lo = min(max((int)f, 0), win - 1);
  *hi = min((int)ceilf(pos), win - 1);
  *lerp = pos - f;
}

__device__ __forceinline__ void store(float* out, long long i, int c,
                                      unsigned char u, const Norm& n) {
  out[i + c] = ((float)u / 255.f - n.mean[c]) / n.std[c];
}
__device__ __forceinline__ void store(__nv_bfloat16* out, long long i, int c,
                                      unsigned char u, const Norm& n) {
  out[i + c] = __float2bfloat16_rn(((float)u / 255.f - n.mean[c]) / n.std[c]);
}
__device__ __forceinline__ void store(unsigned char* out, long long i, int c,
                                      unsigned char u, const Norm&) {
  out[i + c] = u;
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    clip_prep_kernel(const ClipMap* __restrict__ maps, int S, Norm norm,
                     Out* __restrict__ out) {
  const int m = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= S * S) return;
  const ClipMap mp = maps[m];
  const int y = p / S;
  const int x = p - y * S;
  const int xs = mp.flip ? S - 1 - x : x;
  int y0, y1, x0, x1;
  float ly, lx;
  taps(y, mp.off_y, mp.scale_y, mp.win_h, &y0, &y1, &ly);
  taps(xs, mp.off_x, mp.scale_x, mp.win_w, &x0, &x1, &lx);
  const unsigned char* frame =
      reinterpret_cast<const unsigned char*>(mp.src);
  const unsigned char* r0 = frame + (long long)(mp.win_y + y0) * mp.pitch;
  const unsigned char* r1 = frame + (long long)(mp.win_y + y1) * mp.pitch;
  const int c0 = (mp.win_x + x0) * 3, c1 = (mp.win_x + x1) * 3;
  const long long o = ((long long)m * S * S + p) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float tl = r0[c0 + c], tr = r0[c1 + c];
    const float bl = r1[c0 + c], br = r1[c1 + c];
    const float top = tl + (tr - tl) * lx;
    const float bot = bl + (br - bl) * lx;
    const float v = top + (bot - top) * ly;
    store(out, o, c, (unsigned char)v, norm);
  }
}

}  // namespace

// out_kind: 0 float32, 1 bfloat16, 2 uint8.
extern "C" int x3d_clip_prep(const void* maps, int M, int S, int out_kind,
                             float m0, float m1, float m2, float s0, float s1,
                             float s2, void* out, void* stream) {
  if (M <= 0) return 0;
  const Norm norm{{m0, m1, m2}, {s0, s1, s2}};
  const dim3 grid((S * S + kThreads - 1) / kThreads, M);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ClipMap* mp = static_cast<const ClipMap*>(maps);
  if (out_kind == 0)
    clip_prep_kernel<<<grid, kThreads, 0, st>>>(mp, S, norm,
                                                static_cast<float*>(out));
  else if (out_kind == 1)
    clip_prep_kernel<<<grid, kThreads, 0, st>>>(
        mp, S, norm, static_cast<__nv_bfloat16*>(out));
  else if (out_kind == 2)
    clip_prep_kernel<<<grid, kThreads, 0, st>>>(
        mp, S, norm, static_cast<unsigned char*>(out));
  else
    return 2000;
  return static_cast<int>(cudaGetLastError());
}
