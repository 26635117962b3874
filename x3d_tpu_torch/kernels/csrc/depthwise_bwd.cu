// K4: the depthwise 3-D convolution's backward on NDHWC activations, for any
// taps, strides and explicit (lo, hi) pads -- the gradient of K1
// (depthwise.cu).  Two entry points:
//
//   dx[b, ti, hi, wi, c] = sum over the taps (dt, dh, dw) and the outputs
//                          (to, ho, wo) with to*st + dt - tlo = ti (and so on
//                          for h, w) of g[b, to, ho, wo, c] * k[dt, dh, dw, c]
//   dk[dt, dh, dw, c]    = sum_{b, to, ho, wo} xpad[b, to*st + dt, ho*sh + dh,
//                          wo*sw + dw, c] * g[b, to, ho, wo, c]
//
// Replaces the TPU kernels dw_batchminor._dk_kernel
// (x3d_tpu/ops/dw_batchminor.py:120, run by _dw_bm_bwd at :231) and
// pallas_dw._dk_kernel (x3d_tpu/ops/pallas_dw.py:123, run by _dw_rows_bwd at
// :221), whose dx reran the forward kernel with flipped taps.  Those covered
// stride 1 SAME only; the stem's 5x1x1 conv and the stride-2 stage entries
// were left to XLA.  dx here is written in gather form, so one kernel covers
// every stride and TF-SAME's odd high-side pad at stride 2 (at stride 1 it
// equals K1 with flipped taps and mirrored pads).
//
// What bounds it on an H100: bytes, as for K1 -- 27 FMAs per element against
// 4 bytes (dx: g read, dx written) or 4 bytes (dk: x and g read) per element
// in bf16.  The design:
//   * dx: a block owns one input frame of one clip, an 8x8 pixel tile and 32
//     channels (threads along the contiguous C); it stages the g planes,
//     rows and columns that reach the tile in shared memory (out-of-range
//     ones as zero) and each thread sums its taps in f32;
//   * dk: a block owns one output tile of one clip and 32 channels and walks
//     over all output frames, staging the x halo and the g tile of each in
//     shared memory; each warp owns every 8th tap and keeps its sums in
//     shared memory, so a block writes one f32 partial per (tap, channel);
//     a second kernel sums the partials of each (tap, channel) in a fixed
//     order, in double: deterministic, no atomics.
// Not yet done (later work): a rolling temporal window, cp.async/TMA staging,
// one pass for dx and dk together (ROADMAP B5's kernel).

#include "common.cuh"

namespace {

using namespace x3d;

struct BwdGeom {
  int B, T, H, W, C;      // input (x, dx)
  int kt, kh, kw;         // taps
  int st, sh, sw;         // strides
  int tlo, hlo, wlo;      // low-side pads
  int To, Ho, Wo;         // output (g)
  int TH, TW;             // rows / columns of a block's tile
  int GT, GR, GC;         // dx: staged g planes, rows, columns
  int HR, WR;             // dk: staged x rows / columns, halo included
  int nth, ntw, nct;      // tiles along H, W, C
};

// floor(a / b) for b > 0 and any sign of a
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_conv3d_dx_kernel(const T* __restrict__ g, const float* __restrict__ taps,
                        T* __restrict__ dx, BwdGeom q) {
  extern __shared__ float smem[];
  float* tile = smem;  // [GT][GR][GC][kChannels] of g
  float* wts = smem + (size_t)q.GT * q.GR * q.GC * kChannels;

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int ct = bx / q.nth;
  const int ti = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = ct * kChannels;
  const int h0 = th * q.TH, w0 = tw * q.TW;
  // the first output plane, row and column that can reach this tile
  const int to0 = floor_div(ti + q.tlo - (q.kt - 1) + q.st - 1, q.st);
  const int ho0 = floor_div(h0 + q.hlo - (q.kh - 1) + q.sh - 1, q.sh);
  const int wo0 = floor_div(w0 + q.wlo - (q.kw - 1) + q.sw - 1, q.sw);
  const int ntaps = q.kt * q.kh * q.kw;

  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int c = c0 + i % kChannels;
    wts[i] = c < q.C ? taps[(size_t)(i / kChannels) * q.C + c] : 0.f;
  }
  const int n = q.GT * q.GR * q.GC * kChannels;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = c0 + i % kChannels;
    int r = i / kChannels;
    const int wo = wo0 + r % q.GC;
    r /= q.GC;
    const int ho = ho0 + r % q.GR;
    const int to = to0 + r / q.GR;
    float v = 0.f;
    if (c < q.C && to >= 0 && to < q.To && ho >= 0 && ho < q.Ho && wo >= 0 &&
        wo < q.Wo)
      v = to_f32(g[(((size_t)(b * q.To + to) * q.Ho + ho) * q.Wo + wo) * q.C + c]);
    tile[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x % kChannels;
  const int c = c0 + lane;
  if (c >= q.C) return;
  for (int p = threadIdx.x / kChannels; p < q.TH * q.TW; p += kWarps) {
    const int hi = h0 + p / q.TW, wi = w0 + p % q.TW;
    if (hi >= q.H || wi >= q.W) continue;
    float acc = 0.f;
    for (int dt = 0; dt < q.kt; ++dt) {
      const int nt = ti + q.tlo - dt;
      const int lt = floor_div(nt, q.st);
      if (lt * q.st != nt) continue;
      for (int dh = 0; dh < q.kh; ++dh) {
        const int nh = hi + q.hlo - dh;
        const int lh = floor_div(nh, q.sh);
        if (lh * q.sh != nh) continue;
        const float* row =
            tile + ((size_t)(lt - to0) * q.GR + (lh - ho0)) * q.GC * kChannels + lane;
        const float* w = wts + (dt * q.kh + dh) * q.kw * kChannels + lane;
        for (int dw = 0; dw < q.kw; ++dw) {
          const int nw = wi + q.wlo - dw;
          const int lw = floor_div(nw, q.sw);
          if (lw * q.sw != nw) continue;
          acc = fmaf(row[(lw - wo0) * kChannels], w[dw * kChannels], acc);
        }
      }
    }
    dx[(((size_t)(b * q.T + ti) * q.H + hi) * q.W + wi) * q.C + c] = from_f32<T>(acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_conv3d_dk_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        float* __restrict__ part, BwdGeom q) {
  extern __shared__ float smem[];
  const int ntaps = q.kt * q.kh * q.kw;
  float* xt = smem;                                            // [kt][HR][WR][32]
  float* gt = xt + (size_t)q.kt * q.HR * q.WR * kChannels;     // [TH][TW][32]
  float* acc = gt + (size_t)q.TH * q.TW * kChannels;           // [taps][32]

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int ct = bx / q.nth;
  const int b = blockIdx.y;
  const int c0 = ct * kChannels;
  const int ho0 = th * q.TH, wo0 = tw * q.TW;
  const int hi0 = ho0 * q.sh - q.hlo, wi0 = wo0 * q.sw - q.wlo;
  const int lane = threadIdx.x % kChannels;
  const int warp = threadIdx.x / kChannels;

  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) acc[i] = 0.f;

  for (int to = 0; to < q.To; ++to) {
    const int ti0 = to * q.st - q.tlo;
    const int nx = q.kt * q.HR * q.WR * kChannels;
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      const int c = c0 + i % kChannels;
      int r = i / kChannels;
      const int wi = wi0 + r % q.WR;
      r /= q.WR;
      const int hi = hi0 + r % q.HR;
      const int ti = ti0 + r / q.HR;
      float v = 0.f;
      if (c < q.C && ti >= 0 && ti < q.T && hi >= 0 && hi < q.H && wi >= 0 &&
          wi < q.W)
        v = to_f32(x[(((size_t)(b * q.T + ti) * q.H + hi) * q.W + wi) * q.C + c]);
      xt[i] = v;
    }
    const int ng = q.TH * q.TW * kChannels;
    for (int i = threadIdx.x; i < ng; i += blockDim.x) {
      const int c = c0 + i % kChannels;
      const int pix = i / kChannels;
      const int ho = ho0 + pix / q.TW, wo = wo0 + pix % q.TW;
      float v = 0.f;
      if (c < q.C && ho < q.Ho && wo < q.Wo)
        v = to_f32(g[(((size_t)(b * q.To + to) * q.Ho + ho) * q.Wo + wo) * q.C + c]);
      gt[i] = v;
    }
    __syncthreads();
    for (int tap = warp; tap < ntaps; tap += kWarps) {
      const int dt = tap / (q.kh * q.kw);
      const int dh = (tap / q.kw) % q.kh;
      const int dw = tap % q.kw;
      float s = 0.f;
      for (int oh = 0; oh < q.TH; ++oh) {
        const float* xrow =
            xt + (((size_t)dt * q.HR + oh * q.sh + dh) * q.WR + dw) * kChannels + lane;
        const float* grow = gt + (size_t)oh * q.TW * kChannels + lane;
        for (int ow = 0; ow < q.TW; ++ow)
          s = fmaf(xrow[ow * q.sw * kChannels], grow[ow * kChannels], s);
      }
      acc[tap * kChannels + lane] += s;
    }
    __syncthreads();
  }

  const size_t slot = ((size_t)b * q.nth + th) * q.ntw + tw;
  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int c = c0 + i % kChannels;
    if (c < q.C) part[(slot * ntaps + i / kChannels) * q.C + c] = acc[i];
  }
}

// dk: (taps, C).  One thread per (tap, channel), channels fastest; each sums
// its nparts partials in order, in double.
__global__ void sum_dk_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ dk, int ntaps,
                                       int C, int nparts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ntaps * C) return;
  double s = 0.0;
  for (int k = 0; k < nparts; ++k) s += part[(size_t)k * ntaps * C + i];
  dk[i] = (float)s;
}

BwdGeom geometry(int B, int T, int H, int W, int C, int kt, int kh, int kw,
                 int st, int sh, int sw, int tlo, int hlo, int wlo, int To,
                 int Ho, int Wo) {
  BwdGeom q{B, T, H, W, C, kt, kh, kw, st, sh, sw, tlo, hlo, wlo, To, Ho, Wo};
  q.nct = ceil_div(C, kChannels);
  return q;
}

BwdGeom dx_geometry(BwdGeom q) {
  q.TH = q.TW = 8;  // input pixels
  q.GT = (q.kt - 1) / q.st + 1;
  q.GR = (q.TH + q.kh - 2) / q.sh + 1;
  q.GC = (q.TW + q.kw - 2) / q.sw + 1;
  q.nth = ceil_div(q.H, q.TH);
  q.ntw = ceil_div(q.W, q.TW);
  return q;
}

BwdGeom dk_geometry(BwdGeom q) {
  q.TH = q.sh >= 8 ? 1 : 8 / q.sh;  // output pixels, as K1's tiles
  q.TW = q.sw >= 8 ? 1 : 8 / q.sw;
  q.HR = (q.TH - 1) * q.sh + q.kh;
  q.WR = (q.TW - 1) * q.sw + q.kw;
  q.nth = ceil_div(q.Ho, q.TH);
  q.ntw = ceil_div(q.Wo, q.TW);
  return q;
}

bool valid(const BwdGeom& q) {
  return q.st > 0 && q.sh > 0 && q.sw > 0 && q.kt > 0 && q.kh > 0 &&
         q.kw > 0 && q.T <= 65535 && q.B <= 65535;
}

template <typename T>
int launch_dx(const void* g, const float* taps, void* dx, const BwdGeom& q,
              cudaStream_t stream) {
  const size_t smem = ((size_t)q.GT * q.GR * q.GC + (size_t)q.kt * q.kh * q.kw) *
                      kChannels * sizeof(float);
  cudaError_t err = allow_smem(dw_conv3d_dx_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q.nct * q.nth * q.ntw, q.T, q.B);
  dw_conv3d_dx_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(g), taps, static_cast<T*>(dx), q);
  return cudaGetLastError();
}

template <typename T>
int launch_dk(const void* x, const void* g, float* part, float* dk,
              const BwdGeom& q, cudaStream_t stream) {
  const int ntaps = q.kt * q.kh * q.kw;
  const size_t smem = ((size_t)q.kt * q.HR * q.WR + (size_t)q.TH * q.TW + ntaps) *
                      kChannels * sizeof(float);
  cudaError_t err = allow_smem(dw_conv3d_dk_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q.nct * q.nth * q.ntw, q.B);
  dw_conv3d_dk_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = ntaps * q.C;
  sum_dk_partials_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(
      part, dk, ntaps, q.C, q.B * q.nth * q.ntw);
  return cudaGetLastError();
}

}  // namespace

// dk's partial sums: the wrapper allocates a (parts, taps, C) float32 buffer.
extern "C" int x3d_dw_conv3d_dk_parts(int B, int Ho, int Wo, int sh, int sw) {
  BwdGeom q{};
  q.B = B, q.Ho = Ho, q.Wo = Wo, q.sh = sh, q.sw = sw;
  q = dk_geometry(q);
  return B * q.nth * q.ntw;
}

// g: (B, To, Ho, Wo, C) and dx: (B, T, H, W, C) in `dtype` (0 float32,
// 1 bfloat16); taps: (kt*kh*kw, C) float32.  Returns a cudaError_t code.
extern "C" int x3d_dw_conv3d_dx(const void* g, const void* taps, void* dx,
                                int dtype, int B, int T, int H, int W, int C,
                                int kt, int kh, int kw, int st, int sh, int sw,
                                int tlo, int hlo, int wlo, int To, int Ho,
                                int Wo, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  BwdGeom q = geometry(B, T, H, W, C, kt, kh, kw, st, sh, sw, tlo, hlo, wlo,
                       To, Ho, Wo);
  if (!valid(q)) return cudaErrorInvalidValue;
  q = dx_geometry(q);
  auto s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(taps);
  if (dtype == kF32) return launch_dx<float>(g, w, dx, q, s);
  if (dtype == kBF16) return launch_dx<__nv_bfloat16>(g, w, dx, q, s);
  return cudaErrorInvalidValue;
}

// x: (B, T, H, W, C) and g: (B, To, Ho, Wo, C) in `dtype`; part: (parts,
// taps, C) float32 scratch; dk: (taps, C) float32.  Returns a cudaError_t.
extern "C" int x3d_dw_conv3d_dk(const void* x, const void* g, void* part,
                                void* dk, int dtype, int B, int T, int H,
                                int W, int C, int kt, int kh, int kw, int st,
                                int sh, int sw, int tlo, int hlo, int wlo,
                                int To, int Ho, int Wo, void* stream) {
  if (C <= 0 || kt <= 0 || kh <= 0 || kw <= 0) return cudaSuccess;
  BwdGeom q = geometry(B, T, H, W, C, kt, kh, kw, st, sh, sw, tlo, hlo, wlo,
                       To, Ho, Wo);
  if (!valid(q) || B <= 0 || To <= 0 || Ho <= 0 || Wo <= 0)
    return cudaErrorInvalidValue;
  q = dk_geometry(q);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* ptr) { return static_cast<float*>(ptr); };
  if (dtype == kF32) return launch_dk<float>(x, g, f(part), f(dk), q, s);
  if (dtype == kBF16) return launch_dk<__nv_bfloat16>(x, g, f(part), f(dk), q, s);
  return cudaErrorInvalidValue;
}
