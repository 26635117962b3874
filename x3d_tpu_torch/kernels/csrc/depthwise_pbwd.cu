// K8: the one-pass backward of a stride-1, SAME, odd-tap depthwise 3-D conv
// on NDHWC activations -- both gradients from one stream over (u, gy):
//
//   du[b, t, h, w, c]  = sum_taps gy[b, t + lo_t - dt, h + lo_h - dh,
//                                    w + lo_w - dw, c] * k[dt, dh, dw, c]
//                        (= conv(gy, flip(k)), summed in f32, in u's dtype)
//   dk[dt, dh, dw, c]  = sum_{b, t, h, w} u[b, t + dt - lo_t, h + dh - lo_h,
//                                           w + dw - lo_w, c] * gy[b, t, h, w, c]
//                        (f32; u and gy are zero outside the image)
//
// Replaces the TPU kernel dw_fused._pbwd_kernel (x3d_tpu/ops/dw_fused.py:418,
// launched by _run_pbwd at :485).  K4 (depthwise_bwd.cu) computes the same two
// gradients in two kernels and for any stride and pads; this one serves the
// stride-1 SAME sites (the stem's k x 1 x 1 temporal conv).
//
// What bounds it on an H100: bytes -- u and gy read, du written (6 bytes per
// element in bf16; K4's pair moves 10) for 2 x taps FMAs per element.  The
// design is K3's (dw_fused_bwd.cu) without the BN and ReLU terms, and with a
// rolling window in time:
//   * a block owns one 8x8 pixel tile of one clip and 32 channels (threads
//     along the contiguous C) and walks over the clip's frames;
//   * the (8+kh-1) x (8+kw-1) halos of u and gy of the kt frames around the
//     current one live in a ring of kt slots in shared memory (as f32, zero
//     outside the image): each frame stages one new plane of each, so device
//     memory is read once per halo element, not kt times;
//   * du comes from the gy ring with flipped taps; each warp owns every 8th
//     tap of dk and keeps its sums in shared memory across the frames;
//   * each block writes one f32 partial per (tap, channel); a second kernel
//     sums them in a fixed order, in double: deterministic, no atomics.
// Not yet done (later work): cp.async/TMA staging, bf16 storage of the ring.

#include "common.cuh"

namespace {

using namespace x3d;

constexpr int kTile = 8;  // rows and columns per block

struct Geom {
  int B, T, H, W, C;
  int kt, kh, kw;
  int HR, WR;          // halo tile: kTile + kh - 1 rows, kTile + kw - 1 columns
  int nth, ntw, nct;   // tiles along H, W, C
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dw_conv3d_pbwd_kernel(const T* __restrict__ u, const T* __restrict__ gy,
                          const float* __restrict__ taps, T* __restrict__ du,
                          float* __restrict__ part_dk, Geom q) {
  extern __shared__ float smem[];
  const int ntaps = q.kt * q.kh * q.kw;
  const int plane = q.HR * q.WR * kChannels;
  float* ut = smem;                        // [kt slots][HR][WR][32] u
  float* gt = ut + (size_t)q.kt * plane;   // [kt slots][HR][WR][32] gy
  float* wf = gt + (size_t)q.kt * plane;   // [taps][32] flipped taps
  float* dk = wf + (size_t)ntaps * kChannels;  // [taps][32] dk sums

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int ct = bx / q.nth;
  const int b = blockIdx.y;
  const int c0 = ct * kChannels;
  const int h0 = th * kTile, w0 = tw * kTile;
  const int lo_t = q.kt / 2, lo_h = q.kh / 2, lo_w = q.kw / 2;
  const int hi0 = h0 - lo_h, wi0 = w0 - lo_w;
  const int lane = threadIdx.x % kChannels;
  const int warp = threadIdx.x / kChannels;
  const int c = c0 + lane;

  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int cc = c0 + i % kChannels;
    // flipped taps: wf[tap] = k[ntaps - 1 - tap]
    wf[i] = cc < q.C ? taps[(size_t)(ntaps - 1 - i / kChannels) * q.C + cc] : 0.f;
    dk[i] = 0.f;
  }

  // frame ti of u and gy (zeros where ti is outside the clip) goes to ring
  // slot (ti + lo_t) % kt; ti >= -lo_t, so the slot is never negative
  auto stage = [&](int ti) {
    const int slot = (ti + lo_t) % q.kt;
    float* us = ut + (size_t)slot * plane;
    float* gs = gt + (size_t)slot * plane;
    const bool inside = ti >= 0 && ti < q.T;
    for (int i = threadIdx.x; i < plane; i += blockDim.x) {
      const int cc = c0 + i % kChannels;
      const int r = i / kChannels;
      const int wi = wi0 + r % q.WR;
      const int hi = hi0 + r / q.WR;
      float uv = 0.f, gv = 0.f;
      if (inside && cc < q.C && hi >= 0 && hi < q.H && wi >= 0 && wi < q.W) {
        const size_t at =
            (((size_t)(b * q.T + ti) * q.H + hi) * q.W + wi) * q.C + cc;
        uv = to_f32(u[at]);
        gv = to_f32(gy[at]);
      }
      us[i] = uv;
      gs[i] = gv;
    }
  };

  for (int ti = -lo_t; ti < lo_t; ++ti) stage(ti);

  for (int t = 0; t < q.T; ++t) {
    // the slot this overwrites held frame t - 1 - lo_t, which frame t - 1
    // was the last to read (and the barrier below closed that frame)
    stage(t + lo_t);
    __syncthreads();
    // tap dt reads frame t - lo_t + dt: ring slot (t + dt) % kt
    if (c < q.C) {
      for (int p = warp; p < kTile * kTile; p += kWarps) {
        const int oh = p / kTile, ow = p % kTile;
        const int h = h0 + oh, w = w0 + ow;
        if (h >= q.H || w >= q.W) continue;
        float acc = 0.f;
        for (int dt = 0; dt < q.kt; ++dt) {
          const float* gp = gt + (size_t)((t + dt) % q.kt) * plane;
          for (int dh = 0; dh < q.kh; ++dh) {
            const float* row = gp + ((oh + dh) * q.WR + ow) * kChannels + lane;
            const float* wp = wf + (dt * q.kh + dh) * q.kw * kChannels + lane;
            for (int dw = 0; dw < q.kw; ++dw)
              acc = fmaf(row[dw * kChannels], wp[dw * kChannels], acc);
          }
        }
        du[(((size_t)(b * q.T + t) * q.H + h) * q.W + w) * q.C + c] =
            from_f32<T>(acc);
      }
    }
    // dk[tap] += sum over the tile of u shifted by the tap times gy at the
    // centre (gy is staged as zero outside the image)
    const float* gc = gt + (size_t)((t + lo_t) % q.kt) * plane +
                      (lo_h * q.WR + lo_w) * kChannels + lane;
    for (int tap = warp; tap < ntaps; tap += kWarps) {
      const int dt = tap / (q.kh * q.kw);
      const int dh = (tap / q.kw) % q.kh;
      const int dw = tap % q.kw;
      const float* up = ut + (size_t)((t + dt) % q.kt) * plane + lane;
      float s = 0.f;
      for (int oh = 0; oh < kTile; ++oh) {
        const float* urow = up + ((oh + dh) * q.WR + dw) * kChannels;
        const float* grow = gc + oh * q.WR * kChannels;
        for (int ow = 0; ow < kTile; ++ow)
          s = fmaf(urow[ow * kChannels], grow[ow * kChannels], s);
      }
      dk[tap * kChannels + lane] += s;
    }
    __syncthreads();
  }

  const size_t slot = ((size_t)b * q.nth + th) * q.ntw + tw;
  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int cc = c0 + i % kChannels;
    if (cc < q.C) part_dk[(slot * ntaps + i / kChannels) * q.C + cc] = dk[i];
  }
}

// dk: (taps, C).  One thread per (tap, channel), channels fastest; each sums
// its nparts partials in order, in double.
__global__ void sum_pbwd_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ dk, int ntaps,
                                       int C, int nparts) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= ntaps * C) return;
  double s = 0.0;
  for (int k = 0; k < nparts; ++k) s += part[(size_t)k * ntaps * C + i];
  dk[i] = (float)s;
}

Geom geometry(int B, int T, int H, int W, int C, int kt, int kh, int kw) {
  Geom q{B, T, H, W, C, kt, kh, kw};
  q.HR = kTile + kh - 1;
  q.WR = kTile + kw - 1;
  q.nth = ceil_div(H, kTile);
  q.ntw = ceil_div(W, kTile);
  q.nct = ceil_div(C, kChannels);
  return q;
}

template <typename T>
int launch(const void* u, const void* gy, const float* taps, void* du,
           float* part_dk, float* dk, const Geom& q, cudaStream_t stream) {
  const int ntaps = q.kt * q.kh * q.kw;
  const size_t smem = (2 * (size_t)q.kt * q.HR * q.WR + 2 * (size_t)ntaps) *
                      kChannels * sizeof(float);
  cudaError_t err = allow_smem(dw_conv3d_pbwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q.nct * q.nth * q.ntw, q.B);
  dw_conv3d_pbwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(gy), taps,
      static_cast<T*>(du), part_dk, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = ntaps * q.C;
  sum_pbwd_partials_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(
      part_dk, dk, ntaps, q.C, q.B * q.nth * q.ntw);
  return cudaGetLastError();
}

}  // namespace

// Pixel tiles per frame: the wrapper allocates a (B, tiles, taps, C) float32
// buffer for the partial sums.
extern "C" int x3d_dw_conv3d_pbwd_tiles(int H, int W) {
  return ceil_div(H, kTile) * ceil_div(W, kTile);
}

// u, gy, du: (B, T, H, W, C) in `dtype` (0 float32, 1 bfloat16); taps:
// (kt*kh*kw, C) float32 (the forward's taps, unflipped); dk: (taps, C)
// float32; part_dk: scratch as above.  Returns a cudaError_t code.
extern "C" int x3d_dw_conv3d_pbwd(const void* u, const void* gy,
                                  const void* taps, void* du, void* part_dk,
                                  void* dk, int dtype, int B, int T, int H,
                                  int W, int C, int kt, int kh, int kw,
                                  void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (kt <= 0 || kh <= 0 || kw <= 0 || kt % 2 == 0 || kh % 2 == 0 ||
      kw % 2 == 0 || B > 65535)
    return cudaErrorInvalidValue;
  const Geom q = geometry(B, T, H, W, C, kt, kh, kw);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  if (dtype == kF32)
    return launch<float>(u, gy, f(taps), du, m(part_dk), m(dk), q, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(u, gy, f(taps), du, m(part_dk), m(dk), q, s);
  return cudaErrorInvalidValue;
}
