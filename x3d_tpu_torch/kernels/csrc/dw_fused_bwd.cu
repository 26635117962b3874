// K3: the fused bottleneck segment's backward -- the gradient of K2
// (dw_fused.cu), in one pass over (x, y, gy):
//
//   u     = relu(a[c, b] * x + bb[c, b])              (rounded to x's dtype)
//   g     = (gy + gp[c, b]) + 2 gs2[c, b] * y         (rounded to x's dtype)
//   du    = depthwise_conv3d(g, flip(k))              (stride 1, SAME, f32)
//   dz    = du where u > 0, else 0
//   dx    = dz * a                                    (rounded to x's dtype)
//   dk[tap, c]  = sum_{b, t, h, w} u_shifted(tap) * g
//   dzs[c, b]   = sum_thw dz,   duu[c, b] = sum_thw dz * u
//
// The wrapper turns (dzs, duu) into the gradients of a and bb.  Replaces the
// TPU kernel dw_fused._bwd_kernel (x3d_tpu/ops/dw_fused.py:346, launched by
// _run_bwd at :634), with its arithmetic: u is recomputed from x (masked to
// zero outside the image after the affine, as in K2), g_eff is formed while
// it is loaded, and the three reductions come out of the same pass.
//
// What bounds it on an H100: bytes -- it reads x, y and gy and writes dx
// (8 bytes per element in bf16) for 2 x 27 FMAs (du and dk) per element.
// The design:
//   * a block owns one 8x8 pixel tile of one clip and 32 channels (threads
//     along the contiguous C) and walks over the clip's frames; for each it
//     stages the kt x (8+kh-1) x (8+kw-1) halos of u and of g in shared
//     memory, so neither goes to device memory;
//   * du and dx come from the g halo with flipped taps; each warp owns every
//     8th tap of dk and keeps its sums in shared memory across the frames;
//   * each block writes one f32 partial per (tap, channel) and per
//     (channel, clip); a second kernel sums them in a fixed order, in double:
//     deterministic, no atomics.
// The TPU kernel summed taps in the input dtype; this one sums in f32.

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
    dw_bn_act_conv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ y,
                              const T* __restrict__ gy,
                              const float* __restrict__ a_cb,
                              const float* __restrict__ b_cb,
                              const float* __restrict__ gp_cb,
                              const float* __restrict__ gs2_cb,
                              const float* __restrict__ taps,
                              T* __restrict__ dx, float* __restrict__ part_dk,
                              float* __restrict__ part_dzs,
                              float* __restrict__ part_duu, Geom q) {
  extern __shared__ float smem[];
  const int ntaps = q.kt * q.kh * q.kw;
  const size_t halo = (size_t)q.kt * q.HR * q.WR * kChannels;
  float* ut = smem;              // [kt][HR][WR][32] u
  float* gt = ut + halo;         // [kt][HR][WR][32] g
  float* wf = gt + halo;         // [taps][32] flipped taps
  float* dk = wf + (size_t)ntaps * kChannels;  // [taps][32] dk sums
  __shared__ float coef[4][kChannels];         // a, bb, gp, 2 gs2
  __shared__ float red_s[kWarps][kChannels], red_u[kWarps][kChannels];

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int ct = bx / q.nth;
  const int b = blockIdx.y;
  const int c0 = ct * kChannels;
  const int h0 = th * kTile, w0 = tw * kTile;
  const int hi0 = h0 - q.kh / 2, wi0 = w0 - q.kw / 2;
  const int lane = threadIdx.x % kChannels;
  const int warp = threadIdx.x / kChannels;
  const int c = c0 + lane;

  if (threadIdx.x < kChannels) {
    const bool ok = c < q.C;
    const size_t cb = (size_t)c * q.B + b;
    coef[0][lane] = ok ? a_cb[cb] : 0.f;
    coef[1][lane] = ok ? b_cb[cb] : 0.f;
    coef[2][lane] = ok ? gp_cb[cb] : 0.f;
    coef[3][lane] = ok ? 2.f * gs2_cb[cb] : 0.f;
  }
  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int cc = c0 + i % kChannels;
    // flipped taps: wf[tap] = k[ntaps - 1 - tap]
    wf[i] = cc < q.C ? taps[(size_t)(ntaps - 1 - i / kChannels) * q.C + cc] : 0.f;
    dk[i] = 0.f;
  }
  __syncthreads();

  float sum_dz = 0.f, sum_dzu = 0.f;
  for (int t = 0; t < q.T; ++t) {
    const int ti0 = t - q.kt / 2;
    const int n = q.kt * q.HR * q.WR * kChannels;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int l = i % kChannels;
      const int cc = c0 + l;
      int r = i / kChannels;
      const int wi = wi0 + r % q.WR;
      r /= q.WR;
      const int hi = hi0 + r % q.HR;
      const int ti = ti0 + r / q.HR;
      float u = 0.f, g = 0.f;
      if (cc < q.C && ti >= 0 && ti < q.T && hi >= 0 && hi < q.H && wi >= 0 &&
          wi < q.W) {
        const size_t at = (((size_t)(b * q.T + ti) * q.H + hi) * q.W + wi) * q.C + cc;
        // each multiply and add rounded: the plain version's arithmetic
        u = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(to_f32(x[at]), coef[0][l]),
                                        coef[1][l]), 0.f));
        g = round_to<T>(__fadd_rn(__fadd_rn(to_f32(gy[at]), coef[2][l]),
                                  __fmul_rn(coef[3][l], to_f32(y[at]))));
      }
      ut[i] = u;
      gt[i] = g;
    }
    __syncthreads();

    if (c < q.C) {
      for (int p = warp; p < kTile * kTile; p += kWarps) {
        const int oh = p / kTile, ow = p % kTile;
        const int h = h0 + oh, w = w0 + ow;
        if (h >= q.H || w >= q.W) continue;
        float du = 0.f;
        for (int dt = 0; dt < q.kt; ++dt)
          for (int dh = 0; dh < q.kh; ++dh) {
            const float* row =
                gt + (((size_t)dt * q.HR + oh + dh) * q.WR + ow) * kChannels + lane;
            const float* wp = wf + (dt * q.kh + dh) * q.kw * kChannels + lane;
            for (int dw = 0; dw < q.kw; ++dw)
              du = fmaf(row[dw * kChannels], wp[dw * kChannels], du);
          }
        const float uc = ut[(((size_t)(q.kt / 2) * q.HR + oh + q.kh / 2) * q.WR +
                             ow + q.kw / 2) * kChannels + lane];
        const float dz = uc > 0.f ? du : 0.f;
        dx[(((size_t)(b * q.T + t) * q.H + h) * q.W + w) * q.C + c] =
            from_f32<T>(__fmul_rn(dz, coef[0][lane]));
        sum_dz += dz;
        sum_dzu = fmaf(dz, uc, sum_dzu);
      }
    }
    // dk[tap] += sum over the tile of u shifted by the tap times g at the
    // centre (zero outside the image)
    for (int tap = warp; tap < ntaps; tap += kWarps) {
      const int dt = tap / (q.kh * q.kw);
      const int dh = (tap / q.kw) % q.kh;
      const int dw = tap % q.kw;
      float s = 0.f;
      for (int oh = 0; oh < kTile; ++oh) {
        const float* urow =
            ut + (((size_t)dt * q.HR + oh + dh) * q.WR + dw) * kChannels + lane;
        const float* grow =
            gt + (((size_t)(q.kt / 2) * q.HR + oh + q.kh / 2) * q.WR + q.kw / 2) *
                     kChannels + lane;
        for (int ow = 0; ow < kTile; ++ow)
          s = fmaf(urow[ow * kChannels], grow[ow * kChannels], s);
      }
      dk[tap * kChannels + lane] += s;
    }
    __syncthreads();
  }

  red_s[warp][lane] = sum_dz;
  red_u[warp][lane] = sum_dzu;
  __syncthreads();
  const size_t tile = (size_t)th * q.ntw + tw;
  const size_t ntiles = (size_t)q.nth * q.ntw;
  if (threadIdx.x < kChannels && c < q.C) {
    float s = 0.f, su = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      s += red_s[k][threadIdx.x];
      su += red_u[k][threadIdx.x];
    }
    const size_t slot = ((size_t)b * ntiles + tile) * q.C + c;
    part_dzs[slot] = s;
    part_duu[slot] = su;
  }
  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int cc = c0 + i % kChannels;
    if (cc < q.C)
      part_dk[(((size_t)b * ntiles + tile) * ntaps + i / kChannels) * q.C + cc] = dk[i];
  }
}

// dk (taps, C): one thread per (tap, channel) over the B * ntiles partials;
// dzs, duu (C, B): one thread per (channel, clip) over its ntiles partials.
// Each sums in a fixed order, in double.
__global__ void sum_partials_kernel(const float* __restrict__ part_dk,
                                    const float* __restrict__ part_dzs,
                                    const float* __restrict__ part_duu,
                                    float* __restrict__ dk,
                                    float* __restrict__ dzs,
                                    float* __restrict__ duu, int B, int C,
                                    int ntaps, int ntiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < ntaps * C) {
    double s = 0.0;
    for (int k = 0; k < B * ntiles; ++k) s += part_dk[(size_t)k * ntaps * C + i];
    dk[i] = (float)s;
  } else if (i < ntaps * C + B * C) {
    const int j = i - ntaps * C;
    const int c = j % C, b = j / C;
    const size_t base = (size_t)b * ntiles * C + c;
    double s = 0.0, su = 0.0;
    for (int k = 0; k < ntiles; ++k) {
      s += part_dzs[base + (size_t)k * C];
      su += part_duu[base + (size_t)k * C];
    }
    dzs[(size_t)c * B + b] = (float)s;
    duu[(size_t)c * B + b] = (float)su;
  }
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
int launch(const void* x, const void* y, const void* gy, const float* a_cb,
           const float* b_cb, const float* gp, const float* gs2,
           const float* taps, void* dx, float* part_dk, float* part_dzs,
           float* part_duu, float* dk, float* dzs, float* duu, const Geom& q,
           cudaStream_t stream) {
  const int ntaps = q.kt * q.kh * q.kw;
  const size_t smem = (2 * (size_t)q.kt * q.HR * q.WR + 2 * (size_t)ntaps) *
                      kChannels * sizeof(float);
  cudaError_t err = allow_smem(dw_bn_act_conv_bwd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(q.nct * q.nth * q.ntw, q.B);
  dw_bn_act_conv_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(gy), a_cb, b_cb, gp, gs2, taps,
      static_cast<T*>(dx), part_dk, part_dzs, part_duu, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = ntaps * q.C + q.B * q.C;
  sum_partials_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(
      part_dk, part_dzs, part_duu, dk, dzs, duu, q.B, q.C, ntaps,
      q.nth * q.ntw);
  return cudaGetLastError();
}

}  // namespace

// Pixel tiles per frame: the wrapper allocates (B, tiles, taps, C) and two
// (B, tiles, C) float32 buffers for the partial sums.
extern "C" int x3d_dw_bn_act_conv_bwd_tiles(int H, int W) {
  return ceil_div(H, kTile) * ceil_div(W, kTile);
}

// x, y, gy, dx: (B, T, H, W, C) in `dtype` (0 float32, 1 bfloat16); a_cb,
// b_cb, gp, gs2, dzs, duu: (C, B) float32; taps: (kt*kh*kw, C) float32 (the
// forward's taps, unflipped); dk: (taps, C) float32; part_*: scratch as
// above.  Returns a cudaError_t code.
extern "C" int x3d_dw_bn_act_conv_bwd(
    const void* x, const void* y, const void* gy, const void* a_cb,
    const void* b_cb, const void* gp, const void* gs2, const void* taps,
    void* dx, void* part_dk, void* part_dzs, void* part_duu, void* dk,
    void* dzs, void* duu, int dtype, int B, int T, int H, int W, int C, int kt,
    int kh, int kw, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (kt % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || B > 65535)
    return cudaErrorInvalidValue;
  const Geom q = geometry(B, T, H, W, C, kt, kh, kw);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  if (dtype == kF32)
    return launch<float>(x, y, gy, f(a_cb), f(b_cb), f(gp), f(gs2), f(taps),
                         dx, m(part_dk), m(part_dzs), m(part_duu), m(dk),
                         m(dzs), m(duu), q, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, y, gy, f(a_cb), f(b_cb), f(gp), f(gs2),
                                 f(taps), dx, m(part_dk), m(part_dzs),
                                 m(part_duu), m(dk), m(dzs), m(duu), q, s);
  return cudaErrorInvalidValue;
}
