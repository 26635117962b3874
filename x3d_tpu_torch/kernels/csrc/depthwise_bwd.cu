// K4: the depthwise 3-D convolution's backward on NDHWC activations, for any
// taps, strides and explicit (lo, hi) pads -- the gradient of K1
// (depthwise.cu).  Four bodies, two for dx and two for dk:
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
// stride 1 SAME only, streaming each x window once into a VMEM ring and
// carrying the dk sums across the grid; the stem's 5x1x1 conv and the
// stride-2 stage entries were left to XLA.
//
// What bounds it on an H100: bytes, as for K1 -- 27 FMAs per element against
// 4 bytes (dx: g read, dx written) or 4 bytes (dk: x and g read) per element
// in bf16.  The design:
//   * dx, phase body (x3d_dw_conv3d_dx_phase): the stride-2 stage entries --
//     spatial taps 3x3 at spatial stride 2, temporal stride 1, kt up to
//     kPhaseMaxKt, low-side pads of 0 or 1 in H and W.  In virtual rows
//     v = hi + hlo an output row ho reaches v = 2 ho + dh, so an even v
//     takes dh = 0 from g row v/2 and dh = 2 from row v/2 - 1, an odd v
//     takes dh = 1 from row (v-1)/2, and columns likewise.  A thread owns a
//     quad (virtual rows 2I, 2I+1, columns 2J, 2J+1) times a vector of VE
//     channels, which needs g rows I-1, I and columns J-1, J of each frame:
//     9 multiply-adds a frame and channel for 4 outputs, fixed taps (held in
//     registers, loaded once a block) and no division.  A block owns a tile
//     of quads, a channel group and a clip, and walks a run of frames; the
//     g planes the frame needs sit in a shared-memory ring of
//     kt + kPhaseAhead planes, filled with cp.async kPhaseAhead planes ahead
//     (granule 16, 8 or 4 bytes, picked at launch from C and g's address),
//     so each g plane is read once per block, not kt times;
//   * dx, gather body (x3d_dw_conv3d_dx): every other geometry.  A block owns
//     one input frame of one clip, an 8x8 pixel tile and 32 channels
//     (threads along the contiguous C); it stages the g planes, rows and
//     columns that reach the tile in shared memory (out-of-range ones as
//     zero) and each thread sums its taps in f32;
//   * dk, ring body (x3d_dw_conv3d_dk_ring): under K1's ring-body conditions
//     (spatial taps 3x3, temporal stride 1, spatial stride S = 1 or 2, kt <=
//     kRingMaxKt, low pads tlo <= kt - 1 and 0 or 1 in H and W: the four
//     stride-2 stage entries).  K1's ring staging and walk (common.cuh's
//     ConvRingFill, conv_ring_walk): a block owns one clip, an output tile, a
//     group of channel vectors (VE = 2 channels, 1 at odd C) and a run of
//     frames, and each x plane of its tile and halo enters a ring of
//     kt + kRingAhead slots once, by cp.async.  Thread (cv, r) owns vector
//     cv and output row r of the tile; for each frame it loads its row's g
//     cells straight from device memory into registers (each is read by this
//     thread alone, once) and, in runs of four pixels then pairs, adds x cell
//     times g into kt * 9 * VE sums held in registers (54 at bf16, VE 2, kt
//     3, as K3's dk role holds them), reading the staged cells as K1's ring
//     body reads them for the same output.  At the block's end the thread
//     rows' sums go through shared memory (the ring's bytes) and are added
//     over the rows in a fixed order into one f32 partial per (tap, channel)
//     of the block; partials are (clip, tile, run) rows of a (parts, taps,
//     C) buffer, and the second pass (common.cuh's sum_columns) sums each
//     column in kSumLanes fixed chunks in double: deterministic, no atomics;
//   * dk, generic body (x3d_dw_conv3d_dk): every other geometry (the XS
//     stem's 5x1x1 conv at 4 frames, which K8 does not take).  A block owns
//     one output tile of one clip and 32 channels and walks over all output
//     frames, staging the x halo and the g tile of each in shared memory;
//     each warp owns every 8th tap and keeps its sums in shared memory; a
//     second kernel sums the per-block partials in a fixed order, in double.
// Not yet done (later work): in the dk ring body, as in K1's, the fill does
// not overlap the multiply-adds (one barrier a plane, 4-byte copies); the
// gather body and the generic dk body stage with scalar loads and without
// a rolling temporal window; one pass for dx and dk together (ROADMAP B5's
// kernel).

#include <algorithm>
#include <cstdint>
#include <initializer_list>

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

// ------------------------------------------------------- dx, phase body

constexpr int kPhaseMaxKt = 5;    // temporal taps the phase body takes
constexpr int kPhaseAhead = 2;    // g planes in flight beyond the frame
constexpr int kPhaseMaxQ = 8;     // tile side, in quads
constexpr int kPhaseMaxVecs = 32; // channel vectors a block owns

struct PhaseGeom {
  int B, T, H, W, C;
  int tlo, hlo, wlo;  // low-side pads
  int To, Ho, Wo;     // g
  int nqh, nqw;       // quads along H and W: ceil((H + hlo) / 2), ...
  int QH, QW;         // a block's tile, in quads
  int nth, ntw;       // tiles along H and W
  int CG;             // channels a block owns
  int TC;             // frames a block walks
  int granule;        // bytes a copy moves: 16, 8, 4, or 2 (plain loads)
  int plane;          // elements of one ring slot
};

// Registers: KT * 9 * VE taps, so a block of up to 256 threads keeps two
// blocks an SM where they fit in 128 registers.
template <typename T, int VE, int KT>
__global__ void __launch_bounds__(kPhaseMaxVecs* kPhaseMaxQ,
                                  KT * 9 * VE <= 64 ? 2 : 1)
    dw_conv3d_dx_phase_kernel(const T* __restrict__ g,
                              const float* __restrict__ taps,
                              T* __restrict__ dx, PhaseGeom q) {
  constexpr int R = KT + kPhaseAhead;  // ring slots
  extern __shared__ __align__(16) unsigned char phase_smem[];
  T* ring = reinterpret_cast<T*>(phase_smem);  // [R][QH+1][QW+1][CG]

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int c0 = bx / q.nth * q.CG;
  const int t0 = blockIdx.y * q.TC, t1 = min(t0 + q.TC, q.T);
  const int b = blockIdx.z;
  const int I0 = th * q.QH, J0 = tw * q.QW;  // the tile's first quad
  const int cols = q.QW + 1;                 // staged g columns J0-1 .. J0+QW-1
  const int nv = q.CG / VE;
  const int cv = threadIdx.x % nv, qi = threadIdx.x / nv;
  const int c = c0 + cv * VE;

  float k[KT][9][VE];
#pragma unroll
  for (int dt = 0; dt < KT; ++dt)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        k[dt][j][e] = c + e < q.C ? taps[(size_t)(dt * 9 + j) * q.C + c + e] : 0.f;

  // One g plane into its ring slot: rows I0-1 .. I0+QH-1, columns J0-1 ..
  // J0+QW-1 and the group's channels, zeros outside g.  Each thread copies
  // granule gi of pixels p0, p0 + pstep, ...
  const int gpp = q.CG * (int)sizeof(T) / q.granule;  // granules a pixel
  const int gi = threadIdx.x % gpp, p0 = threadIdx.x / gpp;
  const int pstep = blockDim.x / gpp, npix = (q.QH + 1) * cols;
  const int ch = c0 + gi * (q.granule / (int)sizeof(T));
  const int pr0 = p0 / cols, pc0 = p0 % cols;
  const int srow = pstep / cols, scol = pstep % cols;
  auto fetch = [&](int to) {
    if (p0 >= pstep) return;  // threads past the last whole step
    unsigned char* dst = reinterpret_cast<unsigned char*>(
        ring + (size_t)(to % R) * q.plane) + gi * q.granule;
    const T* src = g + (size_t)(b * q.To + to) * q.Ho * q.Wo * q.C + ch;
    int pr = pr0, pc = pc0;
    for (int p = p0; p < npix; p += pstep) {
      const int ho = I0 - 1 + pr, wo = J0 - 1 + pc;
      const bool ok = ch < q.C && ho >= 0 && ho < q.Ho && wo >= 0 && wo < q.Wo;
      const T* from = ok ? src + ((size_t)ho * q.Wo + wo) * q.C : g;
      void* to_smem = dst + (size_t)p * q.CG * sizeof(T);
      switch (q.granule) {
        case 16: cp_async<16>(to_smem, from, ok); break;
        case 8: cp_async<8>(to_smem, from, ok); break;
        case 4: cp_async<4>(to_smem, from, ok); break;
        default: *static_cast<T*>(to_smem) = ok ? *from : from_f32<T>(0.f);
      }
      pr += srow, pc += scol;
      if (pc >= cols) pc -= cols, ++pr;
    }
  };

  // the planes this run of frames reads: to = ti + tlo - dt.  Group 0
  // holds the planes frame t0 reads, group j the plane t0 + tlo + j (which
  // frame t0 + j adds), so that kPhaseAhead - 1 groups follow frame ti's
  // last plane when the loop waits for it
  const int p_lo = max(0, t0 + q.tlo - (KT - 1));
  const int p_hi = min(q.To - 1, t1 - 1 + q.tlo);
  for (int to = p_lo; to <= min(p_hi, t0 + q.tlo); ++to) fetch(to);
  cp_async_commit();
  for (int j = 1; j < kPhaseAhead; ++j) {
    if (t0 + q.tlo + j <= p_hi) fetch(t0 + q.tlo + j);
    cp_async_commit();
  }

  const int I = I0 + qi;
  const bool owner = I < q.nqh && c < q.C;
  for (int ti = t0; ti < t1; ++ti) {
    // frame ti's planes have landed, and every thread is done with frame
    // ti-1, whose oldest plane's slot the next copy fills
    cp_async_wait<kPhaseAhead - 1>();
    __syncthreads();
    if (ti + q.tlo + kPhaseAhead <= p_hi) fetch(ti + q.tlo + kPhaseAhead);
    cp_async_commit();  // an empty group past the end keeps the count
    if (!owner) continue;
    T* out = dx + (size_t)(b * q.T + ti) * q.H * q.W * q.C + c;
    for (int qj = 0; qj < q.QW && J0 + qj < q.nqw; ++qj) {
      // acc[2 * (v odd) + (u odd)]: the quad's outputs
      float acc[4][VE] = {};
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        const int to = ti + q.tlo - dt;
        if (to < 0 || to >= q.To) continue;
        // the 2x2 patch: rows a = I-1, b = I; columns 0 = J-1, 1 = J
        const T* p = ring + (size_t)(to % R) * q.plane +
                     ((size_t)qi * cols + qj) * q.CG + cv * VE;
        float a0[VE], a1[VE], b0[VE], b1[VE];
        load_f32(p, a0);
        load_f32(p + q.CG, a1);
        load_f32(p + (size_t)cols * q.CG, b0);
        load_f32(p + (size_t)(cols + 1) * q.CG, b1);
        const float(&w)[9][VE] = k[dt];  // w[3 * dh + dw]
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          acc[0][e] = fmaf(w[0][e], b1[e], acc[0][e]);
          acc[0][e] = fmaf(w[2][e], b0[e], acc[0][e]);
          acc[0][e] = fmaf(w[6][e], a1[e], acc[0][e]);
          acc[0][e] = fmaf(w[8][e], a0[e], acc[0][e]);
          acc[1][e] = fmaf(w[1][e], b1[e], acc[1][e]);
          acc[1][e] = fmaf(w[7][e], a1[e], acc[1][e]);
          acc[2][e] = fmaf(w[3][e], b1[e], acc[2][e]);
          acc[2][e] = fmaf(w[5][e], b0[e], acc[2][e]);
          acc[3][e] = fmaf(w[4][e], b1[e], acc[3][e]);
        }
      }
      const int J = J0 + qj;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        const int hi = 2 * I + (o >> 1) - q.hlo, wi = 2 * J + (o & 1) - q.wlo;
        if (hi >= 0 && hi < q.H && wi >= 0 && wi < q.W)
          store_f32(out + ((size_t)hi * q.W + wi) * q.C, acc[o]);
      }
    }
  }
}

// The tile side (in quads) for n quads: n itself up to kPhaseMaxQ, else the
// side in 4 .. kPhaseMaxQ that leaves the fewest idle quads (the larger on a
// tie).
int phase_tile(int n) {
  if (n <= kPhaseMaxQ) return n;
  int best = kPhaseMaxQ;
  for (int s = kPhaseMaxQ - 1; s >= 4; --s)
    if (ceil_div(n, s) * s < ceil_div(n, best) * best) best = s;
  return best;
}

template <typename T, int VE, int KT>
int launch_phase(const void* g, const float* taps, void* dx, PhaseGeom q,
                 cudaStream_t stream) {
  auto kernel = dw_conv3d_dx_phase_kernel<T, VE, KT>;
  // a thread row per tile row of quads, at least two, so that a plane's
  // copies (up to 2 * CG / VE granules a pixel) have a thread each
  const int threads = q.CG / VE * std::max(q.QH, 2);
  const size_t smem = (size_t)(KT + kPhaseAhead) * q.plane * sizeof(T);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  // Split T into runs of frames (each reloads its first kt-1 planes) while
  // the blocks would not fill the card twice over, keeping runs of >= 4.
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const long blocks = (long)ceil_div(q.C, q.CG) * q.nth * q.ntw * q.B;
  const long fill = 2L * per_sm * sm_count();
  int runs = 1;
  while (blocks * runs < fill && ceil_div(q.T, runs + 1) >= 4) ++runs;
  q.TC = ceil_div(q.T, runs);
  const dim3 grid(ceil_div(q.C, q.CG) * q.nth * q.ntw, ceil_div(q.T, q.TC),
                  q.B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(g), taps,
                                          static_cast<T*>(dx), q);
  return cudaGetLastError();
}

template <typename T, int VE>
int launch_phase_kt(int kt, const void* g, const float* taps, void* dx,
                    const PhaseGeom& q, cudaStream_t s) {
  switch (kt) {
    case 1: return launch_phase<T, VE, 1>(g, taps, dx, q, s);
    case 2: return launch_phase<T, VE, 2>(g, taps, dx, q, s);
    case 3: return launch_phase<T, VE, 3>(g, taps, dx, q, s);
    case 4: return launch_phase<T, VE, 4>(g, taps, dx, q, s);
    case 5: return launch_phase<T, VE, 5>(g, taps, dx, q, s);
  }
  return cudaErrorInvalidValue;
}
static_assert(kPhaseMaxKt == 5, "launch_phase_kt covers kt 1 .. 5");

// The launch plan of a phase-body call, for elements of `elem` bytes and g
// at address `g`: the copy granule from C's row bytes and g's alignment, the
// channel groups (a multiple of the granule and of the vector, at most
// kPhaseMaxVecs vectors, as even as they come), the tile.
PhaseGeom phase_geometry(int B, int T, int H, int W, int C, int tlo, int hlo,
                         int wlo, int To, int Ho, int Wo, int elem,
                         const void* g, int ve) {
  PhaseGeom q{B, T, H, W, C, tlo, hlo, wlo, To, Ho, Wo};
  q.nqh = (H + hlo + 1) / 2;
  q.nqw = (W + wlo + 1) / 2;
  q.QH = phase_tile(q.nqh);
  q.QW = phase_tile(q.nqw);
  q.nth = ceil_div(q.nqh, q.QH);
  q.ntw = ceil_div(q.nqw, q.QW);
  q.granule = elem;
  for (int G : {16, 8, 4})
    if (G >= elem && (size_t)C * elem % G == 0 &&
        reinterpret_cast<uintptr_t>(g) % G == 0) {
      q.granule = G;
      break;
    }
  const int unit = std::max(q.granule / elem, ve);
  const int most = kPhaseMaxVecs * ve;
  for (int groups = ceil_div(C, most);; ++groups) {
    q.CG = ceil_div(ceil_div(C, groups), unit) * unit;
    if (q.CG <= most) break;
  }
  const int bytes = (q.QH + 1) * (q.QW + 1) * q.CG * elem;
  q.plane = ceil_div(bytes, 16) * 16 / elem;
  return q;
}

// ----------------------------------------------------------- dk, ring body

// Dynamic shared memory of a dk ring-body block: KT + kRingAhead slots of x,
// whose bytes the thread rows' dk sums reuse after the frames.
size_t dk_ring_smem(const RingGeom& q, int elem, int kt, int ve) {
  const size_t ring = (size_t)(kt + kRingAhead) * q.slot * ve * elem;
  const size_t red = (size_t)q.rows * 9 * kt * q.CG * sizeof(float);
  return (std::max(ring, red) + 15) / 16 * 16;
}

// Registers: at most 128 a thread, so that four blocks of 128 threads (the
// plan's most) share an SM.  g_cells: g's address allows a cell's VE
// channels to move as one load.
template <typename T, int VE, int KT, int S>
__global__ void __launch_bounds__(kRingMaxThreads, 4)
    dw_conv3d_dk_ring_kernel(const T* __restrict__ x, const T* __restrict__ g,
                             float* __restrict__ part, ConvRing cr,
                             bool g_cells) {
  using Cell = typename CellOf<T, VE>::type;
  const RingGeom& q = cr.q;
  constexpr int NT = KT * 9;
  constexpr int SL = KT + kRingAhead;  // ring slots
  extern __shared__ __align__(16) unsigned char dk_ring_smem_[];
  Cell* ring = reinterpret_cast<Cell*>(dk_ring_smem_);  // [SL][slot]
  float* red = reinterpret_cast<float*>(dk_ring_smem_);  // [rows][NT][CG]

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int c0 = bx / q.nth * q.CG;
  const int run = blockIdx.y;
  const int t0 = run * q.TC, t1 = min(t0 + q.TC, q.T);
  const int b = blockIdx.z;
  const int h0 = th * q.TH, w0 = tw * q.TW;  // the output tile's origin
  const int hi0 = h0 * S - cr.hlo, wi0 = w0 * S - cr.wlo;  // staged origin
  // thread (cv, r): vector cv of the group at tile rows r, r + rows, ...
  const int nv = q.CG / VE;
  const bool active = threadIdx.x < nv * q.rows;
  const int cv = threadIdx.x % nv, r = threadIdx.x / nv;
  const int c = c0 + cv * VE;
  const bool live = active && c < q.C;  // at VE 2, C is even: c + 1 < C
  const int vplane = cv * q.VP;  // the thread's vector plane in a slot
  const size_t in_frame = (size_t)cr.H * cr.W * q.C;
  const size_t out_frame = (size_t)q.H * q.W * q.C;

  // the thread's dk sums, dk[dt][3 dh + dw]
  float dk[KT][9][VE] = {};

  // Input plane p into slot p % SL (common.cuh's ConvRingFill, K1's).
  const ConvRingFill<T, VE, S> fill(cr, hi0, wi0, vplane, r, live);
  auto fetch = [&](int p) {
    if (active)
      fill(ring + (p % SL) * q.slot, x,
           (size_t)(b * cr.T + p) * in_frame + c);
  };

  // Output frame t along rows r, r + rows, ...: runs of N = 4 pixels, then
  // pairs for the rest of the row, as K1's ring body walks them.  A run
  // loads its pixels' g cells from device memory (each is read by this
  // thread alone, once) and reads S (N - 1) + 3 consecutive staged cells of
  // each staged row it needs; cell j times pixel k's g adds into tap
  // dw = j - S k.
  auto compute = [&](int t) {
    const T* gf = g + (size_t)(b * q.T + t) * out_frame + c;
    int plane[KT];  // the slot of input plane t - tlo + dt, or -1 outside
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      const int tp = t - cr.tlo + dt;
      plane[dt] = tp >= 0 && tp < cr.T ? (tp % SL) * q.slot + vplane : -1;
    }
    const int cols = min(q.TW, q.W - w0);  // the tile's columns in the image
    // pixels ow .. ow + N - 1 of row oh, the first `valid` of them in g
    auto run_of = [&](auto n_tag, int oh, int ow, int valid) {
      constexpr int N = decltype(n_tag)::value;
      const T* px = gf + ((size_t)(h0 + oh) * q.W + w0 + ow) * q.C;
      float gv[N][VE];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (k < valid && g_cells) {
          load_f32(px + (size_t)k * q.C, gv[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VE; ++e)
            gv[k][e] = k < valid ? to_f32(px[(size_t)k * q.C + e]) : 0.f;
        }
      }
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        if (plane[dt] < 0) continue;  // x is zero there
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const Cell* row = ring + plane[dt] + (S * oh + dh) * q.WP + S * ow;
#pragma unroll
          for (int j = 0; j < S * (N - 1) + 3; ++j) {
            float v[VE];
            cell_f32<T>(row + j, v);
#pragma unroll
            for (int k = 0; k < N; ++k)
              if (j - S * k >= 0 && j - S * k < 3)
#pragma unroll
                for (int e = 0; e < VE; ++e) {
                  float& s = dk[dt][3 * dh + j - S * k][e];
                  s = fmaf(v[e], gv[k][e], s);
                }
          }
        }
      }
    };
    for (int oh = r; oh < q.TH && h0 + oh < q.H; oh += q.rows) {
      int ow = 0;
      for (; ow + 4 <= cols; ow += 4)
        run_of(std::integral_constant<int, 4>{}, oh, ow, 4);
      for (; ow < cols; ow += 2)
        run_of(std::integral_constant<int, 2>{}, oh, ow, min(2, cols - ow));
    }
  };

  conv_ring_walk<KT>(cr.T, cr.tlo, t0, t1, fetch, [&](int t) {
    if (live) compute(t);
  });

  // Each thread row's sums through shared memory (the ring's bytes, free
  // once every thread is past its last frame), added over the rows in
  // order into the block's partial: one per (tap, channel) of its group,
  // row (clip, tile, run) of the (parts, taps, C) buffer.
  __syncthreads();
  if (active) {
    float* mine = red + (size_t)r * NT * q.CG + cv * VE;
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        mine[(size_t)i * q.CG + e] = dk[i / 9][i % 9][e];
  }
  __syncthreads();
  const size_t slot = (((size_t)b * q.nth + th) * q.ntw + tw) * q.nruns + run;
  for (int i = threadIdx.x; i < NT * q.CG; i += blockDim.x) {
    const int cc = c0 + i % q.CG;
    if (cc >= q.C) continue;
    float s = 0.f;
    for (int rr = 0; rr < q.rows; ++rr) s += red[(size_t)rr * NT * q.CG + i];
    part[(slot * NT + i / q.CG) * q.C + cc] = s;
  }
}

// The second pass (common.cuh's sum_columns): dk (taps, C) from the
// (parts, taps, C) partials.
__global__ void __launch_bounds__(32 * kSumLanes)
    dw_conv3d_dk_sum_kernel(const float* __restrict__ part,
                            float* __restrict__ dk, int ncols, int nparts) {
  sum_columns(part, dk, ncols, nparts);
}

// Rows of the partials buffer a dk ring-body call writes: one per (clip,
// tile, run).
int dk_ring_parts(const RingGeom& q) { return q.B * q.nth * q.ntw * q.nruns; }

template <typename T, int VE, int KT, int S>
int launch_dk_ring(const void* x, const void* g, float* part, float* dk,
                   const ConvRing& cr, bool g_cells, cudaStream_t stream) {
  auto kernel = dw_conv3d_dk_ring_kernel<T, VE, KT, S>;
  const RingGeom& q = cr.q;
  const size_t smem = dk_ring_smem(q, sizeof(T), KT, VE);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = ceil_div(q.CG / VE * q.rows, 32) * 32;
  const dim3 grid(ceil_div(q.C, q.CG) * q.nth * q.ntw, q.nruns, q.B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(g), part, cr,
                                          g_cells);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncols = KT * 9 * q.C;
  dw_conv3d_dk_sum_kernel<<<ceil_div(ncols, 32), dim3(32, kSumLanes), 0,
                            stream>>>(part, dk, ncols, dk_ring_parts(q));
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

// dx by the phase body: the arguments of x3d_dw_conv3d_dx, for spatial taps
// 3x3 at spatial stride 2, temporal stride 1, kt in 1 .. 5 and low-side pads
// of 0 or 1 in H and W (cudaErrorInvalidValue otherwise).
extern "C" int x3d_dw_conv3d_dx_phase(const void* g, const void* taps,
                                      void* dx, int dtype, int B, int T, int H,
                                      int W, int C, int kt, int kh, int kw,
                                      int st, int sh, int sw, int tlo, int hlo,
                                      int wlo, int To, int Ho, int Wo,
                                      void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (kh != 3 || kw != 3 || st != 1 || sh != 2 || sw != 2 || kt < 1 ||
      kt > kPhaseMaxKt || hlo < 0 || hlo > 1 || wlo < 0 || wlo > 1 ||
      tlo < 0 || To <= 0 || Ho <= 0 || Wo <= 0 || T > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(taps);
  const int ve = C % 2 == 0 ? 2 : 1;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  const PhaseGeom q = phase_geometry(B, T, H, W, C, tlo, hlo, wlo, To, Ho, Wo,
                                     elem, g, ve);
  if (dtype == kF32)
    return ve == 2 ? launch_phase_kt<float, 2>(kt, g, w, dx, q, s)
                   : launch_phase_kt<float, 1>(kt, g, w, dx, q, s);
  return ve == 2 ? launch_phase_kt<__nv_bfloat16, 2>(kt, g, w, dx, q, s)
                 : launch_phase_kt<__nv_bfloat16, 1>(kt, g, w, dx, q, s);
}

// dk by the ring body: x, g, part, dk and the geometry as for
// x3d_dw_conv3d_dk, for spatial taps 3x3 at strides (1, s, s) with s 1 or 2,
// kt in 1 .. 5, low pads tlo <= kt - 1 and hlo, wlo 0 or 1; then the launch
// plan of ops/depthwise.dk_ring_plan (rows of the partials buffer, tile
// sides, channels a group, channels a vector, thread rows, frames a run,
// copy granule in bytes, cells a staged row, cells padding each vector
// plane).  part: (parts, kt * 9, C) float32 scratch.  cudaErrorInvalidValue
// for a geometry or plan the kernel cannot run, a partials count that is not
// the plan's, or an x the granule does not divide.
extern "C" int x3d_dw_conv3d_dk_ring(
    const void* x, const void* g, void* part, void* dk, int dtype, int B,
    int T, int H, int W, int C, int kt, int stride, int tlo, int hlo, int wlo,
    int To, int Ho, int Wo, int parts, int tile_h, int tile_w, int group,
    int vec, int rows, int run, int granule, int row_cells, int vec_pad,
    void* stream) {
  if (C <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  ConvRing cr{{B, To, Ho, Wo, C}, T, H, W, tlo, hlo, wlo};
  if (B <= 0 || To <= 0 || Ho <= 0 || Wo <= 0 || T <= 0 || H <= 0 ||
      W <= 0 || tlo < 0 || tlo > kt - 1 || hlo < 0 || hlo > 1 || wlo < 0 ||
      wlo > 1 ||
      !ring_geometry(cr.q, elem, kt, vec, tile_h, tile_w, group, rows, run,
                     granule, row_cells, vec_pad, stride) ||
      parts != dk_ring_parts(cr.q) ||
      reinterpret_cast<uintptr_t>(x) % granule)
    return cudaErrorInvalidValue;
  const bool g_cells = reinterpret_cast<uintptr_t>(g) % (vec * elem) == 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* ptr) { return static_cast<float*>(ptr); };
  return with_conv_ring(dtype, vec, kt, stride, [&](auto ring, auto st) {
    using R = decltype(ring);
    return launch_dk_ring<typename R::Elem, R::ve, R::kt,
                          decltype(st)::value>(x, g, f(part), f(dk), cr,
                                               g_cells, s);
  });
}
