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
// element in bf16; K4's pair moves 10), plus the dk partials, for 2 x taps
// FMAs per element.  Two bodies, picked by the wrapper (ops/depthwise.
// pbwd_body); every K8 launch of X3D takes the first:
//   * temporal body (x3d_dw_conv3d_pbwd_temporal): spatial taps 1x1, kt odd
//     and <= kRingMaxKt (the stem's conv_t).  No pixel shares an input with
//     another, so shared memory buys nothing on the way in: as in K1's
//     temporal body (depthwise.cu), a thread owns one cell of VE channels of
//     one pixel (8 or 4 bytes where C and the addresses allow, else one
//     element; common.cuh's Cell32) and walks a run of frames, reading each
//     frame of u and gy once with one vector load each (and kt - 1 halo
//     frames a run), neighbouring threads on neighbouring cells.  The frames
//     come in groups of KT loads issued together; the window of the KT
//     frames around the current one is this group's and the last group's
//     cells, kept packed and unpacked where used.  du[t] is the window of gy
//     times the flipped taps, stored as one vector; dk's KT x VE sums stay
//     in registers over the thread's pixels and frames.  A block is threads
//     (cell, pixel): its columns the cells of a channel group, its rows
//     pixels, so every thread of a column sums the same channels; a block
//     walks a fixed range of pixel rows, so that the partials stay few (a
//     partial a block of 42 pixels cost the second pass 9% of the kernel's
//     time at X3D-M).  At the end the rows' sums go through shared memory
//     and are added in order, in double, into one f32 partial per (tap,
//     channel) of the block; the second pass (common.cuh's sum_columns) adds
//     the partials in a fixed order: deterministic, no atomics;
//   * generic body (x3d_dw_conv3d_pbwd): every other geometry.  The design
//     is K3's (dw_fused_bwd.cu) without the BN and ReLU terms, and with a
//     rolling window in time: a block owns one 8x8 pixel tile of one clip
//     and 32 channels (threads along the contiguous C) and walks over the
//     clip's frames; the (8+kh-1) x (8+kw-1) halos of u and gy of the kt
//     frames around the current one live in a ring of kt slots in shared
//     memory (as f32, zero outside the image): each frame stages one new
//     plane of each, so device memory is read once per halo element, not kt
//     times; du comes from the gy ring with flipped taps; each warp owns
//     every 8th tap of dk and keeps its sums in shared memory across the
//     frames; each block writes one f32 partial per (tap, channel), and a
//     second kernel sums them in a fixed order, in double.  Not done: cp.
//     async/TMA staging, bf16 storage of the ring.

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


// ------------------------------------------------------- temporal body

constexpr int kPbwdThreads = 256;  // a temporal-body block's most threads
// The widest cell: 8 bytes (4 bf16 channels) measured faster than 16 at the
// X3D stems (114 registers against 192, two blocks an SM; PERF.md §6).
constexpr int kPbwdMaxCell = 8;

// A temporal-body call (its plan: ops/depthwise.pbwd_temporal_plan).  Pixels
// are counted flat over (clip, row, column) in groups of `pixels`; a block
// takes `walk` groups one after another, and its thread (col, row) owns cell
// col of the block's channel group of the row-th pixel of each, over a run
// of TC frames.
struct PbwdGeom {
  int T, C;
  int HW;          // pixels a frame
  long long N;     // pixels: B * HW
  int cells;       // cells a pixel: C / VE
  int group;       // cells a channel group: the block's columns
  int pixels;      // the block's rows
  int walk;        // pixel rows a block takes one after another
  int TC, nruns;   // frames a run, runs along T
  long long pblocks;  // blocks along the pixels
};

// Registers: at most 128 a thread, so that two blocks of 256 share an SM.
template <typename T, int VE, int KT>
__global__ void __launch_bounds__(kPbwdThreads, 2)
    dw_conv3d_pbwd_temporal_kernel(const T* __restrict__ u,
                                   const T* __restrict__ gy,
                                   const float* __restrict__ taps,
                                   T* __restrict__ du,
                                   float* __restrict__ part, PbwdGeom g) {
  constexpr int LO = KT / 2;
  extern __shared__ float pbwd_red[];  // [rows][KT][group * VE]
  const int col = threadIdx.x % g.group, row = threadIdx.x / g.group;
  const int cell = blockIdx.z * g.group + col;
  const bool live = cell < g.cells;
  const int c = (live ? cell : 0) * VE;
  const int t0 = blockIdx.y * g.TC, t1 = min(t0 + g.TC, g.T);
  const size_t frame = (size_t)g.HW * g.C;

  // flipped taps: du[t] = sum_i gy[t - LO + i] * k[KT - 1 - i]
  float wf[KT][VE];
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e)
      wf[i][e] = live ? taps[(size_t)(KT - 1 - i) * g.C + c + e] : 0.f;
  float dk[KT][VE] = {};

  // Input r of a run is frame t0 - LO + r; inputs m .. m + KT - 1 give
  // output m (frame t0 + m): du from gy's, and dk[i] += u[m + i] * gy[m +
  // LO].  Group r0 loads inputs r0 .. r0 + KT - 1 (cu, cg); the window of
  // output m = r0 + j - KT + 1 is inputs q = j + 1 + i - KT of this group
  // (q >= 0) or of the last (pu, pg).
  const int first = t0 - LO, n_in = t1 - t0 + KT - 1;
  for (int it = 0; it < g.walk; ++it) {
    const long long p =
        ((long long)blockIdx.x * g.walk + it) * g.pixels + row;
    if (!live || p >= g.N) break;
    const size_t at =
        ((size_t)(p / g.HW) * g.T * g.HW + (size_t)(p % g.HW)) * g.C + c;
    const T* up = u + at;
    const T* gp = gy + at;
    T* dp = du + at + (size_t)t0 * frame;
    Cell32<T, VE> pu[KT], pg[KT];
    for (int r0 = 0; r0 < n_in; r0 += KT) {
      Cell32<T, VE> cu[KT], cg[KT];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        const int ti = first + r0 + j;
        if (r0 + j < n_in && ti >= 0 && ti < g.T) {
          cu[j].load(up + (size_t)ti * frame);
          cg[j].load(gp + (size_t)ti * frame);
        } else {
          cu[j].zero();
          cg[j].zero();
        }
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        if (r0 + j >= n_in) break;
        const int m = r0 + j - (KT - 1);
        if (m < 0) continue;
        // input q of this group (q >= 0) or q + KT of the last
        auto in = [&](const Cell32<T, VE>(&cur)[KT],
                      const Cell32<T, VE>(&last)[KT],
                      int q) -> const Cell32<T, VE>& {
          return q >= 0 ? cur[q] : last[q + KT];
        };
        float gc[VE];
        in(cg, pg, j + 1 + LO - KT).unpack(gc);
        float acc[VE] = {};
#pragma unroll
        for (int i = 0; i < KT; ++i) {
          const int q = j + 1 + i - KT;
          float uv[VE], gv[VE];
          in(cu, pu, q).unpack(uv);
          in(cg, pg, q).unpack(gv);
#pragma unroll
          for (int e = 0; e < VE; ++e) {
            acc[e] = fmaf(gv[e], wf[i][e], acc[e]);
            dk[i][e] = fmaf(uv[e], gc[e], dk[i][e]);
          }
        }
        store_cell(dp + (size_t)m * frame, acc);
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) pu[j] = cu[j], pg[j] = cg[j];
    }
  }

  // The rows' sums through shared memory, added over the rows in order, in
  // double, into the block's partial: row (pixel block, run) of the (parts,
  // KT, C) buffer, the group's columns.
  const int width = g.group * VE;
  float* mine = pbwd_red + (size_t)row * KT * width + col * VE;
#pragma unroll
  for (int i = 0; i < KT; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) mine[i * width + e] = dk[i][e];
  __syncthreads();
  const size_t slot = (size_t)blockIdx.x * g.nruns + blockIdx.y;
  for (int x = threadIdx.x; x < KT * width; x += blockDim.x) {
    const int ch = blockIdx.z * width + x % width;
    if (ch >= g.C) continue;
    double s = 0.0;
    for (int r = 0; r < g.pixels; ++r)
      s += pbwd_red[(size_t)r * KT * width + x];
    part[(slot * KT + x / width) * g.C + ch] = (float)s;
  }
}

// The second pass (common.cuh's sum_columns): dk (KT, C) from the (parts,
// KT, C) partials.
__global__ void __launch_bounds__(32 * kSumLanes)
    dw_conv3d_pbwd_sum_kernel(const float* __restrict__ part,
                              float* __restrict__ dk, int ncols,
                              int nparts) {
  sum_columns(part, dk, ncols, nparts);
}

// Shared memory of a temporal-body block: its threads' KT x VE sums.
size_t pbwd_red_smem(const PbwdGeom& g, int kt, int ve) {
  return (size_t)g.group * g.pixels * kt * ve * sizeof(float);
}

template <typename T, int VE, int KT>
int launch_pbwd_temporal(const void* u, const void* gy, const float* taps,
                         void* du, float* part, float* dk, const PbwdGeom& g,
                         cudaStream_t stream) {
  auto kernel = dw_conv3d_pbwd_temporal_kernel<T, VE, KT>;
  const size_t smem = pbwd_red_smem(g, KT, VE);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)g.pblocks, g.nruns, ceil_div(g.cells, g.group));
  kernel<<<grid, g.group * g.pixels, smem, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(gy), taps,
      static_cast<T*>(du), part, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int ncols = KT * g.C;
  dw_conv3d_pbwd_sum_kernel<<<ceil_div(ncols, 32), dim3(32, kSumLanes), 0,
                              stream>>>(part, dk, ncols,
                                        (int)(g.pblocks * g.nruns));
  return cudaGetLastError();
}

// fn(Ring<T, VE, KT>{}) for the temporal body a call takes: with_temporal's
// instantiations at odd KT and cells of at most kPbwdMaxCell bytes (float32
// 1, 2 channels, bfloat16 1, 2, 4).
template <typename Fn>
int with_pbwd_temporal(int dtype, int ve, int kt, Fn&& fn) {
  return with_temporal(dtype, ve, kt, [&](auto inst) {
    using I = decltype(inst);
    if constexpr (I::kt % 2 == 1 &&
                  I::ve * sizeof(typename I::Elem) <= kPbwdMaxCell)
      return fn(inst);
    return (int)cudaErrorInvalidValue;
  });
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

// The temporal body's blocks an SM and the card's SMs, into out[0] and
// out[1], for `vec` channels a cell, kt temporal taps, blocks of `threads`
// threads and `smem` bytes of dynamic shared memory.
extern "C" int x3d_dw_conv3d_pbwd_temporal_occupancy(int dtype, int vec,
                                                     int kt, int threads,
                                                     int smem, void* out) {
  int* o = static_cast<int*>(out);
  return with_pbwd_temporal(dtype, vec, kt, [&](auto inst) {
    using I = decltype(inst);
    auto kernel =
        dw_conv3d_pbwd_temporal_kernel<typename I::Elem, I::ve, I::kt>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel,
                                                          threads, smem);
    o[1] = sm_count();
    return (int)err;
  });
}

// K8 by the temporal body: u, gy, taps, du, dk and the geometry as for
// x3d_dw_conv3d_pbwd, for spatial taps 1x1 and odd kt <= 5; then the plan of
// ops/depthwise.pbwd_temporal_plan (channels a cell, cells a channel group,
// pixel rows a block, rows a block walks, frames a run, rows of the
// partials buffer).  part: (parts, kt, C) float32 scratch.
// cudaErrorInvalidValue for a plan the kernel cannot run, addresses a cell
// does not divide or a partials count that is not the plan's.
extern "C" int x3d_dw_conv3d_pbwd_temporal(
    const void* u, const void* gy, const void* taps, void* du, void* part,
    void* dk, int dtype, int B, int T, int H, int W, int C, int kt, int vec,
    int group, int pixels, int walk, int run, int parts, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  if (kt < 1 || kt > kRingMaxKt || kt % 2 == 0 || vec < 1 || C % vec ||
      group < 1 || pixels < 1 || group * pixels > kPbwdThreads ||
      walk < 1 || run < 1 ||
      reinterpret_cast<uintptr_t>(u) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(gy) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(du) % (vec * elem))
    return cudaErrorInvalidValue;
  PbwdGeom g{T, C, H * W, (long long)B * H * W, C / vec, group, pixels, walk,
             run, ceil_div(T, run), 0};
  const long long rows = (g.N + pixels - 1) / pixels;
  g.pblocks = (rows + walk - 1) / walk;
  if (group > g.cells || ceil_div(g.cells, group) > 65535 ||
      g.nruns > 65535 || g.pblocks * g.nruns != parts ||
      g.pblocks > INT32_MAX)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(taps);
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  return with_pbwd_temporal(dtype, vec, kt, [&](auto inst) {
    using I = decltype(inst);
    return launch_pbwd_temporal<typename I::Elem, I::ve, I::kt>(
        u, gy, w, du, m(part), m(dk), g, s);
  });
}
