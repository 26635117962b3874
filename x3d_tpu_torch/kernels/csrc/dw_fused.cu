// K2: the fused bottleneck segment forward,
//
//   u = relu(a[c, b] * x + bb[c, b])            (rounded to x's dtype)
//   y = depthwise_conv3d(u, k)                  (stride 1, SAME, odd kernel)
//   p[c, b] = sum_thw y,   s2[c, b] = sum_thw y^2   (f32, of y as stored)
//
// Replaces the TPU kernel dw_fused._fwd_kernel (x3d_tpu/ops/dw_fused.py:298,
// launched by _run_fwd at :586).  In the model, (a, bb) are bn_a's normalise
// coefficients and p gives both bn_b's batch statistics (training) and the
// Squeeze-Excite pool (serving), so neither needs another pass over y.
// u = relu(a * x + bb) is computed as a multiply, then an add, each rounded
// (the plain version's arithmetic), rounded to x's dtype, and zero outside
// the clip: relu(a * 0 + bb) is not 0 where bb > 0, so the zeros are set
// after the affine, not by zero-padding x.  The TPU kernel summed the taps
// in the input dtype (bf16); this one sums them in f32.
//
// What bounds it on an H100: bytes -- it reads x and writes y (4 bytes an
// element in bf16) for 27 multiply-adds an element (kt 3), plus the affine
// and ReLU.  Two bodies, picked by the wrapper (ops/dw_fused.segment_body):
//   * ring body (x3d_dw_bn_act_conv_fwd_ring): spatial taps 3x3 and kt in
//     1 .. kRingMaxKt, every fused segment of X3D; the staging of K3's ring
//     body (dw_fused_bwd.cu) with one array and one role.  A block owns one
//     clip, a pixel tile (the whole plane up to 14 pixels a side), a group
//     of channel vectors (VE = 2 channels, 1 at odd C) and a run of frames.
//     Each plane of x enters a shared-memory ring of KT + kRingAhead slots
//     once per block, halo included, by cp.async kRingAhead planes ahead of
//     the one computed (a cell of VE channels a copy, plain loads where x's address
//     does not allow it), and is turned into u in place, in x's dtype, by
//     the thread that copied it, so one barrier a plane suffices.  The ring
//     is vector-major (a plane per vector, pixels consecutive along a row):
//     a tap's column is an immediate offset, and the plan pads the row and
//     plane pitches so that a warp's loads fall on distinct banks.  A thread
//     owns a vector and one row of the tile (every `rows`-th where the plan
//     gives fewer rows): it copies and transforms whole staged rows, whose
//     cells' addresses only step, and walks its row in runs of four pixels
//     (a 3 x 6 window of cells a tap plane), then pairs, with the taps in
//     registers (in shared memory where KT * 9 * VE > 64); it stores each
//     pixel's VE channels of y as one access and sums y and y^2 as stored.
//     Small blocks (the plan's at most 128 threads, one ring of one array)
//     leave room for four an SM.  What holds it: the fill (copies,
//     transform) and the multiply-adds (with the loads and bf16 unpacking
//     they need) do not overlap -- the body takes about the sum of their
//     separate times, whether by instruction issue or by the wait at the
//     one barrier a plane;
//   * generic body (x3d_dw_bn_act_conv_fwd): any other odd taps.  A block
//     owns one frame of one clip, an 8x8 pixel tile and 32 channels
//     (threads along the contiguous C); it stages the kt x 10 x 10 halo of u
//     in f32 in shared memory with scalar loads, one pixel and channel a
//     thread, the taps read from shared memory.
// Both write one f32 partial of y and of y^2 per block and channel, per
// (clip, tile) or (clip, tile, run), the rows summed in a fixed order; a
// second kernel sums the partials of each (channel, clip) in a fixed order,
// in double: deterministic, no atomics (the ring body's second pass is
// common.cuh's sum_columns, shared with K3).
//
// Both bodies take an optional BN epilogue (common.cuh's BnEpilogue):
// serving's bn_b, applied to y as it is stored, while p and s2 stay the
// sums of the conv's y (the SE pool is taken from them).  The bodies with
// it are built into a library of their own (X3D_BN_EPILOGUE), so that
// training's calls run the code they ran before there was one.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace x3d;

constexpr int kTile = 8;  // output rows and columns per block

struct FusedGeom {
  int B, T, H, W, C;
  int kt, kh, kw;
  int HR, WR;          // halo tile: kTile + kh - 1 rows, kTile + kw - 1 columns
  int nth, ntw, nct;   // tiles along H, W, C
  int ntiles;          // T * nth * ntw: partial sums per (clip, channel)
};

template <typename T, bool EP>
__global__ void __launch_bounds__(kThreads)
    dw_bn_act_conv_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ a_cb,
                              const float* __restrict__ b_cb,
                              const float* __restrict__ taps,
                              T* __restrict__ y, float* __restrict__ part_p,
                              float* __restrict__ part_s2, FusedGeom g,
                              BnEpilogue ep) {
  extern __shared__ float smem[];
  float* tile = smem;  // [kt][HR][WR][kChannels]
  float* wts = smem + (size_t)g.kt * g.HR * g.WR * kChannels;  // [taps][kChannels]
  __shared__ float coef_a[kChannels], coef_b[kChannels];
  __shared__ float red_p[kWarps][kChannels], red_s2[kWarps][kChannels];

  int bx = blockIdx.x;
  const int tw = bx % g.ntw;
  bx /= g.ntw;
  const int th = bx % g.nth;
  const int ct = bx / g.nth;
  const int t = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = ct * kChannels;
  const int h0 = th * kTile, w0 = tw * kTile;
  const int ti0 = t - g.kt / 2, hi0 = h0 - g.kh / 2, wi0 = w0 - g.kw / 2;
  const int ntaps = g.kt * g.kh * g.kw;

  if (threadIdx.x < kChannels) {
    const int c = c0 + threadIdx.x;
    coef_a[threadIdx.x] = c < g.C ? a_cb[(size_t)c * g.B + b] : 0.f;
    coef_b[threadIdx.x] = c < g.C ? b_cb[(size_t)c * g.B + b] : 0.f;
  }
  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int c = c0 + i % kChannels;
    wts[i] = c < g.C ? taps[(size_t)(i / kChannels) * g.C + c] : 0.f;
  }
  __syncthreads();

  const int n = g.kt * g.HR * g.WR * kChannels;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int lane = i % kChannels;
    const int c = c0 + lane;
    int r = i / kChannels;
    const int wi = wi0 + r % g.WR;
    r /= g.WR;
    const int hi = hi0 + r % g.HR;
    const int ti = ti0 + r / g.HR;
    float u = 0.f;
    if (c < g.C && ti >= 0 && ti < g.T && hi >= 0 && hi < g.H && wi >= 0 &&
        wi < g.W) {
      const float v =
          to_f32(x[(((size_t)(b * g.T + ti) * g.H + hi) * g.W + wi) * g.C + c]);
      // multiply, then add, each rounded: the plain version's arithmetic
      u = round_to<T>(fmaxf(__fadd_rn(__fmul_rn(v, coef_a[lane]), coef_b[lane]), 0.f));
    }
    tile[i] = u;
  }
  __syncthreads();

  const int lane = threadIdx.x % kChannels;
  const int warp = threadIdx.x / kChannels;
  const int c = c0 + lane;
  float sum = 0.f, sum2 = 0.f;
  if (c < g.C) {
    for (int p = warp; p < kTile * kTile; p += kWarps) {
      const int oh = p / kTile, ow = p % kTile;
      const int h = h0 + oh, w = w0 + ow;
      if (h >= g.H || w >= g.W) continue;
      float acc = 0.f;
      for (int dt = 0; dt < g.kt; ++dt)
        for (int dh = 0; dh < g.kh; ++dh) {
          const float* row =
              tile + (((size_t)dt * g.HR + oh + dh) * g.WR + ow) * kChannels + lane;
          const float* wp = wts + (dt * g.kh + dh) * g.kw * kChannels + lane;
          for (int dw = 0; dw < g.kw; ++dw)
            acc = fmaf(row[dw * kChannels], wp[dw * kChannels], acc);
        }
      const T out = from_f32<T>(acc);
      T stored = out;
      if constexpr (EP) stored = from_f32<T>(bn_value<T>(acc, c, ep));
      y[(((size_t)(b * g.T + t) * g.H + h) * g.W + w) * g.C + c] = stored;
      const float yv = to_f32(out);  // the sums see y as the conv rounds it
      sum += yv;
      sum2 = fmaf(yv, yv, sum2);
    }
  }
  red_p[warp][lane] = sum;
  red_s2[warp][lane] = sum2;
  __syncthreads();
  if (threadIdx.x < kChannels && c < g.C) {
    float sp = 0.f, ss = 0.f;
    for (int k = 0; k < kWarps; ++k) {
      sp += red_p[k][threadIdx.x];
      ss += red_s2[k][threadIdx.x];
    }
    const size_t slot =
        ((size_t)b * g.ntiles + ((size_t)t * g.nth + th) * g.ntw + tw) * g.C + c;
    part_p[slot] = sp;
    part_s2[slot] = ss;
  }
}

// p, s2: (C, B).  One thread per (channel, clip), channels fastest so that
// a warp reads consecutive partials; each sums its ntiles partials in order.
__global__ void sum_partials_kernel(const float* __restrict__ part_p,
                                    const float* __restrict__ part_s2,
                                    float* __restrict__ p,
                                    float* __restrict__ s2, int B, int C,
                                    int ntiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int c = i % C, b = i / C;
  const size_t base = (size_t)b * ntiles * C + c;
  double sp = 0.0, ss = 0.0;
  for (int k = 0; k < ntiles; ++k) {
    sp += part_p[base + (size_t)k * C];
    ss += part_s2[base + (size_t)k * C];
  }
  p[(size_t)c * B + b] = (float)sp;
  s2[(size_t)c * B + b] = (float)ss;
}

FusedGeom geometry(int B, int T, int H, int W, int C, int kt, int kh, int kw) {
  FusedGeom g{B, T, H, W, C, kt, kh, kw};
  g.HR = kTile + kh - 1;
  g.WR = kTile + kw - 1;
  g.nth = ceil_div(H, kTile);
  g.ntw = ceil_div(W, kTile);
  g.nct = ceil_div(C, kChannels);
  g.ntiles = T * g.nth * g.ntw;
  return g;
}

template <typename T>
int launch(const void* x, const float* a_cb, const float* b_cb,
           const float* taps, void* y, float* part_p, float* part_s2, float* p,
           float* s2, const FusedGeom& g, const BnEpilogue& ep,
           cudaStream_t stream) {
  const size_t smem = ((size_t)g.kt * g.HR * g.WR + (size_t)g.kt * g.kh * g.kw) *
                      kChannels * sizeof(float);
  cudaError_t err = (cudaError_t)with_epilogue(ep, [&](auto e) -> int {
    const auto kernel = dw_bn_act_conv_fwd_kernel<T, decltype(e)::value>;
    const cudaError_t allowed = allow_smem(kernel, smem);
    if (allowed != cudaSuccess) return allowed;
    const dim3 grid(g.nct * g.nth * g.ntw, g.T, g.B);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(x), a_cb, b_cb, taps, static_cast<T*>(y),
        part_p, part_s2, g, ep);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  const int n = g.B * g.C;
  sum_partials_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(
      part_p, part_s2, p, s2, g.B, g.C, g.ntiles);
  return cudaGetLastError();
}

// -------------------------------------------------------------- ring body

// Dynamic shared memory of a ring-body block: KT + kRingAhead slots of x
// (then u); after the frames the same bytes hold the rows' sum partials; the
// taps beyond both where they live there.
size_t ring_smem(RingGeom& q, int elem, int kt, int ve) {
  return ring_layout(q, (size_t)(kt + kRingAhead) * q.slot * ve * elem,
                     (size_t)q.rows * 2 * q.CG * sizeof(float), kt, ve);
}

// Registers: at most 128 a thread, so that four blocks of 128 threads (the
// plan's most) share an SM.
template <typename T, int VE, int KT, bool EP>
__global__ void __launch_bounds__(kRingMaxThreads, 4)
    dw_bn_act_conv_fwd_ring_kernel(const T* __restrict__ x,
                                   const float* __restrict__ a_cb,
                                   const float* __restrict__ b_cb,
                                   const float* __restrict__ taps,
                                   T* __restrict__ y,
                                   float* __restrict__ part_p,
                                   float* __restrict__ part_s2, RingGeom q,
                                   BnEpilogue ep) {
  using Cell = typename CellOf<T, VE>::type;
  constexpr int HT = (KT - 1) / 2;  // SAME: planes before the frame
  constexpr int HI = KT - 1 - HT;   // ... and after it
  constexpr int NT = KT * 9;
  constexpr bool kSharedTaps = ring_taps_shared(KT, VE);
  constexpr int S = KT + kRingAhead;  // ring slots
  extern __shared__ __align__(16) unsigned char ring_smem_[];
  Cell* us = reinterpret_cast<Cell*>(ring_smem_);  // [S][slot]: x, then u
  float* wsm = reinterpret_cast<float*>(ring_smem_ + q.taps_at);  // [NT][CG]
  float* red = reinterpret_cast<float*>(ring_smem_);  // [rows][2][CG]

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int c0 = bx / q.nth * q.CG;
  const int run = blockIdx.y;
  const int t0 = run * q.TC, t1 = min(t0 + q.TC, q.T);
  const int b = blockIdx.z;
  const int h0 = th * q.TH, w0 = tw * q.TW;
  // thread (cv, r): vector cv of the group at tile rows r, r + rows, ...
  const int nv = q.CG / VE;
  const bool active = threadIdx.x < nv * q.rows;
  const int cv = threadIdx.x % nv, r = threadIdx.x / nv;
  const int c = c0 + cv * VE;
  const bool live = active && c < q.C;  // at VE 2, C is even: c + 1 < C
  const int vplane = cv * q.VP;  // the thread's vector plane in a slot
  const size_t frame = (size_t)q.H * q.W * q.C;
  const int npix = (q.TH + 2) * q.WP;

  // a and bb of the thread's channels (zero past C)
  float ca[VE], cb[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const bool ok = c + e < q.C;
    const size_t i = (size_t)(c + e) * q.B + b;
    ca[e] = ok ? a_cb[i] : 0.f;
    cb[e] = ok ? b_cb[i] : 0.f;
  }
  // the taps, w[dt][3 dh + dw] (unless they live in shared memory)
  float w[KT][9][VE];
  if constexpr (kSharedTaps) {
    for (int i = threadIdx.x; i < NT * q.CG; i += blockDim.x) {
      const int cc = c0 + i % q.CG;
      wsm[i] = cc < q.C ? taps[(size_t)(i / q.CG) * q.C + cc] : 0.f;
    }
  } else {
#pragma unroll
    for (int dt = 0; dt < KT; ++dt)
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int e = 0; e < VE; ++e)
          w[dt][j][e] = live ? taps[(size_t)(dt * 9 + j) * q.C + c + e] : 0.f;
  }
  float sum_y[VE] = {}, sum_y2[VE] = {};

  // Thread (cv, r) moves and transforms its vector's cells of the staged
  // rows h0-1 .. h0+TH and columns w0-1 .. w0-2+WP (the last one only read
  // by a pair's idle half, but never left unset): whole staged rows r,
  // r + rows, ... up to the last multiple of rows, along which a cell's
  // address only steps, then its share (i = r, r + rows, ...) of the cells
  // of the rows left.  At (pr, pc) a cell sits pr * WP + pc into the vector
  // plane.
  const int whole = (q.TH + 2) / q.rows * q.rows;
  auto for_cells = [&](auto&& fn) {
    if (!active) return;
    for (int pr = r; pr < whole; pr += q.rows) {
      const int hi = h0 - 1 + pr;
      const bool row_in = live && hi >= 0 && hi < q.H;
      for (int pc = 0; pc < q.WP; ++pc) {
        const int wi = w0 - 1 + pc;
        fn(vplane + pr * q.WP + pc, hi, wi, row_in && wi >= 0 && wi < q.W);
      }
    }
    for (int i = r; i < npix - whole * q.WP; i += q.rows) {
      const int pr = whole + i / q.WP, pc = i % q.WP;
      const int hi = h0 - 1 + pr, wi = w0 - 1 + pc;
      fn(vplane + pr * q.WP + pc, hi, wi,
         live && hi >= 0 && hi < q.H && wi >= 0 && wi < q.W);
    }
  };
  // Raw plane p of x into slot p % S; zeros outside the image.
  auto fetch = [&](int p) {
    Cell* to = us + (p % S) * q.slot;
    const size_t base = (size_t)(b * q.T + p) * frame + c;
    for_cells([&](int at, int hi, int wi, bool ok) {
      const T* from = x + (ok ? base + ((size_t)hi * q.W + wi) * q.C : 0);
      if constexpr (sizeof(Cell) >= 4) {
        if (q.granule == (int)sizeof(Cell)) {
          cp_async<sizeof(Cell)>(to + at, from, ok);
          return;
        }
      }
      T* e = reinterpret_cast<T*>(to + at);  // plain loads, an element a time
#pragma unroll
      for (int i = 0; i < VE; ++i) e[i] = ok ? from[i] : from_f32<T>(0.f);
    });
  };
  // Plane p of x, in place, into u = relu(a x + bb), zero outside the
  // image: the cells this thread fetched, so only its own copies need to
  // land.
  auto transform = [&](int p) {
    Cell* u = us + (p % S) * q.slot;
    for_cells([&](int at, int, int, bool in) {
      float xv[VE], uo[VE];
      cell_f32<T>(u + at, xv);
#pragma unroll
      for (int e = 0; e < VE; ++e)
        // multiply, then add, each rounded: the plain version's arithmetic
        uo[e] = in ? fmaxf(__fadd_rn(__fmul_rn(xv[e], ca[e]), cb[e]), 0.f)
                   : 0.f;
      store_f32(reinterpret_cast<T*>(u + at), uo);
    });
  };
  // y of one pixel, rounded to T, stored as one access (through the BN
  // epilogue, if any); the sums see y as the conv rounds it.
  auto finish = [&](T* out, const float (&acc)[VE]) {
    float o[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      o[e] = round_to<T>(acc[e]);
      sum_y[e] += o[e];
      sum_y2[e] = fmaf(o[e], o[e], sum_y2[e]);
    }
    if constexpr (EP) bn_cell<T>(o, c, ep);
    store_f32(out, o);
  };

  // Frame t along rows r, r + rows, ...: runs of N = 4 pixels, then pairs
  // for the rest of the row.  Column j of a run's 3 x (N + 2) window of
  // cells feeds pixel k's tap dw = j - k; within a row the cells are
  // consecutive, so a run of four loads 1.5 cells a pixel, a pair 2.
  auto compute = [&](int t) {
    T* out = y + (size_t)(b * q.T + t) * frame + c;
    int plane[KT];  // the slot of plane t + dt - HT, or -1 outside the clip
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      const int tp = t + dt - HT;
      plane[dt] = tp >= 0 && tp < q.T ? (tp % S) * q.slot + vplane : -1;
    }
    const int cols = min(q.TW, q.W - w0);  // the tile's columns in the image
    // pixels ow .. ow + N - 1 of row oh, the first `valid` of them stored
    auto run = [&](auto n_tag, int oh, int ow, int valid) {
      constexpr int N = decltype(n_tag)::value;
      const int pix = oh * q.WP + ow;
      float acc[N][VE] = {};
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        if (plane[dt] < 0) continue;  // u is zero there
        float wt[9][VE];
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          if constexpr (kSharedTaps) {
            load_f32(wsm + (dt * 9 + j) * q.CG + cv * VE, wt[j]);
          } else {
#pragma unroll
            for (int e = 0; e < VE; ++e) wt[j][e] = w[dt][j][e];
          }
        }
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
          const Cell* row = us + plane[dt] + pix + dh * q.WP;
#pragma unroll
          for (int j = 0; j < N + 2; ++j) {
            float v[VE];
            cell_f32<T>(row + j, v);
#pragma unroll
            for (int k = 0; k < N; ++k)
              if (j - k >= 0 && j - k < 3)
#pragma unroll
                for (int e = 0; e < VE; ++e)
                  acc[k][e] = fmaf(v[e], wt[3 * dh + j - k][e], acc[k][e]);
          }
        }
      }
      T* px = out + ((size_t)(h0 + oh) * q.W + w0 + ow) * q.C;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < valid) finish(px + (size_t)k * q.C, acc[k]);
    };
    for (int oh = r; oh < q.TH && h0 + oh < q.H; oh += q.rows) {
      int ow = 0;
      for (; ow + 4 <= cols; ow += 4)
        run(std::integral_constant<int, 4>{}, oh, ow, 4);
      for (; ow < cols; ow += 2)
        run(std::integral_constant<int, 2>{}, oh, ow, min(2, cols - ow));
    }
  };

  // Plane p + kRingAhead is fetched (its own cp.async group) while frame
  // p - HI is computed.  Its slot held plane p + kRingAhead - S = p - KT,
  // last read by frame p - HI - 1.  One barrier a plane: after it every cell
  // of plane p is u, and frame p - HI - 1 is done.
  const int p_lo = max(0, t0 - HT), p_hi = min(q.T - 1, t1 - 1 + HI);
  for (int j = 0; j < kRingAhead; ++j) {
    if (p_lo + j <= p_hi) fetch(p_lo + j);
    cp_async_commit();
  }
  for (int p = p_lo; p <= t1 - 1 + HI; ++p) {
    if (p <= p_hi) {
      cp_async_wait<kRingAhead - 1>();  // this thread's copies of plane p
      transform(p);
      __syncthreads();
      if (p + kRingAhead <= p_hi) fetch(p + kRingAhead);
      cp_async_commit();  // an empty group past the end keeps the count
    }
    const int t = p - HI;
    if (t >= t0 && live) compute(t);
  }

  // Each thread row's sums through shared memory; summed over the rows in
  // order into the block's partials.
  __syncthreads();
  float* mine = red + (size_t)r * 2 * q.CG + cv * VE;
  if (active) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      mine[e] = sum_y[e];
      mine[q.CG + e] = sum_y2[e];
    }
  }
  __syncthreads();
  const size_t sub = (size_t)(th * q.ntw + tw) * q.nruns + run;
  for (int i = threadIdx.x; i < 2 * q.CG; i += blockDim.x) {
    const int cc = c0 + i % q.CG;
    if (cc >= q.C) continue;
    float s = 0.f;
    for (int rr = 0; rr < q.rows; ++rr) s += red[(size_t)rr * 2 * q.CG + i];
    (i < q.CG ? part_p : part_s2)[(sub * q.C + cc) * q.B + b] = s;
  }
}

// The second pass (common.cuh's sum_columns): blockIdx.y picks the pair
// (p0, o0) or (p1, o1).
__global__ void __launch_bounds__(32 * kSumLanes)
    dw_bn_act_conv_fwd_sum_kernel(const float* __restrict__ p0,
                                  float* __restrict__ o0,
                                  const float* __restrict__ p1,
                                  float* __restrict__ o1, int ncols,
                                  int nparts) {
  sum_columns(blockIdx.y ? p1 : p0, blockIdx.y ? o1 : o0, ncols, nparts);
}

template <typename T, int VE, int KT>
int launch_ring(const void* x, const float* a_cb, const float* b_cb,
                const float* taps, void* y, float* part_p, float* part_s2,
                float* p, float* s2, RingGeom q, const BnEpilogue& ep,
                cudaStream_t stream) {
  const size_t smem = ring_smem(q, sizeof(T), KT, VE);
  cudaError_t err = (cudaError_t)with_epilogue(ep, [&](auto e) -> int {
    auto kernel = dw_bn_act_conv_fwd_ring_kernel<T, VE, KT,
                                                 decltype(e)::value>;
    const cudaError_t allowed = allow_smem(kernel, smem);
    if (allowed != cudaSuccess) return allowed;
    const int threads = ceil_div(q.CG / VE * q.rows, 32) * 32;
    const dim3 grid(ceil_div(q.C, q.CG) * q.nth * q.ntw, q.nruns, q.B);
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const T*>(x), a_cb, b_cb, taps, static_cast<T*>(y),
        part_p, part_s2, q, ep);
    return cudaGetLastError();
  });
  if (err != cudaSuccess) return err;
  dw_bn_act_conv_fwd_sum_kernel<<<dim3(ceil_div(q.C * q.B, 32), 2),
                                  dim3(32, kSumLanes), 0, stream>>>(
      part_p, p, part_s2, s2, q.C * q.B, q.nth * q.ntw * q.nruns);
  return cudaGetLastError();
}

}  // namespace

// Partial sums per (clip, channel): the wrapper allocates two (B, tiles, C)
// float32 buffers for them.
extern "C" int x3d_dw_bn_act_conv_tiles(int T, int H, int W) {
  return geometry(1, T, H, W, 1, 1, 1, 1).ntiles;
}

// x, y: (B, T, H, W, C) in `dtype` (0 float32, 1 bfloat16); a_cb, b_cb, p,
// s2: (C, B) float32; taps: (kt*kh*kw, C) float32; part_p, part_s2:
// (B, tiles, C) float32 scratch; mul, add: (C,) float32, 16-byte aligned,
// the BN epilogue on y (common.cuh's BnEpilogue, with a ReLU where `relu`;
// p and s2 stay the sums of the conv's y), or null for none.  Returns a cudaError_t
// code.
extern "C" int x3d_dw_bn_act_conv_fwd(const void* x, const void* a_cb,
                                      const void* b_cb, const void* taps,
                                      void* y, void* part_p, void* part_s2,
                                      void* p, void* s2, int dtype, int B,
                                      int T, int H, int W, int C, int kt,
                                      int kh, int kw, const void* mul,
                                      const void* add, int relu,
                                      void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (kt % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || T > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  const FusedGeom g = geometry(B, T, H, W, C, kt, kh, kw);
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  const BnEpilogue ep{f(mul), f(add), relu};
  if (dtype == kF32)
    return launch<float>(x, f(a_cb), f(b_cb), f(taps), y, m(part_p),
                         m(part_s2), m(p), m(s2), g, ep, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, f(a_cb), f(b_cb), f(taps), y, m(part_p),
                                 m(part_s2), m(p), m(s2), g, ep, s);
  return cudaErrorInvalidValue;
}

// The ring body's blocks an SM and the card's SMs, into out[0] and out[1],
// for a block of `threads` threads and `smem` bytes of dynamic shared memory.
extern "C" int x3d_dw_bn_act_conv_fwd_ring_occupancy(int dtype, int vec,
                                                     int kt, int threads,
                                                     int smem, void* out) {
  int* o = static_cast<int*>(out);
  return with_ring(dtype, vec, kt, [&](auto ring) {
    using R = decltype(ring);
    auto kernel = dw_bn_act_conv_fwd_ring_kernel<typename R::Elem, R::ve,
                                                 R::kt, kBnEpilogue>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel,
                                                          threads, smem);
    o[1] = sm_count();
    return (int)err;
  });
}

// K2 by the ring body: the arguments of x3d_dw_bn_act_conv_fwd for spatial
// taps 3x3 and kt in 1 .. 5, then the launch plan of ops/dw_fused.fwd_plan
// (tile sides, channels a group, channels a vector, thread rows, frames a
// run, copy granule in bytes, cells a staged row, cells padding each vector
// plane), and the BN epilogue's mul, add, relu.  part_p, part_s2: (tiles,
// runs, C, B) float32 scratch.  cudaErrorInvalidValue for a plan the kernel
// cannot run or pointers the granule does not divide.
extern "C" int x3d_dw_bn_act_conv_fwd_ring(
    const void* x, const void* a_cb, const void* b_cb, const void* taps,
    void* y, void* part_p, void* part_s2, void* p, void* s2, int dtype,
    int B, int T, int H, int W, int C, int kt, int tile_h, int tile_w,
    int group, int vec, int rows, int run, int granule, int row_cells,
    int vec_pad, const void* mul, const void* add, int relu, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  RingGeom q{B, T, H, W, C};
  if (!ring_geometry(q, elem, kt, vec, tile_h, tile_w, group, rows, run,
                     granule, row_cells, vec_pad))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % granule ||
      reinterpret_cast<uintptr_t>(y) % (vec * elem))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  const BnEpilogue ep{f(mul), f(add), relu};
  return with_ring(dtype, vec, kt, [&](auto ring) {
    using R = decltype(ring);
    return launch_ring<typename R::Elem, R::ve, R::kt>(
        x, f(a_cb), f(b_cb), f(taps), y, m(part_p), m(part_s2), m(p), m(s2),
        q, ep, s);
  });
}
