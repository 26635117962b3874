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
// it is loaded, and the three reductions come out of the same pass.  The
// TPU kernel summed taps in the input dtype; this one sums in f32.
//
// What bounds it on an H100: bytes -- it reads x, y and gy and writes dx
// (8 bytes per element in bf16) for 2 x 27 FMAs (du and dk) per element.
// Two bodies, picked by the wrapper (ops/dw_fused.bwd_body):
//   * ring body (x3d_dw_bn_act_conv_bwd_ring): spatial taps 3x3 and kt in
//     1 .. kRingMaxKt, every fused segment of X3D.  The TPU kernel's ring: a
//     block owns one clip, a pixel tile (the whole plane up to 14 pixels a
//     side), a group of channel vectors (VE = 2 channels, 1 at odd C) and a
//     run of frames.  Each plane of x, gy and y enters a shared-memory ring
//     once per block, halo included, by cp.async kRingAhead planes ahead (a
//     cell of VE channels a copy, plain loads where the addresses do not
//     allow it), and is turned into u and g in place, in x's dtype, by the
//     thread that copied it: the affine, ReLU and g_eff run once an element,
//     and one barrier a frame suffices.  The ring is vector-major (a plane
//     per vector, pixels consecutive along a row), so a tap's column is an
//     immediate offset, and the plan pads the row and plane pitches so that
//     a warp's loads hit distinct banks.  A block has two roles of whole
//     warps over the same pixels: the du role walks pixel pairs with the
//     flipped taps in registers (loaded once a block; in shared memory where
//     KT * 9 * VE > 64), forms dz and dx and the sums dzs and duu; the dk
//     role walks the same pairs and keeps the dk sums in the same registers,
//     so a thread holds 54 of them, not 108 (bf16, VE 2, kt 3).  What bounds
//     it: the ring's fill (4-byte copies, one or two planes in flight, the
//     transform) does not overlap the multiply-adds, so it costs about the
//     sum of the two;
//   * generic body (x3d_dw_bn_act_conv_bwd): any other odd taps.  A block
//     owns one 8x8 pixel tile of one clip and 32 channels (threads along the
//     contiguous C) and walks over the clip's frames; for each it stages the
//     kt x (8+kh-1) x (8+kw-1) halos of u and of g in f32 in shared memory,
//     with scalar loads; each warp owns every 8th tap of dk.
// Both write one f32 partial per block of each dk (tap, channel) and each
// (channel, clip) sum; a second kernel sums them in a fixed order, in double:
// deterministic, no atomics (the ring body's second pass splits each column
// into kSumLanes fixed chunks, then adds the chunks in order).
// Not yet done (later work): copies of whole contiguous rows (16 bytes, or
// TMA) with more planes in flight, so that the fill overlaps the
// multiply-adds; the generic body keeps scalar, f32 staging.

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

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

// -------------------------------------------------------------- ring body

// The ring's limits and geometry (RingGeom, ring_geometry), where the
// flipped taps live (ring_taps_shared) and a cell (CellOf) are common.cuh's,
// shared with K2's ring body.

// Dynamic shared memory of a ring-body block: KT + kRingAhead slots of x
// (then u) and of gy (then g), kRingAhead + 1 of y; after the frames the
// same bytes hold the rows' dk and sum partials; the flipped taps beyond
// both where they live there.
size_t ring_smem(RingGeom& q, int elem, int kt, int ve) {
  return ring_layout(
      q, (size_t)(2 * (kt + kRingAhead) + kRingAhead + 1) * q.slot * ve * elem,
      (size_t)q.rows * (9 * kt + 2) * q.CG * sizeof(float), kt, ve);
}

// Registers: at most 128 a thread, so that two blocks share an SM.
template <typename T, int VE, int KT>
__global__ void __launch_bounds__(2 * kRingMaxThreads, 2)
    dw_bn_act_conv_bwd_ring_kernel(
        const T* __restrict__ x, const T* __restrict__ y,
        const T* __restrict__ gy, const float* __restrict__ a_cb,
        const float* __restrict__ b_cb, const float* __restrict__ gp_cb,
        const float* __restrict__ gs2_cb, const float* __restrict__ taps,
        T* __restrict__ dx, float* __restrict__ part_dk,
        float* __restrict__ part_dzs, float* __restrict__ part_duu,
        RingGeom q) {
  using Cell = typename CellOf<T, VE>::type;
  constexpr int HT = (KT - 1) / 2;    // SAME: planes before the frame
  constexpr int HI = KT - 1 - HT;     // ... and after it
  constexpr int S = KT + kRingAhead;  // ring slots of u and of g
  constexpr int SY = kRingAhead + 1;  // ring slots of y
  constexpr int NT = KT * 9;
  constexpr bool kSharedTaps = ring_taps_shared(KT, VE);
  extern __shared__ __align__(16) unsigned char ring_smem_[];
  Cell* us = reinterpret_cast<Cell*>(ring_smem_);  // [S][slot]: x, then u
  Cell* gs = us + S * q.slot;                      // [S][slot]: gy, then g
  Cell* ys = gs + S * q.slot;                      // [SY][slot]: y
  float* wsm = reinterpret_cast<float*>(ring_smem_ + q.taps_at);  // [NT][CG]
  float* red = reinterpret_cast<float*>(ring_smem_);  // [rows][NT + 2][CG]

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int c0 = bx / q.nth * q.CG;
  const int run = blockIdx.y;
  const int t0 = run * q.TC, t1 = min(t0 + q.TC, q.T);
  const int b = blockIdx.z;
  const int h0 = th * q.TH, w0 = tw * q.TW;
  // Two roles of whole warps: the du role's thread (cv, r) computes du, dx
  // and the sums of vector cv at rows r, r + rows, ...; the dk role's
  // thread (cv, r) the dk sums of the same pixels.
  const int nv = q.CG / VE;
  const int span = (nv * q.rows + 31) / 32 * 32;  // threads a role spans
  const bool dk_role = threadIdx.x >= span;
  const int li = threadIdx.x - (dk_role ? span : 0);
  const bool active = li < nv * q.rows;
  const int cv = li % nv, r = li / nv;
  const int c = c0 + cv * VE;
  const bool live = active && c < q.C;  // at VE 2, C is even: c + 1 < C
  const int vplane = cv * q.VP;  // the thread's vector plane in a slot
  const size_t frame = (size_t)q.H * q.W * q.C;
  const int npix = (q.TH + 2) * q.WP;

  // a, bb, gp and 2 gs2 of the thread's channels (zero past C)
  float ca[VE], cb[VE], cg[VE], cs[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) {
    const bool ok = c + e < q.C;
    const size_t i = (size_t)(c + e) * q.B + b;
    ca[e] = ok ? a_cb[i] : 0.f;
    cb[e] = ok ? b_cb[i] : 0.f;
    cg[e] = ok ? gp_cb[i] : 0.f;
    cs[e] = ok ? 2.f * gs2_cb[i] : 0.f;
  }
  // held: the du role's flipped taps, w[tap] = k[NT - 1 - tap] (unless
  // they live in shared memory), or the dk role's dk sums -- one array, so
  // that a thread's registers hold one of the two
  float held[KT][9][VE];
  if constexpr (kSharedTaps) {
    for (int i = threadIdx.x; i < NT * q.CG; i += blockDim.x) {
      const int cc = c0 + i % q.CG;
      wsm[i] = cc < q.C ? taps[(size_t)(NT - 1 - i / q.CG) * q.C + cc] : 0.f;
    }
  }
#pragma unroll
  for (int dt = 0; dt < KT; ++dt)
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int e = 0; e < VE; ++e)
        held[dt][j][e] =
            !kSharedTaps && live && !dk_role
                ? taps[(size_t)(NT - 1 - dt * 9 - j) * q.C + c + e]
                : 0.f;
  float sum_dz[VE] = {}, sum_dzu[VE] = {};

  // Thread (cv, r) of a role moves and transforms its vector's cells of
  // pixels f, f + 2 rows, ... (f = r in the du role, rows + r in the dk
  // role) of the staged rows h0-1 .. h0+TH and columns w0-1 .. w0-2+WP (the
  // last one only read by a pair's idle half, but never left unset); at
  // (pr, pc) a cell sits pr * WP + pc into the vector plane.
  auto for_cells = [&](auto&& fn) {
    if (!active) return;
    const int first = r + (dk_role ? q.rows : 0), step = 2 * q.rows;
    int pr = first / q.WP, pc = first % q.WP;
    const int srow = step / q.WP, scol = step % q.WP;
    for (int pix = first; pix < npix; pix += step) {
      const int hi = h0 - 1 + pr, wi = w0 - 1 + pc;
      fn(vplane + pr * q.WP + pc, hi, wi,
         live && hi >= 0 && hi < q.H && wi >= 0 && wi < q.W);
      pr += srow, pc += scol;
      if (pc >= q.WP) pc -= q.WP, ++pr;
    }
  };
  auto copy = [&](Cell* to, const T* from, bool ok) {
    if constexpr (sizeof(Cell) >= 4) {
      if (q.granule == (int)sizeof(Cell)) {
        cp_async<sizeof(Cell)>(to, from, ok);
        return;
      }
    }
    T* e = reinterpret_cast<T*>(to);  // plain loads, an element at a time
#pragma unroll
    for (int i = 0; i < VE; ++i) e[i] = ok ? from[i] : from_f32<T>(0.f);
  };
  // Raw plane p into its slots: x and gy into p % S, y into p % SY; zeros
  // outside the clip.
  auto fetch = [&](int p) {
    Cell* to_x = us + (p % S) * q.slot;
    Cell* to_g = gs + (p % S) * q.slot;
    Cell* to_y = ys + (p % SY) * q.slot;
    const size_t base = (size_t)(b * q.T + p) * frame + c;
    for_cells([&](int at, int hi, int wi, bool ok) {
      const size_t from = ok ? base + ((size_t)hi * q.W + wi) * q.C : 0;
      copy(to_x + at, x + from, ok);
      copy(to_g + at, gy + from, ok);
      copy(to_y + at, y + from, ok);
    });
  };
  // Plane p's x and gy, in place, into u and g (zero outside the image):
  // the cells this thread fetched, so only its own copies need to land.
  auto transform = [&](int p) {
    Cell* u = us + (p % S) * q.slot;
    Cell* g = gs + (p % S) * q.slot;
    const Cell* yy = ys + (p % SY) * q.slot;
    for_cells([&](int at, int, int, bool in) {
      float xv[VE], gv[VE], yv[VE], uo[VE], go[VE];
      load_f32(reinterpret_cast<const T*>(u + at), xv);
      load_f32(reinterpret_cast<const T*>(g + at), gv);
      load_f32(reinterpret_cast<const T*>(yy + at), yv);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        // each multiply and add rounded: the plain version's arithmetic
        uo[e] = in ? fmaxf(__fadd_rn(__fmul_rn(xv[e], ca[e]), cb[e]), 0.f)
                   : 0.f;
        go[e] = in ? __fadd_rn(__fadd_rn(gv[e], cg[e]), __fmul_rn(cs[e], yv[e]))
                   : 0.f;
      }
      store_f32(reinterpret_cast<T*>(u + at), uo);
      store_f32(reinterpret_cast<T*>(g + at), go);
    });
  };

  auto finish = [&](T* out, const float (&du)[VE], const float (&u)[VE]) {
    float o[VE];
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float dz = u[e] > 0.f ? du[e] : 0.f;
      o[e] = __fmul_rn(dz, ca[e]);
      sum_dz[e] += dz;
      sum_dzu[e] = fmaf(dz, u[e], sum_dzu[e]);
    }
    store_f32(out, o);
  };
  auto ld = [](const Cell* p, float (&v)[VE]) {
    load_f32(reinterpret_cast<const T*>(p), v);
  };

  // Frame t: pixel pairs (A, B) = (ow, ow + 1) along rows r, r + rows, ...
  // Column j of the pair's 3 x 4 window of cells feeds A's taps dw = j and
  // B's dw = j - 1; within a row the cells are consecutive.  The du role
  // reads the window of g (and u at the centre), the dk role that of u (and
  // g at the centre).
  // kDk: the role, a compile-time tag so that each role's loop is its own
  // code (a run-time test would predicate both roles' multiply-adds).
  auto compute = [&](int t, auto dk_tag) {
    constexpr bool kDk = decltype(dk_tag)::value;
    T* out = dx + (size_t)(b * q.T + t) * frame + c;
    int plane[KT];  // the slot of plane t + dt - HT, or -1 outside the clip
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      const int tp = t + dt - HT;
      plane[dt] = tp >= 0 && tp < q.T ? (tp % S) * q.slot + vplane : -1;
    }
    // the centre pair of the other array: g's for dk, u's for du
    const Cell* centre = (kDk ? gs : us) + plane[HT] + q.WP + 1;
    const Cell* window = kDk ? us : gs;
    for (int oh = r; oh < q.TH && h0 + oh < q.H; oh += q.rows) {
      for (int ow = 0; ow < q.TW && w0 + ow < q.W; ow += 2) {
        const bool two = ow + 1 < q.TW && w0 + ow + 1 < q.W;
        const int pix = oh * q.WP + ow;
        float mA[VE], mB[VE], accA[VE] = {}, accB[VE] = {};
        ld(centre + pix, mA);
        ld(centre + pix + 1, mB);
#pragma unroll
        for (int e = 0; e < VE; ++e) mB[e] = two ? mB[e] : 0.f;
#pragma unroll
        for (int dt = 0; dt < KT; ++dt) {
          if (plane[dt] < 0) continue;  // u and g are zero there
          float w[9][VE];
          if constexpr (!kDk) {
#pragma unroll
            for (int j = 0; j < 9; ++j) {
              if constexpr (kSharedTaps) {
                load_f32(wsm + (dt * 9 + j) * q.CG + cv * VE, w[j]);
              } else {
#pragma unroll
                for (int e = 0; e < VE; ++e) w[j][e] = held[dt][j][e];
              }
            }
          }
#pragma unroll
          for (int dh = 0; dh < 3; ++dh) {
            const Cell* row = window + plane[dt] + pix + dh * q.WP;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float v[VE];
              ld(row + j, v);
#pragma unroll
              for (int e = 0; e < VE; ++e) {
                if constexpr (kDk) {  // dk[tap] += u shifted by the tap * g
                  if (j < 3)
                    held[dt][3 * dh + j][e] =
                        fmaf(v[e], mA[e], held[dt][3 * dh + j][e]);
                  if (j > 0)
                    held[dt][3 * dh + j - 1][e] =
                        fmaf(v[e], mB[e], held[dt][3 * dh + j - 1][e]);
                } else {  // du += g shifted by the tap * the flipped tap
                  if (j < 3) accA[e] = fmaf(v[e], w[3 * dh + j][e], accA[e]);
                  if (j > 0)
                    accB[e] = fmaf(v[e], w[3 * dh + j - 1][e], accB[e]);
                }
              }
            }
          }
        }
        if constexpr (!kDk) {
          T* px = out + ((size_t)(h0 + oh) * q.W + w0 + ow) * q.C;
          finish(px, accA, mA);
          if (two) finish(px + q.C, accB, mB);
        }
      }
    }
  };

  // Plane p + kRingAhead is fetched (its own cp.async group) while frame
  // p - HI is computed.  Its slot of u and g held plane p - KT, last read by
  // frame p - HI - 1; its y slot held plane p - 1, which only this thread's
  // transform read.  One barrier a frame: after it every cell of plane p is
  // u and g, and frame p - HI - 1 is done.
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
    if (t >= t0 && live) {
      if (dk_role)
        compute(t, std::true_type{});
      else
        compute(t, std::false_type{});
    }
  }

  // Each thread row's dk, dzs and duu through shared memory; summed over
  // the rows in order into the block's partials.
  __syncthreads();
  float* mine = red + (size_t)r * (NT + 2) * q.CG + cv * VE;
  if (active) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      if (dk_role) {
#pragma unroll
        for (int i = 0; i < NT; ++i)
          mine[(size_t)i * q.CG + e] = held[i / 9][i % 9][e];
      } else {
        mine[(size_t)NT * q.CG + e] = sum_dz[e];
        mine[(size_t)(NT + 1) * q.CG + e] = sum_dzu[e];
      }
    }
  }
  __syncthreads();
  const int tiles = q.nth * q.ntw, tile = th * q.ntw + tw;
  const size_t part = ((size_t)b * tiles + tile) * q.nruns + run;
  const size_t sub = (size_t)tile * q.nruns + run;
  for (int i = threadIdx.x; i < (NT + 2) * q.CG; i += blockDim.x) {
    const int cc = c0 + i % q.CG, k_ = i / q.CG;
    if (cc >= q.C) continue;
    float s = 0.f;
    for (int rr = 0; rr < q.rows; ++rr) s += red[(size_t)rr * (NT + 2) * q.CG + i];
    if (k_ < NT)
      part_dk[(part * NT + k_) * q.C + cc] = s;
    else
      (k_ == NT ? part_dzs : part_duu)[(sub * q.C + cc) * q.B + b] = s;
  }
}

// The second pass (common.cuh's sum_columns): blockIdx.y picks the pair
// (p0, o0) or (p1, o1).
__global__ void __launch_bounds__(32 * kSumLanes)
    dw_bn_act_conv_bwd_sum_kernel(const float* __restrict__ p0,
                                  float* __restrict__ o0,
                                  const float* __restrict__ p1,
                                  float* __restrict__ o1, int ncols,
                                  int nparts) {
  sum_columns(blockIdx.y ? p1 : p0, blockIdx.y ? o1 : o0, ncols, nparts);
}

template <typename T, int VE, int KT>
int launch_ring(const void* x, const void* y, const void* gy,
                const float* a_cb, const float* b_cb, const float* gp,
                const float* gs2, const float* taps, void* dx, float* part_dk,
                float* part_dzs, float* part_duu, float* dk, float* dzs,
                float* duu, RingGeom q, cudaStream_t stream) {
  auto kernel = dw_bn_act_conv_bwd_ring_kernel<T, VE, KT>;
  const size_t smem = ring_smem(q, sizeof(T), KT, VE);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int threads = 2 * ceil_div(q.CG / VE * q.rows, 32) * 32;
  const dim3 grid(ceil_div(q.C, q.CG) * q.nth * q.ntw, q.nruns, q.B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<const T*>(gy), a_cb, b_cb, gp, gs2, taps,
      static_cast<T*>(dx), part_dk, part_dzs, part_duu, q);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 lanes(32, kSumLanes);
  const int subs = q.nth * q.ntw * q.nruns;
  dw_bn_act_conv_bwd_sum_kernel<<<dim3(ceil_div(KT * 9 * q.C, 32), 1), lanes,
                                  0, stream>>>(part_dk, dk, nullptr, nullptr,
                                               KT * 9 * q.C, q.B * subs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dw_bn_act_conv_bwd_sum_kernel<<<dim3(ceil_div(q.C * q.B, 32), 2), lanes, 0,
                                  stream>>>(part_dzs, dzs, part_duu, duu,
                                            q.C * q.B, subs);
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

// The ring body's blocks an SM and the card's SMs, into out[0] and out[1],
// for a block of `threads` threads and `smem` bytes of dynamic shared memory.
extern "C" int x3d_dw_bn_act_conv_bwd_ring_occupancy(int dtype, int vec,
                                                     int kt, int threads,
                                                     int smem, void* out) {
  int* o = static_cast<int*>(out);
  return with_ring(dtype, vec, kt, [&](auto ring) {
    using R = decltype(ring);
    auto kernel =
        dw_bn_act_conv_bwd_ring_kernel<typename R::Elem, R::ve, R::kt>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel,
                                                          threads, smem);
    o[1] = sm_count();
    return (int)err;
  });
}

// K3 by the ring body: the arguments of x3d_dw_bn_act_conv_bwd for spatial
// taps 3x3 and kt in 1 .. 5, then the launch plan of ops/dw_fused.bwd_plan
// (tile sides, channels a group, channels a vector, thread rows, frames a
// run, copy granule in bytes, cells a staged row, cells padding each vector
// plane).  part_dk: (B, tiles, runs, taps, C); part_dzs,
// part_duu: (tiles, runs, C, B).  cudaErrorInvalidValue for a plan the
// kernel cannot run or pointers the granule does not divide.
extern "C" int x3d_dw_bn_act_conv_bwd_ring(
    const void* x, const void* y, const void* gy, const void* a_cb,
    const void* b_cb, const void* gp, const void* gs2, const void* taps,
    void* dx, void* part_dk, void* part_dzs, void* part_duu, void* dk,
    void* dzs, void* duu, int dtype, int B, int T, int H, int W, int C, int kt,
    int tile_h, int tile_w, int group, int vec, int rows, int run, int granule,
    int row_cells, int vec_pad, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  RingGeom q{B, T, H, W, C};
  if (!ring_geometry(q, elem, kt, vec, tile_h, tile_w, group, rows, run,
                     granule, row_cells, vec_pad))
    return cudaErrorInvalidValue;
  for (const void* p : {x, y, gy})
    if (reinterpret_cast<uintptr_t>(p) % granule) return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(dx) % (vec * elem)) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  return with_ring(dtype, vec, kt, [&](auto ring) {
    using R = decltype(ring);
    return launch_ring<typename R::Elem, R::ve, R::kt>(
        x, y, gy, f(a_cb), f(b_cb), f(gp), f(gs2), f(taps), dx, m(part_dk),
        m(part_dzs), m(part_duu), m(dk), m(dzs), m(duu), q, s);
  });
}
