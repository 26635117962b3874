// K1: depthwise 3-D convolution forward on NDHWC activations.
//
//   y[b, to, ho, wo, c] = sum_{dt,dh,dw} xpad[b, to*st+dt, ho*sh+dh, wo*sw+dw, c]
//                                        * k[dt, dh, dw, c]
//
// Replaces the TPU kernels dw_batchminor._fwd_kernel
// (x3d_tpu/ops/dw_batchminor.py:101) and pallas_dw._fwd_kernel
// (x3d_tpu/ops/pallas_dw.py:97), which computed the stride-1 SAME case in a
// batch-minor and a dense-row layout and kept a temporal ring of planes in
// VMEM.  K1 also takes the stem's k x 1 x 1 temporal conv and the stride-2
// stage-entry convs (which the JAX package left to XLA), any strides and
// explicit low pads (the high pads follow from the output size).
//
// What bounds it on an H100: bytes.  A 3x3x3 conv does 27 FMAs (54 flop) per
// output element and moves 4 bytes per element in bf16 (2 read, 2 written):
// 13.5 flop/byte, under the 20 flop/byte at which the CUDA cores' 67 TFLOP/s
// f32 rate would take over from 3.35 TB/s.  The stride-2 and 5x1x1 convs move
// more bytes per FMA still.  So each body aims at reading each input element
// from device memory once and writing each output once.  Three bodies,
// picked by the wrapper (ops/depthwise.fwd_body); every K1 launch of X3D
// takes one of the first two:
//   * temporal body (x3d_dw_conv3d_fwd_temporal): spatial taps 1x1 at
//     stride 1 (the stem's conv_t, kt <= kRingMaxKt).  The spatial taps are
//     1x1, so no pixel shares an input with another and shared memory buys
//     nothing: a thread owns one pixel's cell of VE channels (16 bytes where
//     C x elem and both addresses allow, narrower otherwise; common.cuh's
//     Cell32, which K8's temporal body shares) and walks a run
//     of frames, reading each input frame of the run once (and kt - 1 halo
//     frames a run) with one vector load, and keeping KT running sums in
//     registers: input frame r adds into the sums of outputs r - dt, and the
//     sum of output r - kt + 1, then complete, is stored and cleared.  The
//     loop is unrolled by KT, so every sum's register is fixed; the KT loads
//     of an unrolled step are issued before their sums.  The bytes bound it;
//     what remains is the loads in flight a thread keeps;
//   * ring body (x3d_dw_conv3d_fwd_ring): spatial taps 3x3 at temporal
//     stride 1 and spatial stride S = 1 or 2, kt <= kRingMaxKt, low pads 0 or
//     1 in H and W (the four stride-2 stage entries, at even and odd planes).
//     K2's ring staging (dw_fused.cu) without its affine and sums: a block
//     owns one clip, an output tile, a group of channel vectors (VE = 2
//     channels, 1 at odd C) and a run of frames; each input plane enters a
//     shared-memory ring of KT + kRingAhead slots once per block, halo
//     included, by cp.async (a cell a copy; plain loads where x's address
//     does not allow it), with row and vector-plane pitches the plan pads
//     against bank conflicts (the fill and the walk live in common.cuh,
//     ConvRingFill and conv_ring_walk, and serve K4 dk's ring body too; the
//     fill is built once a thread, so what does not change from plane to
//     plane is computed once: per plane it cost K1 16%, PERF.md §6).
//     A thread owns a vector and one output row of the tile and walks it in
//     runs of four pixels, then pairs, taps in registers (in shared memory
//     where KT * 9 * VE > 64).  At S = 2 a tile
//     of TH x TW outputs stages (2 TH + 1) x (2 TW + 1) input pixels, input
//     columns in order, so a run of four outputs reads nine consecutive
//     cells a tap row (staging even and odd columns apart measured slower,
//     PERF.md §6).  What holds it is K2's: the fill and the multiply-adds
//     do not overlap (one barrier a plane);
//   * generic body (x3d_dw_conv3d_fwd): every other geometry.  A block owns
//     one output frame `to` of one clip, an 8x8 (stride 1) or 4x4 (stride 2)
//     tile of output pixels and 32 channels; it stages the kt x HR x WR x 32
//     input halo in f32 in shared memory with scalar loads (out-of-image
//     elements as zero), threads along the contiguous C, and each output
//     element sums its taps from shared memory.  Each input plane is staged
//     once for each of the kt output frames that read it.
// Every body takes an optional BN epilogue (common.cuh's BnEpilogue):
// serving's BatchNorm after the stem's conv (with its ReLU) and bn_b at the
// stage entries, applied to y as it is stored.  The bodies with it are
// built into a library of their own (X3D_BN_EPILOGUE), so that training's
// calls run the code they ran before there was one.
// Not yet done (later work): the ring body's fill overlapping its
// multiply-adds (a producer warp, TMA) and wider copies (its fill alone
// takes about twice its input bytes' time); a temporal window in the
// generic body.

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

using namespace x3d;

struct DwGeom {
  int B, T, H, W, C;      // input
  int kt, kh, kw;         // taps
  int st, sh, sw;         // strides
  int tlo, hlo, wlo;      // low-side pads
  int To, Ho, Wo;         // output
  int TH, TW;             // output rows / columns per block
  int HR, WR;             // input rows / columns per block, halo included
  int nth, ntw, nct;      // tiles along H, W, C
};

template <typename T, bool EP>
__global__ void __launch_bounds__(kThreads)
    dw_conv3d_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ taps,
                         T* __restrict__ y, DwGeom g, BnEpilogue ep) {
  extern __shared__ float smem[];
  float* tile = smem;  // [kt][HR][WR][kChannels]
  float* wts = smem + (size_t)g.kt * g.HR * g.WR * kChannels;  // [taps][kChannels]

  int bx = blockIdx.x;
  const int tw = bx % g.ntw;
  bx /= g.ntw;
  const int th = bx % g.nth;
  const int ct = bx / g.nth;
  const int to = blockIdx.y;
  const int b = blockIdx.z;
  const int c0 = ct * kChannels;
  const int ho0 = th * g.TH, wo0 = tw * g.TW;
  const int ti0 = to * g.st - g.tlo;
  const int hi0 = ho0 * g.sh - g.hlo;
  const int wi0 = wo0 * g.sw - g.wlo;
  const int ntaps = g.kt * g.kh * g.kw;

  for (int i = threadIdx.x; i < ntaps * kChannels; i += blockDim.x) {
    const int c = c0 + i % kChannels;
    wts[i] = c < g.C ? taps[(size_t)(i / kChannels) * g.C + c] : 0.f;
  }
  const int n = g.kt * g.HR * g.WR * kChannels;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int c = c0 + i % kChannels;
    int r = i / kChannels;
    const int wi = wi0 + r % g.WR;
    r /= g.WR;
    const int hi = hi0 + r % g.HR;
    const int ti = ti0 + r / g.HR;
    float v = 0.f;
    if (c < g.C && ti >= 0 && ti < g.T && hi >= 0 && hi < g.H && wi >= 0 &&
        wi < g.W)
      v = to_f32(x[(((size_t)(b * g.T + ti) * g.H + hi) * g.W + wi) * g.C + c]);
    tile[i] = v;
  }
  __syncthreads();

  const int lane = threadIdx.x % kChannels;
  const int c = c0 + lane;
  if (c >= g.C) return;
  for (int p = threadIdx.x / kChannels; p < g.TH * g.TW; p += kWarps) {
    const int oh = p / g.TW, ow = p % g.TW;
    const int ho = ho0 + oh, wo = wo0 + ow;
    if (ho >= g.Ho || wo >= g.Wo) continue;
    float acc = 0.f;
    for (int dt = 0; dt < g.kt; ++dt)
      for (int dh = 0; dh < g.kh; ++dh) {
        const float* row =
            tile + (((size_t)dt * g.HR + oh * g.sh + dh) * g.WR + ow * g.sw) *
                       kChannels + lane;
        const float* w = wts + (dt * g.kh + dh) * g.kw * kChannels + lane;
        for (int dw = 0; dw < g.kw; ++dw)
          acc = fmaf(row[dw * kChannels], w[dw * kChannels], acc);
      }
    if constexpr (EP) acc = bn_value<T>(acc, c, ep);
    y[(((size_t)(b * g.To + to) * g.Ho + ho) * g.Wo + wo) * g.C + c] =
        from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* x, const float* taps, void* y, const DwGeom& g,
           const BnEpilogue& ep, cudaStream_t stream) {
  const size_t smem = ((size_t)g.kt * g.HR * g.WR + (size_t)g.kt * g.kh * g.kw) *
                      kChannels * sizeof(float);
  return with_epilogue(ep, [&](auto e) -> int {
    const auto kernel = dw_conv3d_fwd_kernel<T, decltype(e)::value>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid(g.nct * g.nth * g.ntw, g.To, g.B);
    kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), taps,
                                             static_cast<T*>(y), g, ep);
    return cudaGetLastError();
  });
}

// ------------------------------------------------------- temporal body

constexpr int kTemporalThreads = 256;

// A temporal-body call: a thread owns one cell (VE channels of one pixel)
// of one clip and a run of TC output frames.
struct TemporalGeom {
  int B, T, C;          // input clips, frames, channels
  int tlo;              // the low temporal pad
  int To;               // output frames
  long long cells;      // cells a frame: H * W * C / VE
  int TC, nruns;        // frames a run, runs along To
};

// Registers: at most 128 a thread, so that two blocks of 256 share an SM.
template <typename T, int VE, int KT, bool EP>
__global__ void __launch_bounds__(kTemporalThreads, 2)
    dw_conv3d_fwd_temporal_kernel(const T* __restrict__ x,
                                  const float* __restrict__ taps,
                                  T* __restrict__ y, TemporalGeom g,
                                  BnEpilogue ep) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= g.B * g.cells) return;
  const int b = (int)(i / g.cells);
  const long long cell = i % g.cells;
  const int c = (int)(cell % (g.C / VE)) * VE;
  const int t0 = blockIdx.y * g.TC, t1 = min(t0 + g.TC, g.To);
  const size_t frame = (size_t)g.cells * VE;
  const T* xp = x + (size_t)b * g.T * frame + (size_t)cell * VE;
  T* yp = y + ((size_t)b * g.To + t0) * frame + (size_t)cell * VE;

  float w[KT][VE];
#pragma unroll
  for (int dt = 0; dt < KT; ++dt)
#pragma unroll
    for (int e = 0; e < VE; ++e) w[dt][e] = taps[(size_t)dt * g.C + c + e];

  // Input r of the run is frame t0 - tlo + r; it completes output r - KT + 1
  // (outputs before 0 are never stored).  acc[m % KT] sums output m.
  const int first = t0 - g.tlo, n_in = t1 - t0 + KT - 1;
  float acc[KT][VE] = {};
  for (int r0 = 0; r0 < n_in; r0 += KT) {
    Cell32<T, VE> in[KT];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      const int ti = first + r0 + j;
      if (r0 + j < n_in && ti >= 0 && ti < g.T)
        in[j].load(xp + (size_t)ti * frame);
      else
        in[j].zero();
    }
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (r0 + j >= n_in) break;
      float v[VE];
      in[j].unpack(v);
#pragma unroll
      for (int dt = 0; dt < KT; ++dt)
#pragma unroll
        for (int e = 0; e < VE; ++e) {
          float& s = acc[(j - dt + KT) % KT][e];
          s = fmaf(v[e], w[dt][e], s);
        }
      const int m = r0 + j - (KT - 1);
      float (&done)[VE] = acc[(j + 1) % KT];
      if (m >= 0) {
        if constexpr (EP) bn_cell<T>(done, c, ep);
        store_cell(yp + (size_t)m * frame, done);
      }
#pragma unroll
      for (int e = 0; e < VE; ++e) done[e] = 0.f;
    }
  }
}

template <typename T, int VE, int KT>
int launch_temporal(const void* x, const float* taps, void* y,
                    const TemporalGeom& g, const BnEpilogue& ep,
                    cudaStream_t stream) {
  const long long n = g.B * g.cells;
  const dim3 grid((unsigned)((n + kTemporalThreads - 1) / kTemporalThreads),
                  g.nruns);
  return with_epilogue(ep, [&](auto e) -> int {
    dw_conv3d_fwd_temporal_kernel<T, VE, KT, decltype(e)::value>
        <<<grid, kTemporalThreads, 0, stream>>>(
            static_cast<const T*>(x), taps, static_cast<T*>(y), g, ep);
    return cudaGetLastError();
  });
}

// ----------------------------------------------------------- ring body

// Dynamic shared memory of a ring-body block: KT + kRingAhead slots of x,
// then the taps where they live there.
size_t conv_ring_smem(RingGeom& q, int elem, int kt, int ve) {
  return ring_layout(q, (size_t)(kt + kRingAhead) * q.slot * ve * elem, 0,
                     kt, ve);
}

// Registers: at most 128 a thread, so that four blocks of 128 threads (the
// plan's most) share an SM.
template <typename T, int VE, int KT, int S, bool EP>
__global__ void __launch_bounds__(kRingMaxThreads, 4)
    dw_conv3d_fwd_ring_kernel(const T* __restrict__ x,
                              const float* __restrict__ taps,
                              T* __restrict__ y, ConvRing g, BnEpilogue ep) {
  using Cell = typename CellOf<T, VE>::type;
  const RingGeom& q = g.q;
  constexpr int NT = KT * 9;
  constexpr bool kSharedTaps = ring_taps_shared(KT, VE);
  constexpr int SL = KT + kRingAhead;  // ring slots
  extern __shared__ __align__(16) unsigned char conv_ring_smem_[];
  Cell* ring = reinterpret_cast<Cell*>(conv_ring_smem_);  // [SL][slot]
  float* wsm = reinterpret_cast<float*>(conv_ring_smem_ + q.taps_at);

  int bx = blockIdx.x;
  const int tw = bx % q.ntw;
  bx /= q.ntw;
  const int th = bx % q.nth;
  const int c0 = bx / q.nth * q.CG;
  const int t0 = blockIdx.y * q.TC, t1 = min(t0 + q.TC, q.T);
  const int b = blockIdx.z;
  const int h0 = th * q.TH, w0 = tw * q.TW;  // the output tile's origin
  const int hi0 = h0 * S - g.hlo, wi0 = w0 * S - g.wlo;  // staged origin
  // thread (cv, r): vector cv of the group at tile rows r, r + rows, ...
  const int nv = q.CG / VE;
  const bool active = threadIdx.x < nv * q.rows;
  const int cv = threadIdx.x % nv, r = threadIdx.x / nv;
  const int c = c0 + cv * VE;
  const bool live = active && c < q.C;  // at VE 2, C is even: c + 1 < C
  const int vplane = cv * q.VP;  // the thread's vector plane in a slot
  const size_t in_frame = (size_t)g.H * g.W * q.C;
  const size_t out_frame = (size_t)q.H * q.W * q.C;

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

  // Input plane p into slot p % SL (common.cuh's ConvRingFill).
  const ConvRingFill<T, VE, S> fill(g, hi0, wi0, vplane, r, live);
  auto fetch = [&](int p) {
    if (active)
      fill(ring + (p % SL) * q.slot, x,
           (size_t)(b * g.T + p) * in_frame + c);
  };

  // Output frame t along rows r, r + rows, ...: runs of N = 4 pixels, then
  // pairs for the rest of the row.  A run reads S (N - 1) + 3 consecutive
  // cells of each staged row it needs, and cell j feeds pixel k's tap
  // dw = j - S k.
  auto compute = [&](int t) {
    T* out = y + (size_t)(b * q.T + t) * out_frame + c;
    int plane[KT];  // the slot of input plane t - tlo + dt, or -1 outside
#pragma unroll
    for (int dt = 0; dt < KT; ++dt) {
      const int tp = t - g.tlo + dt;
      plane[dt] = tp >= 0 && tp < g.T ? (tp % SL) * q.slot + vplane : -1;
    }
    const int cols = min(q.TW, q.W - w0);  // the tile's columns in the image
    // pixels ow .. ow + N - 1 of row oh, the first `valid` of them stored
    auto run = [&](auto n_tag, int oh, int ow, int valid) {
      constexpr int N = decltype(n_tag)::value;
      float acc[N][VE] = {};
#pragma unroll
      for (int dt = 0; dt < KT; ++dt) {
        if (plane[dt] < 0) continue;  // x is zero there
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
          const Cell* row = ring + plane[dt] + (S * oh + dh) * q.WP + S * ow;
#pragma unroll
          for (int j = 0; j < S * (N - 1) + 3; ++j) {
            float v[VE];
            cell_f32<T>(row + j, v);
#pragma unroll
            for (int k = 0; k < N; ++k)
              if (j - S * k >= 0 && j - S * k < 3)
#pragma unroll
                for (int e = 0; e < VE; ++e)
                  acc[k][e] =
                      fmaf(v[e], wt[3 * dh + j - S * k][e], acc[k][e]);
          }
        }
      }
      T* px = out + ((size_t)(h0 + oh) * q.W + w0 + ow) * q.C;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < valid) {
          if constexpr (EP) bn_cell<T>(acc[k], c, ep);
          store_f32(px + (size_t)k * q.C, acc[k]);
        }
    };
    for (int oh = r; oh < q.TH && h0 + oh < q.H; oh += q.rows) {
      int ow = 0;
      for (; ow + 4 <= cols; ow += 4)
        run(std::integral_constant<int, 4>{}, oh, ow, 4);
      for (; ow < cols; ow += 2)
        run(std::integral_constant<int, 2>{}, oh, ow, min(2, cols - ow));
    }
  };

  conv_ring_walk<KT>(g.T, g.tlo, t0, t1, fetch, [&](int t) {
    if (live) compute(t);
  });
}

template <typename T, int VE, int KT, int S>
int launch_conv_ring(const void* x, const float* taps, void* y, ConvRing g,
                     const BnEpilogue& ep, cudaStream_t stream) {
  const size_t smem = conv_ring_smem(g.q, sizeof(T), KT, VE);
  return with_epilogue(ep, [&](auto e) -> int {
    auto kernel = dw_conv3d_fwd_ring_kernel<T, VE, KT, S, decltype(e)::value>;
    const cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const RingGeom& q = g.q;
    const int threads = ceil_div(q.CG / VE * q.rows, 32) * 32;
    const dim3 grid(ceil_div(q.C, q.CG) * q.nth * q.ntw, q.nruns, q.B);
    kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x), taps,
                                            static_cast<T*>(y), g, ep);
    return cudaGetLastError();
  });
}

}  // namespace

// x: (B, T, H, W, C) in `dtype` (0 float32, 1 bfloat16); taps: (kt*kh*kw, C)
// float32; y: (B, To, Ho, Wo, C) in `dtype`; mul, add: (C,) float32,
// 16-byte aligned, the BN epilogue (common.cuh's BnEpilogue, with a ReLU
// where `relu`), or null for none.  Returns a cudaError_t code.
extern "C" int x3d_dw_conv3d_fwd(const void* x, const void* taps, void* y,
                                 int dtype, int B, int T, int H, int W, int C,
                                 int kt, int kh, int kw, int st, int sh, int sw,
                                 int tlo, int hlo, int wlo, int To, int Ho,
                                 int Wo, const void* mul, const void* add,
                                 int relu, void* stream) {
  DwGeom g{B, T, H, W, C, kt, kh, kw, st, sh, sw, tlo, hlo, wlo, To, Ho, Wo};
  if (B <= 0 || To <= 0 || Ho <= 0 || Wo <= 0 || C <= 0) return cudaSuccess;
  if (st <= 0 || sh <= 0 || sw <= 0 || kt <= 0 || kh <= 0 || kw <= 0 ||
      To > 65535 || B > 65535)
    return cudaErrorInvalidValue;
  g.TH = sh >= 8 ? 1 : 8 / sh;
  g.TW = sw >= 8 ? 1 : 8 / sw;
  g.HR = (g.TH - 1) * sh + kh;
  g.WR = (g.TW - 1) * sw + kw;
  g.nth = ceil_div(Ho, g.TH);
  g.ntw = ceil_div(Wo, g.TW);
  g.nct = ceil_div(C, kChannels);
  auto s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(taps);
  const BnEpilogue ep{static_cast<const float*>(mul),
                      static_cast<const float*>(add), relu};
  if (dtype == kF32) return launch<float>(x, w, y, g, ep, s);
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, w, y, g, ep, s);
  return cudaErrorInvalidValue;
}

// The temporal body's blocks an SM and the card's SMs, into out[0] and
// out[1], for `vec` channels a cell and kt temporal taps (blocks of
// kTemporalThreads threads, no shared memory).
extern "C" int x3d_dw_conv3d_fwd_temporal_occupancy(int dtype, int vec,
                                                    int kt, void* out) {
  int* o = static_cast<int*>(out);
  return with_temporal(dtype, vec, kt, [&](auto inst) {
    using I = decltype(inst);
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o[0],
        dw_conv3d_fwd_temporal_kernel<typename I::Elem, I::ve, I::kt,
                                      kBnEpilogue>,
        kTemporalThreads, 0);
    o[1] = sm_count();
    return (int)err;
  });
}

// K1 by the temporal body: x (B, T, H, W, C), taps (kt, C) float32, y (B,
// To, H, W, C), for spatial taps 1x1 at stride 1 and no spatial pads; tlo
// the low temporal pad; then the plan of ops/depthwise.temporal_plan
// (channels a cell, frames a run); the BN epilogue's mul, add, relu.
// cudaErrorInvalidValue for a plan the kernel cannot run or addresses a
// cell does not divide.
extern "C" int x3d_dw_conv3d_fwd_temporal(const void* x, const void* taps,
                                          void* y, int dtype, int B, int T,
                                          int H, int W, int C, int kt,
                                          int tlo, int To, int vec, int run,
                                          const void* mul, const void* add,
                                          int relu, void* stream) {
  if (B <= 0 || To <= 0 || H <= 0 || W <= 0 || C <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  if (T <= 0 || kt < 1 || kt > kRingMaxKt || tlo < 0 || vec < 1 ||
      C % vec || run < 1 || B > 65535 ||
      reinterpret_cast<uintptr_t>(x) % (vec * elem) ||
      reinterpret_cast<uintptr_t>(y) % (vec * elem))
    return cudaErrorInvalidValue;
  TemporalGeom g{B, T, C, tlo, To, (long long)H * W * (C / vec), run,
                 ceil_div(To, run)};
  if (g.nruns > 65535 ||
      (g.B * g.cells + kTemporalThreads - 1) / kTemporalThreads > INT32_MAX)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(taps);
  const BnEpilogue ep{static_cast<const float*>(mul),
                      static_cast<const float*>(add), relu};
  return with_temporal(dtype, vec, kt, [&](auto inst) {
    using I = decltype(inst);
    return launch_temporal<typename I::Elem, I::ve, I::kt>(x, w, y, g, ep,
                                                            s);
  });
}

// The ring body's blocks an SM and the card's SMs, into out[0] and out[1],
// for a block of `threads` threads and `smem` bytes of dynamic shared
// memory.
extern "C" int x3d_dw_conv3d_fwd_ring_occupancy(int dtype, int vec, int kt,
                                                int stride, int threads,
                                                int smem, void* out) {
  int* o = static_cast<int*>(out);
  return with_conv_ring(dtype, vec, kt, stride, [&](auto ring, auto s) {
    using R = decltype(ring);
    auto kernel = dw_conv3d_fwd_ring_kernel<typename R::Elem, R::ve, R::kt,
                                            decltype(s)::value, kBnEpilogue>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[0], kernel,
                                                          threads, smem);
    o[1] = sm_count();
    return (int)err;
  });
}

// K1 by the ring body: the arguments of x3d_dw_conv3d_fwd for spatial taps
// 3x3 at strides (1, s, s) with s 1 or 2, kt in 1 .. 5, low pads tlo <=
// kt - 1 and hlo, wlo 0 or 1; then the launch plan of
// ops/depthwise.ring_plan (tile sides, channels a group, channels a
// vector, thread rows, frames a run, copy granule in bytes, cells a staged
// row, cells padding each vector plane); the BN epilogue's mul, add, relu.
// cudaErrorInvalidValue for a geometry or plan the kernel cannot run or
// pointers the granule does not divide.
extern "C" int x3d_dw_conv3d_fwd_ring(
    const void* x, const void* taps, void* y, int dtype, int B, int T,
    int H, int W, int C, int kt, int stride, int tlo, int hlo, int wlo,
    int To, int Ho, int Wo, int tile_h, int tile_w, int group, int vec,
    int rows, int run, int granule, int row_cells, int vec_pad,
    const void* mul, const void* add, int relu, void* stream) {
  if (B <= 0 || To <= 0 || Ho <= 0 || Wo <= 0 || C <= 0) return cudaSuccess;
  if (dtype != kF32 && dtype != kBF16) return cudaErrorInvalidValue;
  const int elem = dtype == kF32 ? 4 : 2;
  ConvRing g{{B, To, Ho, Wo, C}, T, H, W, tlo, hlo, wlo};
  if (T <= 0 || H <= 0 || W <= 0 || tlo < 0 || tlo > kt - 1 || hlo < 0 ||
      hlo > 1 || wlo < 0 || wlo > 1 ||
      !ring_geometry(g.q, elem, kt, vec, tile_h, tile_w, group, rows, run,
                     granule, row_cells, vec_pad, stride))
    return cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(x) % granule ||
      reinterpret_cast<uintptr_t>(y) % (vec * elem))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(taps);
  const BnEpilogue ep{static_cast<const float*>(mul),
                      static_cast<const float*>(add), relu};
  return with_conv_ring(dtype, vec, kt, stride, [&](auto ring, auto st) {
    using R = decltype(ring);
    return launch_conv_ring<typename R::Elem, R::ve, R::kt,
                            decltype(st)::value>(x, w, y, g, ep, s);
  });
}
