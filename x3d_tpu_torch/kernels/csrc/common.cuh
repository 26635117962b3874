// Shared pieces of the port's kernels: element conversion, the depthwise
// kernels' block shape, the cp.async copies, and what the ring bodies (K1's,
// K2's, K3's, K4 dk's) share: their limits, geometry, instantiations, a
// cell's unpacking, the second pass, and K1's staging and walk, which K4
// dk's ring body runs too; and the temporal bodies' (K1's, K8's) cells.
// Every kernel here takes NDHWC activations (C contiguous) in float32 or
// bfloat16 and accumulates in float32.
#pragma once

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace x3d {

enum DType { kF32 = 0, kBF16 = 1 };

// A block covers kChannels consecutive channels, one per warp lane, so a
// warp's loads and stores touch consecutive addresses; its kWarps warps
// share the output pixels of the block's tile.
constexpr int kChannels = 32;
constexpr int kWarps = 8;
constexpr int kThreads = kChannels * kWarps;

// Shared memory a block may use on Hopper (H100: 227 KB).
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// v rounded to T's precision, returned as float32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The eval BatchNorm that a conv kernel may apply as it stores its output
// (K7, K2, K1): y = add[c] + round(acc) * mul[c] with float32 per-channel
// coefficients, then a ReLU where asked, rounded once to the output's
// dtype.  round(acc) is the conv's own output as the kernel stores it
// without the epilogue; the affine is the model's arithmetic on the card:
// for a float32 output a product and a sum, each rounded (x * mul + add),
// for a bfloat16 one a fused multiply-add in float32 (torch.addcmul's), so
// the output is the unfused conv then the model's affine.  mul == nullptr:
// no epilogue.  Every body takes it as a template parameter EP, and a
// source is built twice: as it always was, every body without the
// epilogue (EP false), and with X3D_BN_EPILOGUE, every body with it (EP
// true), a library of its own; so the launches without one (training's)
// run the code they ran before there was one.  mul and add are 16-byte
// aligned (with_epilogue checks).
struct BnEpilogue {
  const float* mul;
  const float* add;
  int relu;
};

// The bodies' EP in this build.
#ifdef X3D_BN_EPILOGUE
constexpr bool kBnEpilogue = true;
#else
constexpr bool kBnEpilogue = false;
#endif

// cudaErrorInvalidValue for an epilogue this build does not take (one
// asked of a build without, none of a build with X3D_BN_EPILOGUE) or whose
// coefficients the kernels cannot read (not 16-byte aligned, or one of the
// two missing); else fn(std::bool_constant<kBnEpilogue>{}), the EP
// instantiation of the launched body.
template <typename Fn>
int with_epilogue(const BnEpilogue& ep, Fn&& fn) {
  const uintptr_t m = reinterpret_cast<uintptr_t>(ep.mul),
                  a = reinterpret_cast<uintptr_t>(ep.add);
  if ((m != 0) != kBnEpilogue || (a != 0) != kBnEpilogue || (m | a) % 16)
    return cudaErrorInvalidValue;
  return fn(std::bool_constant<kBnEpilogue>{});
}

// The epilogue's float32 value for a sum `acc` of a T output and its
// channel's coefficients, for the store to round.
template <typename T>
__device__ __forceinline__ float bn_affine(float acc, float mul, float add,
                                           int relu) {
  const float x = round_to<T>(acc);
  const float v = std::is_same_v<T, float> ? __fadd_rn(__fmul_rn(x, mul), add)
                                           : __fmaf_rn(x, mul, add);
  return relu && v < 0.f ? 0.f : v;
}

// The same, channel c's coefficients read from the epilogue.
template <typename T>
__device__ __forceinline__ float bn_value(float acc, int c,
                                          const BnEpilogue& ep) {
  return bn_affine<T>(acc, __ldg(ep.mul + c), __ldg(ep.add + c), ep.relu);
}

// The bfloat16 epilogue on two sums (columns n, n + 1, their coefficients
// m and a): the float32 values for the store to round, bn_affine's values
// -- each sum rounded (one conversion for the pair), widened, a fused
// multiply-add -- with the ReLU as a maximum that keeps a NaN against `lo`
// (bn_floor: 0 for the ReLU, -inf for none; a ReLU'd -0 stores +0), so
// that the pair costs K7's wg and pipe bodies a few instructions a value.
__device__ __forceinline__ float bn_floor(const BnEpilogue& ep) {
  return ep.relu ? 0.f : __int_as_float(0xff800000);  // -inf
}

__device__ __forceinline__ float max_nan(float v, float lo) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  return r;
}

__device__ __forceinline__ float2 bn_pair(float v0, float v1, float2 m,
                                          float2 a, float lo) {
  const float2 x = __bfloat1622float2(__floats2bfloat162_rn(v0, v1));
  return make_float2(max_nan(__fmaf_rn(x.x, m.x, a.x), lo),
                     max_nan(__fmaf_rn(x.y, m.y, a.y), lo));
}

// VE consecutive float32 from p, a multiple of VE values into a 16-byte
// aligned vector: vector loads.
template <int VE>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VE]) {
  if constexpr (VE % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VE / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + i);
      v[4 * i] = t.x, v[4 * i + 1] = t.y, v[4 * i + 2] = t.z,
                 v[4 * i + 3] = t.w;
    }
  } else if constexpr (VE == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

// The sums of channels c .. c + VE - 1 (c a multiple of VE) rewritten by
// the epilogue.
template <typename T, int VE>
__device__ __forceinline__ void bn_cell(float (&v)[VE], int c,
                                        const BnEpilogue& ep) {
  float m[VE], a[VE];
  load_vec(ep.mul + c, m);
  load_vec(ep.add + c, a);
#pragma unroll
  for (int e = 0; e < VE; ++e) v[e] = bn_affine<T>(v[e], m[e], a[e], ep.relu);
}

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The card's SMs (0 if the runtime cannot say).
inline int sm_count() {
  static int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    return n;
  }();
  return sms;
}

// Let a kernel take `bytes` of dynamic shared memory (beyond the default
// 48 KB, which its static shared memory also counts against).
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (bytes <= 32 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// G bytes from global `src` to shared `dst`; zeros (and no read) if !valid.
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? G : 0;
  if constexpr (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(G), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// VE (1 or 2) consecutive elements of p, as float32 -- or stored from
// float32 into p, rounded to nearest even; a pair moves as one access.
__device__ __forceinline__ void load_f32(const float* p, float (&v)[1]) {
  v[0] = *p;
}
__device__ __forceinline__ void load_f32(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&v)[1]) {
  v[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p,
                                         float (&v)[2]) {
  const float2 t =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = t.x, v[1] = t.y;
}

__device__ __forceinline__ void store_f32(float* p, const float (&v)[1]) {
  *p = v[0];
}
__device__ __forceinline__ void store_f32(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p,
                                          const float (&v)[1]) {
  *p = __float2bfloat16(v[0]);
}
__device__ __forceinline__ void store_f32(__nv_bfloat16* p,
                                          const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// -------------------------------------- the ring bodies (K1, K2, K3, K4 dk)

constexpr int kRingMaxKt = 5;         // temporal taps a ring body takes
constexpr int kRingMaxVecs = 32;      // channel vectors a block owns
constexpr int kRingMaxThreads = 128;  // threads a role has (K3 two a block)
constexpr int kRingAhead = 1;         // planes in flight beyond the newest
constexpr int kSumLanes = 16;         // fixed chunks of a second-pass column

// Taps in shared memory rather than registers (ops/dw_fused.py mirrors this
// rule in its launch plans).
__host__ __device__ constexpr bool ring_taps_shared(int kt, int ve) {
  return kt * 9 * ve > 64;
}

// A ring-body call's geometry, from its plan (ops/ring.plan by way of
// ops/dw_fused.fwd_plan, bwd_plan and ops/depthwise.ring_plan).  T, H, W
// are the output's (K2's and K3's equal their input's).
struct RingGeom {
  int B, T, H, W, C;
  int TH, TW;      // a block's pixel tile
  int nth, ntw;    // tiles along H and W
  int CG;          // channels a block owns
  int rows;        // thread rows: a role has CG / VE * rows threads
  int TC, nruns;   // frames a run, runs along T
  int granule;     // bytes a copy moves: a cell, or an element (plain)
  int WP;          // cells a staged row: ring_cols and a pad
  int VP;          // cells between vector planes: ring_rows * WP and a pad
  int slot;        // cells of one ring slot: CG / VE vector planes
  int taps_at;     // byte offset of the taps in shared memory (if there)
};

// Staged rows of a tile of th output rows under 3 taps at stride s: the
// tile's and its halo's.
__host__ __device__ constexpr int ring_rows(int th, int s) {
  return (th - 1) * s + 3;
}

// The fewest cells a staged row takes for a tile of tw output columns at
// stride s, input columns in order: the tile's and its halo's, and at odd
// tw those that the idle half of its last pair of pixels reads.
__host__ __device__ constexpr int ring_cols(int tw, int s) {
  return s * (tw - 1 + tw % 2) + 3;
}

// Fills q from a plan, or returns false where a ring body cannot run it
// (`stride`, 1 or 2, is the spatial one: K1's ring body takes both).
inline bool ring_geometry(RingGeom& q, int elem, int kt, int ve, int tile_h,
                          int tile_w, int group, int rows, int run,
                          int granule, int row_cells, int vec_pad,
                          int stride = 1) {
  q.TH = tile_h, q.TW = tile_w, q.CG = group, q.rows = rows, q.TC = run;
  q.granule = granule;
  if (kt < 1 || kt > kRingMaxKt || (ve != 1 && ve != 2) || q.C % ve ||
      (stride != 1 && stride != 2) || tile_h < 1 || tile_w < 1 ||
      rows < 1 || run < 1 || group < ve || group % ve ||
      group / ve > kRingMaxVecs || group / ve * rows > kRingMaxThreads ||
      q.B > 65535 ||
      !(granule == elem || (granule == ve * elem && granule >= 4)) ||
      row_cells < ring_cols(tile_w, stride) || vec_pad < 0)
    return false;
  q.nth = ceil_div(q.H, q.TH);
  q.ntw = ceil_div(q.W, q.TW);
  q.nruns = ceil_div(q.T, q.TC);
  q.WP = row_cells;
  q.VP = ring_rows(q.TH, stride) * q.WP + vec_pad;
  const int cell = ve * elem;
  q.slot = ceil_div(group / ve * q.VP * cell, 16) * 16 / cell;
  return q.nruns <= 65535;
}

// Dynamic shared memory of a ring-body block: the body's `ring` bytes of
// slots, whose bytes its `red` bytes of row partials reuse after the
// frames, then the taps where they live there (their offset into q).
inline size_t ring_layout(RingGeom& q, size_t ring, size_t red, int kt,
                          int ve) {
  q.taps_at = (int)((std::max(ring, red) + 15) / 16 * 16);
  return q.taps_at +
         (ring_taps_shared(kt, ve) ? (size_t)9 * kt * q.CG * sizeof(float) : 0);
}

// A cell: one pixel's VE channels in shared memory, moved as one access.
template <typename T, int VE> struct CellOf { using type = T; };
template <> struct CellOf<float, 2> { using type = float2; };
template <> struct CellOf<__nv_bfloat16, 2> { using type = __nv_bfloat162; };

// A cell's VE channels as float32.  A bfloat16 pair unpacks by a shift and
// a mask, two instructions (the library's conversion takes three).
template <typename T, int VE>
__device__ __forceinline__ void cell_f32(const void* p, float (&v)[VE]) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && VE == 2) {
    const uint32_t bits = *static_cast<const uint32_t*>(p);
    v[0] = __uint_as_float(bits << 16);
    v[1] = __uint_as_float(bits & 0xffff0000u);
  } else {
    load_f32(static_cast<const T*>(p), v);
  }
}

template <typename T, int VE, int KT>
struct Ring {
  using Elem = T;
  static constexpr int ve = VE, kt = KT;
};

template <typename T, int VE, typename Fn>
int with_kt(int kt, Fn&& fn) {
  switch (kt) {
    case 1: return fn(Ring<T, VE, 1>{});
    case 2: return fn(Ring<T, VE, 2>{});
    case 3: return fn(Ring<T, VE, 3>{});
    case 4: return fn(Ring<T, VE, 4>{});
    case 5: return fn(Ring<T, VE, 5>{});
  }
  return cudaErrorInvalidValue;
}
static_assert(kRingMaxKt == 5, "with_kt covers kt 1 .. 5");

// fn(Ring<T, VE, KT>{}) for the instantiation a call takes.
template <typename Fn>
int with_ring(int dtype, int ve, int kt, Fn&& fn) {
  if (dtype == kF32)
    return ve == 2 ? with_kt<float, 2>(kt, fn) : with_kt<float, 1>(kt, fn);
  if (dtype == kBF16)
    return ve == 2 ? with_kt<__nv_bfloat16, 2>(kt, fn)
                   : with_kt<__nv_bfloat16, 1>(kt, fn);
  return cudaErrorInvalidValue;
}

// ------------------------------ the temporal bodies' cells (K1, K8)

// The unsigned word of N bytes, which moves a cell as one access.
template <int N> struct WordOf;
template <> struct WordOf<2> { using type = uint16_t; };
template <> struct WordOf<4> { using type = uint32_t; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<16> { using type = uint4; };

// A cell of VE elements of T as 32-bit words (a lone bfloat16 in the high
// half of one), so that unpacking is a shift, a mask or nothing.
template <typename T, int VE>
struct Cell32 {
  static constexpr int bytes = VE * (int)sizeof(T);
  static constexpr int words = bytes < 4 ? 1 : bytes / 4;
  uint32_t w[words];

  __device__ __forceinline__ void load(const T* p) {
    using Word = typename WordOf<bytes>::type;
    const Word v = *reinterpret_cast<const Word*>(p);
    if constexpr (bytes == 2) {
      w[0] = (uint32_t)v << 16;
    } else if constexpr (bytes == 4) {
      w[0] = v;
    } else if constexpr (bytes == 8) {
      w[0] = v.x, w[1] = v.y;
    } else {
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    }
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < words; ++i) w[i] = 0;
  }
  __device__ __forceinline__ void unpack(float (&v)[VE]) const {
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll
      for (int i = 0; i < VE; ++i) v[i] = __uint_as_float(w[i]);
    } else if constexpr (VE == 1) {
      v[0] = __uint_as_float(w[0]);
    } else {
#pragma unroll
      for (int i = 0; i < VE / 2; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
};

// VE float32 values rounded to T (nearest even) and stored as one access.
template <typename T, int VE>
__device__ __forceinline__ void store_cell(T* p, const float (&v)[VE]) {
  constexpr int bytes = VE * (int)sizeof(T);
  if constexpr (bytes == 2) {
    *p = __float2bfloat16(v[0]);
  } else {
    uint32_t w[bytes / 4];
    if constexpr (std::is_same_v<T, float>) {
#pragma unroll
      for (int i = 0; i < VE; ++i) w[i] = __float_as_uint(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < VE / 2; ++i) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    using Word = typename WordOf<bytes>::type;
    if constexpr (bytes == 4) {
      *reinterpret_cast<Word*>(p) = w[0];
    } else if constexpr (bytes == 8) {
      *reinterpret_cast<Word*>(p) = make_uint2(w[0], w[1]);
    } else {
      *reinterpret_cast<Word*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// fn(Ring<T, VE, KT>{}) (the instantiation tag above) for the temporal
// body a call takes (K1's or K8's): VE 1, 2, 4 (float32) or 1, 2, 4, 8
// (bfloat16) channels a cell, KT 1 .. kRingMaxKt.
template <typename Fn>
int with_temporal(int dtype, int ve, int kt, Fn&& fn) {
  if (dtype == kF32) {
    switch (ve) {
      case 1: return with_kt<float, 1>(kt, fn);
      case 2: return with_kt<float, 2>(kt, fn);
      case 4: return with_kt<float, 4>(kt, fn);
    }
  } else if (dtype == kBF16) {
    switch (ve) {
      case 1: return with_kt<__nv_bfloat16, 1>(kt, fn);
      case 2: return with_kt<__nv_bfloat16, 2>(kt, fn);
      case 4: return with_kt<__nv_bfloat16, 4>(kt, fn);
      case 8: return with_kt<__nv_bfloat16, 8>(kt, fn);
    }
  }
  return cudaErrorInvalidValue;
}

// --------------------------- the conv ring bodies' staging (K1, K4 dk)

// A conv ring-body call (K1's forward, K4's dk): the ring's geometry (its T,
// H, W the output's) and the input's frames, rows, columns and low pads.
struct ConvRing {
  RingGeom q;
  int T, H, W;
  int tlo, hlo, wlo;
};

// fn(Ring<T, VE, KT>{}, std::integral_constant<int, S>{}) for the
// instantiation a conv ring-body call takes (spatial stride S 1 or 2).
template <typename Fn>
int with_conv_ring(int dtype, int ve, int kt, int stride, Fn&& fn) {
  return with_ring(dtype, ve, kt, [&](auto ring) {
    if (stride == 1) return fn(ring, std::integral_constant<int, 1>{});
    if (stride == 2) return fn(ring, std::integral_constant<int, 2>{});
    return (int)cudaErrorInvalidValue;
  });
}

// The fill of a conv ring body's slots, by thread (cv, r) of a block whose
// tile's staged origin is input row hi0, column wi0; `vplane` is the
// thread's vector plane in a slot.  Built once a thread, so that what does
// not change from plane to plane is computed once.  fill(to, x, base) moves
// one input plane into the slot `to`, x + base being the thread's channels
// of the plane's first pixel: the thread moves its vector's cells of the
// staged rows, whole rows r, r + rows, ... up to the last multiple of rows
// (a cell's column only steps), then its share (i = r, r + rows, ...) of
// the cells of the rows left.  Cell (pr, pc) holds input column wi0 + pc of
// row hi0 + pr and sits pr * WP + pc into the vector plane; zeros outside
// the image (and for channels past C: `live` false).  A cell moves by
// cp.async where the plan's granule is a cell, else by plain loads, an
// element a time.
template <typename T, int VE, int S>
struct ConvRingFill {
  using Cell = typename CellOf<T, VE>::type;
  const ConvRing& g;
  int hi0, wi0, vplane, r, whole, left;
  bool live;

  __device__ __forceinline__ ConvRingFill(const ConvRing& g_, int hi0_,
                                          int wi0_, int vplane_, int r_,
                                          bool live_)
      : g(g_), hi0(hi0_), wi0(wi0_), vplane(vplane_), r(r_), live(live_) {
    const int srows = ring_rows(g.q.TH, S);
    whole = srows / g.q.rows * g.q.rows;
    left = (srows - whole) * g.q.WP;
  }

  __device__ __forceinline__ void operator()(Cell* to, const T* x,
                                             size_t base) const {
    const RingGeom& q = g.q;
    auto move = [&](int at, int hi, int wi, bool ok) {
      const T* from = x + (ok ? base + ((size_t)hi * g.W + wi) * q.C : 0);
      if constexpr (sizeof(Cell) >= 4) {
        if (q.granule == (int)sizeof(Cell)) {
          cp_async<sizeof(Cell)>(to + at, from, ok);
          return;
        }
      }
      T* e = reinterpret_cast<T*>(to + at);
#pragma unroll
      for (int i = 0; i < VE; ++i) e[i] = ok ? from[i] : from_f32<T>(0.f);
    };
    for (int pr = r; pr < whole; pr += q.rows) {
      const int hi = hi0 + pr, at = vplane + pr * q.WP;
      const bool row_in = live && hi >= 0 && hi < g.H;
      for (int pc = 0, wi = wi0; pc < q.WP; ++pc, ++wi)
        move(at + pc, hi, wi, row_in && wi >= 0 && wi < g.W);
    }
    for (int i = r; i < left; i += q.rows) {
      const int pr = whole + i / q.WP, pc = i % q.WP;
      const int hi = hi0 + pr, wi = wi0 + pc;
      move(vplane + pr * q.WP + pc, hi, wi,
           live && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W);
    }
  }
};

// A conv ring body's walk over its run of output frames t0 .. t1 - 1 of a
// clip with T input frames.  Output frame t reads input planes t - tlo ..
// t - tlo + KT - 1, so it is computed once plane p = t + hi_t has landed
// (hi_t = KT - 1 - tlo).  fetch(p + kRingAhead) issues plane p + kRingAhead
// (its own cp.async group) while frame p - hi_t is computed; its slot held
// plane p - KT, last read by frame p - hi_t - 1.  One barrier a plane: after
// it every cell of plane p has landed and frame p - hi_t - 1 is done.  (tlo
// <= KT - 1, so every frame's plane p is at or past p_lo.)  On return every
// copy has landed; the frames' reads of the ring need a barrier.
template <int KT, typename Fetch, typename Compute>
__device__ __forceinline__ void conv_ring_walk(int T, int tlo, int t0, int t1,
                                               Fetch&& fetch,
                                               Compute&& compute) {
  const int hi_t = KT - 1 - tlo;
  const int p_lo = max(0, t0 - tlo), p_hi = min(T - 1, t1 - 1 + hi_t);
  for (int j = 0; j < kRingAhead; ++j) {
    if (p_lo + j <= p_hi) fetch(p_lo + j);
    cp_async_commit();
  }
  for (int p = p_lo; p <= t1 - 1 + hi_t; ++p) {
    if (p <= p_hi) {
      cp_async_wait<kRingAhead - 1>();  // this thread's copies of plane p
      __syncthreads();
      if (p + kRingAhead <= p_hi) fetch(p + kRingAhead);
      cp_async_commit();  // an empty group past the end keeps the count
    }
    const int t = p - hi_t;
    if (t >= t0) compute(t);
  }
}

// A ring body's second pass, run by a block of (32, kSumLanes) threads:
// out[i] = sum over k < nparts of part[k * ncols + i], in double, in a fixed
// order: lane y of the block sums k = y, y + kSumLanes, ..., and the lanes
// are added in order.  Block x takes columns 32x .. 32x + 31.
__device__ __forceinline__ void sum_columns(const float* __restrict__ part,
                                            float* __restrict__ out,
                                            int ncols, int nparts) {
  __shared__ double lanes[kSumLanes][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  double s = 0.0;
  if (i < ncols)
    for (int k = threadIdx.y; k < nparts; k += kSumLanes)
      s += part[(size_t)k * ncols + i];
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < ncols) {
    double t = 0.0;
    for (int l = 0; l < kSumLanes; ++l) t += lanes[l][threadIdx.x];
    out[i] = (float)t;
  }
}

}  // namespace x3d
