// K7: the plain 1x1x1 conv as a GEMM on NDHWC activations (C contiguous):
//
//   y[m, n] = sum_k x[row(m), k] * w[n, k]        m over B*T*Ho*Wo rows
//
// with x (B*T, H, W, K = Cin) and w (N = Cout, K) in float32 or bfloat16, the
// sum in float32 and y rounded once to x's dtype.  A strided projection
// (stride (1, sh, sw)) reads every sh-th row and sw-th column of x in place:
// row(m) = ((bt * H + ho * sh) * W + wo * sw) for m = (bt, ho, wo).  The
// backward's dx is the same kernel on the cotangent and the transposed
// weight.
//
// Replaces the TPU kernel pw_batchminor._pw_kernel
// (x3d_tpu/ops/pw_batchminor.py:56, launched by _run at :69).
//
// What bounds it on an H100: bytes.  At X3D widths (K, N between 24 and
// 432) a bf16 product does 17 to 155 operations per byte, below the 295 at
// which the tensor cores (989 TFLOP/s) and device memory (3.35 TB/s)
// balance; the least time is x's rows read once and y written once at
// 3.35 TB/s.  Three bodies, which the caller names (ops/pointwise.pw_body;
// none falls back to another):
//   * "wg" (x3d_pw_conv_wg): bfloat16, K % 8 == 0 (a row of x or W a
//     multiple of 16 bytes, as a TMA tensor map needs), 16-byte aligned x,
//     w and y, N even (N % 8 == 0 where N is cut into column tiles), not
//     the narrowest calls (K <= 32 with N <= 64) -- at X3D-M 43 of the 57
//     launches of a forward.  pw_wgmma.cuh's wg_gemm does away with what
//     bounds pipe_gemm at stages 4 and 5 (a whole W slice per block copied
//     before the first product and read by all 8 warps at every k-step;
//     62 blocks at stage 5): TMA into a 128-byte-swizzled ring, wgmma
//     reading each W k-tile once a warpgroup, W streamed or resident,
//     64- or 128-row tiles, column tiles and blocks an SM picked so that
//     the grid fills the card.  A strided projection whose pixels are whole
//     lines (K >= 64) is read in place by a rank-4 tensor map with element
//     strides (1, sw, sh, 1), a row tile being whole output rows of one
//     frame.  The epilogue rounds each sum once into one of two row buffers
//     in shared memory and writes it with one async copy, two tiles'
//     stores in flight: a bulk copy of the tile's contiguous rows where one
//     column tile covers N, else a TMA store;
//   * "pipe" (x3d_pw_conv, body 1): bfloat16 with an even K that the wg
//     body does not take -- K = 54, 108 (rows of 108 and 216 bytes, which
//     no tensor map describes), stage 2's conv a and the strided
//     projections of stages 2 to 4, where it measured faster on an H100;
//     a strided call reads its rows gathered by source_row in the cp.async
//     addresses -- on pw_gemm.cuh's pipe_gemm (W slice resident, x through
//     a cp.async ring over (row tile, k-tile) pairs, mma.sync m16n8k16, the
//     copy granule picked from K's alignment);
//   * "cuda_core" (x3d_pw_conv, body 0): float32 (no TF32: the parity checks
//     compare against full float32) and bfloat16 with an odd K or unaligned
//     pointers: K5's 64 x 64 CUDA-core product gemm_tile with the sum
//     epilogue off.
// Tiles are laid over all rows at once (nothing here needs a tile to stay
// inside one sample); ragged K, N and M are masked or zero-filled in the
// kernel, nothing is padded in device memory.
//
// Each body takes an optional BN epilogue (common.cuh's BnEpilogue): the
// eval BatchNorm after the conv, and a ReLU after it, applied to each value
// as it is rounded for the store, so that serving's BatchNorms after conv c,
// the projections, conv a at the stage entries and conv_5 make no pass of
// their own.  The bodies with it are built into a library of their own
// (X3D_BN_EPILOGUE), so that the calls without one (training's) run the
// code they ran before there was one.

#include "pw_gemm.cuh"
#include "pw_wgmma.cuh"

namespace {

using namespace x3d;

struct PwGeom {
  long long M;         // output rows
  int K, N;
  int H, W, Ho, Wo;    // input and output planes
  int sh, sw;          // strides along H and W
  int ntn;             // column tiles of the launched kernel
};

// Row of x (in rows of K values) that feeds output row m; -1 past the end.
__device__ __forceinline__ long long source_row(long long m, const PwGeom& q) {
  if (m >= q.M) return -1;
  if (q.sh == 1 && q.sw == 1) return m;
  const int wo = (int)(m % q.Wo);
  const long long r = m / q.Wo;
  const int ho = (int)(r % q.Ho);
  const long long bt = r / q.Ho;
  return (bt * q.H + (long long)ho * q.sh) * q.W + (long long)wo * q.sw;
}

template <typename T, bool EP>
__global__ void __launch_bounds__(kGemmThreads)
    pw_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, PwGeom q, BnEpilogue ep) {
  __shared__ GemmSmem sm;
  const int n0 = (blockIdx.x % q.ntn) * kBN;
  const long long m0 = (long long)(blockIdx.x / q.ntn) * kBM;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // the rows of x this thread stages, one per pass (-1: past the end)
  long long src[kRowPasses];
#pragma unroll
  for (int pass = 0; pass < kRowPasses; ++pass) {
    src[pass] =
        source_row(m0 + threadIdx.x / kBK + kRowsPerPass * pass, q);
  }

  float acc[4][4] = {};
  gemm_tile<T>(
      w, n0, q.K, q.N,
      [&](int pass, int k) -> float {
        return src[pass] < 0 ? 0.f : to_f32(x[src[pass] * q.K + k]);
      },
      sm, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= q.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= q.N) continue;
      if constexpr (EP) acc[i][j] = bn_value<T>(acc[i][j], n, ep);
      y[m * q.N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// bfloat16, K even, on the tensor cores: pipe_gemm over row tiles of
// kPipeBM output rows.
template <int G, int NT, bool EP>
__global__ void __launch_bounds__(kPipeThreads)
    pw_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, PwGeom g, int width,
                       BnEpilogue ep, PipeShape q) {
  using bf16 = __nv_bfloat16;
  auto src = [&](int tile, int r) -> const bf16* {
    const long long row = source_row((long long)tile * kPipeBM + r, g);
    return row < 0 ? nullptr : x + row * q.K;
  };
  auto no_side = [](int, int, float*) {};
  auto no_xform = [](int, int, int, const float*, uint32_t (&)[4]) {};
  uint32_t* out = pipe_out(q) + threadIdx.x / 32 * 16 * kOutWords;
  auto epi = [&](int tile, int n0, float (&acc)[NT][4]) {
    const long long m0 = (long long)tile * kPipeBM + threadIdx.x / 32 * 16;
    if constexpr (EP) {
      // the lane's columns n0 + 8 j + 2 t (+ 1), rows g and g + 8
      const int t = threadIdx.x % 4;
      const float lo = bn_floor(ep);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= q.nt) break;
        const int n = n0 + 8 * j + 2 * t;
        if (n >= q.N) continue;
        const bool pair = n + 1 < q.N;    // n is even: 8-byte aligned
        const float2 m = pair ? __ldg(reinterpret_cast<const float2*>(
                                    ep.mul + n))
                              : make_float2(__ldg(ep.mul + n), 0.f);
        const float2 a = pair ? __ldg(reinterpret_cast<const float2*>(
                                    ep.add + n))
                              : make_float2(__ldg(ep.add + n), 0.f);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 v =
              bn_pair(acc[j][2 * h], acc[j][2 * h + 1], m, a, lo);
          acc[j][2 * h] = v.x, acc[j][2 * h + 1] = v.y;
        }
      }
    }
    store_tile(acc, out, n0, q.nt, q.N, width, [&](int r) -> bf16* {
      return m0 + r < g.M ? y + (m0 + r) * q.N : nullptr;
    });
  };
  pipe_gemm<G, NT>(w, q, src, no_side, no_xform, epi);
}

using MmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                           __nv_bfloat16*, PwGeom, int, BnEpilogue,
                           PipeShape);

// q.K, q.N set: the rest of the tiling, and the kernel (with the BN
// epilogue or without: EP); nullptr where the tensor-core body does not
// take the call.
template <bool EP>
MmaKernel plan_mma(uintptr_t bases, PipeShape& q) {
  if (!pipe_plan(q, bases)) return nullptr;
  return pipe_kernel(q, [](auto g, auto nt) -> MmaKernel {
    return pw_conv_mma_kernel<decltype(g)::value, decltype(nt)::value, EP>;
  });
}

// Blocks in launch order: the column tiles of one row tile are neighbours, so
// the row tile of x they share is read from device memory once and from the
// L2 cache after that.  Returns 0 when the grid would not fit.
unsigned grid_size(PwGeom& q, int bm, int bn) {
  q.ntn = ceil_div(q.N, bn);
  const long long blocks = (q.M + bm - 1) / bm * q.ntn;
  return blocks > 2147483647LL ? 0u : (unsigned)blocks;
}

template <typename T>
int launch(const void* x, const void* w, void* y, PwGeom q, BnEpilogue ep,
           cudaStream_t stream) {
  const unsigned grid = grid_size(q, kBM, kBN);
  if (grid == 0) return cudaErrorInvalidValue;
  return with_epilogue(ep, [&](auto e) -> int {
    pw_conv_kernel<T, decltype(e)::value><<<grid, kGemmThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<T*>(y), q, ep);
    return cudaGetLastError();
  });
}


// bfloat16 on wgmma and TMA: pw_wgmma.cuh's wg_gemm over row tiles of
// 64 CONS rows and column tiles of BN columns.  A finished 64-row tile is
// rounded once into one of the warpgroup's kWgOutBufs y buffers and leaves
// by an async copy that the warpgroup's first thread issues, so that
// kWgOutBufs tiles' stores are in flight: where one column tile covers N,
// the buffer holds the tile's rows of y as they lie in device memory (rows
// of N values) and one bulk copy writes them (the lanes store the values
// past its last 16 bytes); else a TMA store of the box through ymap.  A
// buffer is written again only after its last copy has read it.
template <int BN, int CONS, bool EP>
__global__ void __launch_bounds__(128 * CONS + 32, 1)
    pw_conv_wg_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap ymap,
                      __nv_bfloat16* __restrict__ y, const WgShape q,
                      const BnEpilogue ep) {
  using bf16 = __nv_bfloat16;
  unsigned char* base = wg_base();
  bf16* bufs = reinterpret_cast<bf16*>(base + wg_out_offset(BN, CONS, q));
  const int pitch = q.nct == 1 ? q.N : BN;
  int done = 0;                            // tiles this thread has stored
  // the epilogue's coefficients of the block's columns, into shared memory
  // once (wg_gemm's first barrier orders them before any tile's store):
  // read there a column step at a time, after the step before has stored,
  // they hold no registers for the columns still to come
  float4* coefs =
      reinterpret_cast<float4*>(base + wg_coef_offset(BN, CONS, q));
  if constexpr (EP) {
    const int n0 = BN * (blockIdx.x % q.nct), cols = min(BN, q.N - n0);
    const float2* mul = reinterpret_cast<const float2*>(ep.mul + n0);
    const float2* add = reinterpret_cast<const float2*>(ep.add + n0);
    for (int i = threadIdx.x; 2 * i < cols; i += blockDim.x) {
      const float2 m = __ldg(mul + i), a = __ldg(add + i);
      coefs[i] = make_float4(m.x, m.y, a.x, a.y);
    }
  }
  auto epi = [&](long long m0, int rows, int n0, const float (&acc)[BN / 2],
                 int cg) {
    bf16* out = bufs + (size_t)(kWgOutBufs * cg + done % kWgOutBufs) *
                           kWgRows * BN;
    ++done;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int cols = min(BN, q.N - n0);
    if (t == 0) bulk_wait_read<kWgOutBufs - 1>();
    named_sync(1 + cg, 128);
    const int g = lane / 4, c2 = 2 * (lane % 4);
    // the epilogue's coefficients of columns n0 + 8 j + c2 (+ 1), each
    // step's read one step ahead of its use
    const float lo = EP ? bn_floor(ep) : 0.f;
    float4 cf_next{};
    if constexpr (EP) cf_next = coefs[lane % 4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = 8 * j + c2;
      const float4 cf = cf_next;
      if constexpr (EP) {
        if (j + 1 < BN / 8) cf_next = coefs[4 * (j + 1) + lane % 4];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        if (r < rows && c < cols) {        // cols is even
          float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          if constexpr (EP)
            v = bn_pair(v.x, v.y, make_float2(cf.x, cf.y),
                        make_float2(cf.z, cf.w), lo);
          *reinterpret_cast<__nv_bfloat162*>(out + r * pitch + c) =
              __floats2bfloat162_rn(v.x, v.y);
        }
      }
    }
    fence_proxy_async();
    named_sync(1 + cg, 128);
    if (warp == 0 && rows > 0) {
      if (q.nct == 1) {
        // rows x N contiguous values; the copy takes whole 16-byte units
        bf16* dst = y + m0 * q.N;
        const int n = rows * q.N, bulk = n & ~7;
        if (lane == 0 && bulk > 0) bulk_store(dst, out, 2 * bulk);
        for (int e = bulk + lane; e < n; e += 32) dst[e] = out[e];
      } else if (lane == 0) {
        tma_store_2d(&ymap, n0, (int)m0, out);
      }
    }
    // one group a tile, empty where the warpgroup has no rows in it, so
    // that the wait above counts tiles and the buffer it frees is this one's
    if (t == 0) bulk_commit();
  };
  wg_gemm<BN, CONS>(xmap, wmap, q, base, epi);
  // the stores still in flight have read their buffers before the block's
  // shared memory goes
  if (threadIdx.x < 128 * CONS && threadIdx.x % 128 == 0) bulk_wait_read<0>();
}

// cuTensorMapEncodeTiled, from the runtime's driver entry point (no link
// against the driver library); nullptr where the driver has none.
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (rows, cols) bfloat16 matrix, rows of `cols` values, as a 2-D tensor
// map with boxes of box_cols x box_rows, in the 128-byte swizzle (loads for
// wgmma) or dense (y's stores); reads outside the matrix fill zeros, writes
// outside it are dropped.
bool bf16_map(CUtensorMap* map, const void* base, int cols, long long rows,
              int box_cols, int box_rows, bool swizzle) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                        : CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// x (frames, H, W, K) in bfloat16 as a 4-D tensor map whose box is kWgBK
// values of every sw-th column of W and every sh-th of sh r rows of one
// frame (TMA's element strides), in the 128-byte swizzle: r output rows
// of Wo values, read in place.
bool strided_map(CUtensorMap* map, const void* base, int K, int W, int H,
                 long long frames, int sh, int sw, int r) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)frames};
  const cuuint64_t strides[3] = {(cuuint64_t)K * 2, (cuuint64_t)W * K * 2,
                                 (cuuint64_t)H * W * K * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kWgBK, (cuuint32_t)W,
                             (cuuint32_t)(sh * r), 1};
  const cuuint32_t steps[4] = {1, (cuuint32_t)sw, (cuuint32_t)sh, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, int CONS, bool EP>
int wg_launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
              const CUtensorMap& ymap, void* y, const WgShape& q,
              const BnEpilogue& ep, cudaStream_t stream) {
  const auto kernel = pw_conv_wg_kernel<BN, CONS, EP>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  kernel<<<q.slots * q.nct, 128 * CONS + 32, wg_smem(BN, CONS, q, EP),
           stream>>>(
      xmap, wmap, ymap, static_cast<__nv_bfloat16*>(y), q, ep);
  return cudaGetLastError();
}

}  // namespace

// K7's "pipe" (body 1) and "cuda_core" (body 0) bodies.  x: (BT, H, W, K)
// and y: (BT, Ho, Wo, N) in `dtype` (0 float32, 1 bfloat16), with Ho =
// ceil(H / sh) and Wo = ceil(W / sw); w: (N, K) in `dtype`; mul, add: (N,)
// float32, 16-byte aligned, the BN epilogue (common.cuh's BnEpilogue, with
// a ReLU where `relu`), or null for none.  The pipe body
// takes bfloat16 with an even K and x, w at least 4-byte aligned, and
// returns cudaErrorInvalidValue for any other call.  Returns a cudaError_t
// code.
extern "C" int x3d_pw_conv(const void* x, const void* w, void* y, int dtype,
                           long long BT, int H, int W, int K, int N, int sh,
                           int sw, int body, const void* mul,
                           const void* add, int relu, void* stream) {
  if (BT <= 0 || H <= 0 || W <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || sh <= 0 || sw <= 0) return cudaErrorInvalidValue;
  PwGeom q{};
  q.K = K, q.N = N, q.H = H, q.W = W, q.sh = sh, q.sw = sw;
  q.Ho = ceil_div(H, sh), q.Wo = ceil_div(W, sw);
  q.M = BT * q.Ho * q.Wo;
  auto s = static_cast<cudaStream_t>(stream);
  const BnEpilogue ep{static_cast<const float*>(mul),
                      static_cast<const float*>(add), relu};
  if (body == 0) {
    if (dtype == kF32) return launch<float>(x, w, y, q, ep, s);
    if (dtype == kBF16) return launch<__nv_bfloat16>(x, w, y, q, ep, s);
    return cudaErrorInvalidValue;
  }
  if (body != 1 || dtype != kBF16) return cudaErrorInvalidValue;
  const long long tiles = (q.M + kPipeBM - 1) / kPipeBM;
  if (tiles > 2147483647LL) return cudaErrorInvalidValue;
  return with_epilogue(ep, [&](auto e) -> int {
    PipeShape p{};
    p.K = K, p.N = N;
    const MmaKernel kernel = plan_mma<decltype(e)::value>(
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w), p);
    if (kernel == nullptr) return cudaErrorInvalidValue;
    p.tiles = (int)tiles;
    return pipe_launch(kernel, p, s, static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w),
                       static_cast<__nv_bfloat16*>(y), q,
                       store_width(N, reinterpret_cast<uintptr_t>(y)), ep);
  });
}

// K7's "wg" body in bfloat16: x (BT, H, W, K), y (BT, Ho, Wo, N) with Ho =
// ceil(H / sh), Wo = ceil(W / sw), w (N, K); as ops/pointwise.wg_plan lays
// it out: column tiles of `bn` columns (an instantiated width), `nct` of
// them; row tiles of at most 64 `cons` rows -- at stride 1 of x as a
// (BT H W, K) matrix (r = 0), else r whole output rows of one frame, read
// in place; `slots` row-tile slots (blocks = slots * nct); `stages` ring
// stages; W resident or streamed; mul, add, relu the BN epilogue, as
// x3d_pw_conv takes it.  Returns cudaErrorInvalidValue for a call
// the body does not take (K % 8, unaligned pointers, rows past what a TMA
// coordinate holds, N odd or, cut into column tiles, not a multiple of 8; a
// strided read wider than a tensor-map box or cut into column tiles: its
// row tiles stop inside a frame, which only the bulk copy of a tile's
// contiguous rows follows) or a plan that does not cover
// N, does not fit a row tile or does not fit in shared memory; else a
// cudaError_t code.
extern "C" int x3d_pw_conv_wg(const void* x, const void* w, void* y,
                              long long BT, int H, int W, int K, int N,
                              int sh, int sw, int bn, int cons, int nct,
                              int slots, int stages, int w_resident, int r,
                              const void* mul, const void* add, int relu,
                              void* stream) {
  if (BT <= 0 || H <= 0 || W <= 0 || N <= 0) return cudaSuccess;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(y);
  const bool strided = sh != 1 || sw != 1;
  WgShape q{};
  q.K = K, q.N = N, q.sh = sh;
  q.Ho = ceil_div(H, max(sh, 1)), q.Wo = ceil_div(W, max(sw, 1));
  q.M = BT * q.Ho * q.Wo;
  if (K <= 0 || K % 8 != 0 || bases % 16 != 0 || sh < 1 || sw < 1 ||
      (cons != 1 && cons != 2) || nct < 1 || slots < 1 ||
      (long long)(nct - 1) * bn >= N || (long long)nct * bn < N ||
      (nct == 1 ? N % 2 : N % 8) != 0 || stages < 2 ||
      stages > kWgMaxStages || (long long)slots * nct > INT_MAX ||
      BT * H * W > INT_MAX)
    return cudaErrorInvalidValue;
  q.r = strided ? r : 0;
  if (strided && (r < 1 || (long long)r * q.Wo > kWgRows * cons ||
                  sh > 8 || sw > 8 || W > 256 || sh * r > 256 || nct != 1))
    return cudaErrorInvalidValue;
  q.tpf = strided ? ceil_div(q.Ho, r) : 0;
  const long long tiles = strided ? BT * q.tpf
                                  : (q.M + kWgRows * cons - 1) /
                                        (kWgRows * cons);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  q.tiles = (int)tiles;
  q.x_bytes = (uint32_t)(strided ? r * q.Wo : kWgRows * cons) * kWgRowBytes;
  q.nk = ceil_div(K, kWgBK);
  q.nct = nct;
  q.slots = slots, q.stages = stages, q.w_resident = w_resident != 0;
  if (wg_smem(bn, cons, q, mul != nullptr) > kMaxSmem)
    return cudaErrorInvalidValue;
  // y's map only where N is cut into column tiles (one covering N stores
  // its contiguous rows by a bulk copy)
  CUtensorMap xmap, wmap, ymap{};
  if (!(strided ? strided_map(&xmap, x, K, W, H, BT, sh, sw, r)
                : bf16_map(&xmap, x, K, q.M, kWgBK, kWgRows * cons, true)) ||
      !bf16_map(&wmap, w, K, N, kWgBK, bn, true) ||
      (nct > 1 && !bf16_map(&ymap, y, N, q.M, bn, kWgRows, false)))
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const BnEpilogue ep{static_cast<const float*>(mul),
                      static_cast<const float*>(add), relu};
  return with_epilogue(ep, [&](auto e) -> int {
    constexpr bool EP = decltype(e)::value;
    return wg_by_columns(
        bn,
        [&](auto b) -> int {
          constexpr int BN = decltype(b)::value;
          return cons == 1
                     ? wg_launch<BN, 1, EP>(xmap, wmap, ymap, y, q, ep, s)
                     : wg_launch<BN, 2, EP>(xmap, wmap, ymap, y, q, ep, s);
        },
        (int)cudaErrorInvalidValue);
  });
}

// Dynamic shared memory of a wg call laid out as above (as wg_plan counts
// it), or -1 for a width that has no instantiation.
extern "C" int x3d_pw_conv_wg_smem(int K, int bn, int cons, int stages,
                                   int w_resident) {
  WgShape q{};
  q.nk = ceil_div(K, kWgBK), q.stages = stages, q.w_resident = w_resident;
  return wg_by_columns(
      bn, [&](auto) -> int { return (int)wg_smem(bn, cons, q); }, -1);
}

// How a bfloat16 call at widths K, N runs, with 16-byte aligned pointers:
// out[0..5] as pipe_report gives them, all 0 where the call takes the
// CUDA-core route.  Returns a cudaError_t code.
extern "C" int x3d_pw_conv_plan(int K, int N, int* out) {
  PipeShape q{};
  q.K = K, q.N = N;
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const MmaKernel kernel = plan_mma<kBnEpilogue>(0, q);
  return kernel == nullptr ? cudaSuccess
                           : pipe_report((const void*)kernel, q, out);
}
