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
// 3.35 TB/s.  Two routes, ragged K, N and M masked in the kernel, nothing
// padded in device memory, tiles laid over all rows at once (nothing here
// needs a tile to stay inside one sample):
//   * bfloat16 with an even K (every width of the model): pw_gemm.cuh's
//     pipelined tensor-core body (pipe_gemm: the block's W slice resident in
//     shared memory, x streamed through a cp.async ring over (row tile,
//     k-tile) pairs so that where K is small the next row tile's loads
//     overlap this one's product and stores, mma.sync m16n8k16 with f32
//     accumulators, the copy granule picked from K's alignment, y written
//     in 16-byte vectors where N % 8 == 0); a strided projection's rows are
//     gathered by source_row in the cp.async addresses, so it is read in
//     place; the column tiles of one row-tile slot are neighbours in launch
//     order (they read the same rows of x at about the same time);
//   * float32 (no TF32: the parity checks compare against full float32) and
//     bfloat16 with an odd K or unaligned pointers: K5's 64 x 64 CUDA-core
//     product gemm_tile with the sum epilogue off.
// Not yet done (later work): wgmma and TMA, sharing B fragments between
// warps.

#include "pw_gemm.cuh"

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

template <typename T>
__global__ void __launch_bounds__(kGemmThreads)
    pw_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, PwGeom q) {
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
      if (n < q.N) y[m * q.N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

// bfloat16, K even, on the tensor cores: pipe_gemm over row tiles of
// kPipeBM output rows.
template <int G, int NT>
__global__ void __launch_bounds__(kPipeThreads)
    pw_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, PwGeom g, int width,
                       PipeShape q) {
  using bf16 = __nv_bfloat16;
  auto src = [&](int tile, int r) -> const bf16* {
    const long long row = source_row((long long)tile * kPipeBM + r, g);
    return row < 0 ? nullptr : x + row * q.K;
  };
  auto no_side = [](int, int, float*) {};
  auto no_xform = [](int, int, int, const float*, uint32_t (&)[4]) {};
  uint32_t* out = pipe_out(q) + threadIdx.x / 32 * 16 * kOutWords;
  auto epi = [&](int tile, int n0, const float (&acc)[NT][4]) {
    const long long m0 = (long long)tile * kPipeBM + threadIdx.x / 32 * 16;
    store_tile(acc, out, n0, q.nt, q.N, width, [&](int r) -> bf16* {
      return m0 + r < g.M ? y + (m0 + r) * q.N : nullptr;
    });
  };
  pipe_gemm<G, NT>(w, q, src, no_side, no_xform, epi);
}

using MmaKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*,
                           __nv_bfloat16*, PwGeom, int, PipeShape);

// q.K, q.N set: the rest of the tiling, and the kernel; nullptr where the
// tensor-core body does not take the call.
MmaKernel plan_mma(uintptr_t bases, PipeShape& q) {
  if (!pipe_plan(q, bases)) return nullptr;
  return pipe_kernel(q, [](auto g, auto nt) -> MmaKernel {
    return pw_conv_mma_kernel<decltype(g)::value, decltype(nt)::value>;
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
int launch(const void* x, const void* w, void* y, PwGeom q,
           cudaStream_t stream) {
  const unsigned grid = grid_size(q, kBM, kBN);
  if (grid == 0) return cudaErrorInvalidValue;
  pw_conv_kernel<T><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      q);
  return cudaGetLastError();
}

}  // namespace

// K7.  x: (BT, H, W, K) and y: (BT, Ho, Wo, N) in `dtype` (0 float32,
// 1 bfloat16), with Ho = ceil(H / sh) and Wo = ceil(W / sw); w: (N, K) in
// `dtype`.  Returns a cudaError_t code.
extern "C" int x3d_pw_conv(const void* x, const void* w, void* y, int dtype,
                           long long BT, int H, int W, int K, int N, int sh,
                           int sw, void* stream) {
  if (BT <= 0 || H <= 0 || W <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || sh <= 0 || sw <= 0) return cudaErrorInvalidValue;
  PwGeom q{};
  q.K = K, q.N = N, q.H = H, q.W = W, q.sh = sh, q.sw = sw;
  q.Ho = ceil_div(H, sh), q.Wo = ceil_div(W, sw);
  q.M = BT * q.Ho * q.Wo;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return launch<float>(x, w, y, q, s);
  if (dtype == kBF16) {
    PipeShape p{};
    p.K = K, p.N = N;
    const MmaKernel kernel = plan_mma(
        reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w), p);
    if (kernel == nullptr) return launch<__nv_bfloat16>(x, w, y, q, s);
    const long long tiles = (q.M + kPipeBM - 1) / kPipeBM;
    if (tiles > 2147483647LL) return cudaErrorInvalidValue;
    p.tiles = (int)tiles;
    return pipe_launch(kernel, p, s, static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(w),
                       static_cast<__nv_bfloat16*>(y), q,
                       store_width(N, reinterpret_cast<uintptr_t>(y)));
  }
  return cudaErrorInvalidValue;
}

// How a bfloat16 call at widths K, N runs, with 16-byte aligned pointers:
// out[0..5] as pipe_report gives them, all 0 where the call takes the
// CUDA-core route.  Returns a cudaError_t code.
extern "C" int x3d_pw_conv_plan(int K, int N, int* out) {
  PipeShape q{};
  q.K = K, q.N = N;
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const MmaKernel kernel = plan_mma(0, q);
  return kernel == nullptr ? cudaSuccess
                           : pipe_report((const void*)kernel, q, out);
}
