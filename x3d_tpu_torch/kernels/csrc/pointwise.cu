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
// What bounds it on an H100: at X3D widths (K, N between 24 and 432) a bf16
// product does 17 to 155 operations per byte, below the tensor cores' 295:
// bytes, as long as the product runs on the tensor cores; on the CUDA cores
// in f32 (67 TFLOP/s) the wider convs are bound by operations.  So there are
// two kernels on the tile products of pw_gemm.cuh, tiles laid over all rows
// at once (nothing here needs a tile to stay inside one sample), ragged K, N
// and M masked in the kernel, nothing padded in device memory, the column
// tiles of one row tile next to each other in launch order (they share x's
// rows through the L2 cache):
//   * bfloat16 with an even K (every width of the model): a 128 x 64 tile on
//     the tensor cores (mma.sync m16n8k16, f32 accumulators), A and W staged
//     as bfloat16 pairs, the next k-tile fetched while this one multiplies;
//   * float32 (no TF32: the parity checks compare against full float32) and
//     an odd K: K5's 64 x 64 CUDA-core product with the sum epilogue off.
// Not yet done (later work): wgmma, TMA / cp.async staging, 16-byte loads.

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

// A row of a warp's output tile in shared memory: kMmaBN bfloat16 = 32
// words, padded to 36 so that the 8 rows x 4 words a lane group writes fall
// into 32 banks.
constexpr int kOutStride = kMmaBN / 2 + 4;

// bfloat16, K even, on the tensor cores.
__global__ void __launch_bounds__(kMmaThreads)
    pw_conv_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ y, PwGeom q) {
  __shared__ MmaSmem sm;
  __shared__ uint32_t out[kMmaThreads / 32][16][kOutStride];
  const int n0 = (blockIdx.x % q.ntn) * kMmaBN;
  const long long m0 = (long long)(blockIdx.x / q.ntn) * kMmaBM;
  constexpr int kRows = kMmaThreads / (kMmaBK / 2);

  // the rows of x this thread stages, one per pass
  long long src[kMmaAWords];
#pragma unroll
  for (int p = 0; p < kMmaAWords; ++p)
    src[p] = source_row(m0 + threadIdx.x / (kMmaBK / 2) + kRows * p, q);

  float acc[kMmaNTiles][4] = {};
  mma_tile(
      w, n0, q.K, q.N,
      [&](int pass, int k) -> uint32_t {
        return src[pass] < 0 ? 0u
                             : *reinterpret_cast<const uint32_t*>(
                                   x + src[pass] * q.K + k);
      },
      sm, acc);

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  if (q.N % 2 == 0) {
    // Every pair of y is word-aligned.  A lane's accumulators sit 8 rows
    // by 4 pairs apart, which would store 16 bytes a row; each warp turns
    // its 16 x 64 tile through shared memory instead, so that one store
    // writes 128 contiguous bytes of a row.
    uint32_t (*tile)[kOutStride] = out[warp];
#pragma unroll
    for (int j = 0; j < kMmaNTiles; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 v =
            __floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]);
        tile[g + 8 * h][4 * j + t] = *reinterpret_cast<const uint32_t*>(&v);
      }
    __syncwarp();
    const int n = n0 + 2 * lane;
    if (n < q.N) {
#pragma unroll
      for (int row = 0; row < 16; ++row) {
        const long long m = m0 + 16 * warp + row;
        if (m < q.M)
          *reinterpret_cast<uint32_t*>(y + m * q.N + n) = tile[row][lane];
      }
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kMmaNTiles; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    if (n >= q.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = m0 + 16 * warp + g + 8 * h;
      if (m >= q.M) continue;
      y[m * q.N + n] = __float2bfloat16(acc[j][2 * h]);
      if (n + 1 < q.N) y[m * q.N + n + 1] = __float2bfloat16(acc[j][2 * h + 1]);
    }
  }
}

// Blocks in launch order: the column tiles of one row tile are neighbours, so
// the row tile of x they share is read from device memory once and from the
// L2 cache after that.  Returns 0 when the grid would not fit.
unsigned grid_size(PwGeom& q, int bm, int bn) {
  q.ntn = ceil_div(q.N, bn);
  const long long blocks = (q.M + bm - 1) / bm * q.ntn;
  return blocks > 2147483647LL ? 0u : (unsigned)blocks;
}

int launch_mma(const void* x, const void* w, void* y, PwGeom q,
               cudaStream_t stream) {
  const unsigned grid = grid_size(q, kMmaBM, kMmaBN);
  if (grid == 0) return cudaErrorInvalidValue;
  pw_conv_mma_kernel<<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(y),
      q);
  return cudaGetLastError();
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
    // the tensor-core kernel moves bfloat16 pairs as 4-byte words
    auto word_aligned = [](const void* ptr) {
      return reinterpret_cast<uintptr_t>(ptr) % 4 == 0;
    };
    const bool mma = K % 2 == 0 && word_aligned(x) && word_aligned(w) &&
                     word_aligned(y);
    return mma ? launch_mma(x, w, y, q, s)
               : launch<__nv_bfloat16>(x, w, y, q, s);
  }
  return cudaErrorInvalidValue;
}
