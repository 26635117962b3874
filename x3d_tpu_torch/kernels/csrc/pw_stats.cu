// K5 and K6: the bottleneck's 1x1x1 convs as GEMMs with a BN-sum epilogue,
// on NDHWC activations viewed as (B*S, K) rows (S = T*H*W, K = Cin, C
// contiguous) and weights (N = Cout, K):
//
//   K5 (pw_conv_stats):      y = x @ W^T
//   K6 (pw_act_conv_stats):  v = x * a[k, b] + bb[k, b]   (f32, per sample b)
//                            u = swish(v) = v * sigmoid(v) (rounded to x's dtype)
//                            y = u @ W^T
//   both:  p[n, b] = sum_s y32[b, s, n],  s2[n, b] = sum_s y32^2
//
// with y32 the f32 accumulator: the sums are taken before y is rounded to
// x's dtype.  K5 replaces the TPU kernel pw_batchminor._pw_stats_kernel
// (x3d_tpu/ops/pw_batchminor.py:132, launched by _run_stats at :167), K6
// replaces _pw_act_stats_kernel (:260, launched by _run_act_stats at :297).
// In the model, K5 is the expanding conv `a` (its sums give bn_a's batch
// statistics) and K6 the contracting conv `c`, whose (a, bb) columns carry
// bn_b's affine times the Squeeze-Excite gate (its sums give bn_c's).
//
// What bounds it on an H100: at X3D-M widths (K, N between 24 and 432) a
// bf16 product does 2*K*N/(2*(K+N)) = 17 to 155 operations per byte: below
// the tensor cores' 295, so bytes on the tensor cores -- but this first
// version multiplies on the CUDA cores in f32 (67 TFLOP/s), where the wider
// convs are bound by operations.  The design:
//   * a block computes a 64 x 64 tile of y (256 threads, 4 x 4 outputs each)
//     from 64 x 16 and 16 x 64 tiles of x and W staged in shared memory as
//     f32 (the body in pw_gemm.cuh, shared with K7); K6 applies its affine
//     and swish while it stages x, so u never goes to device memory;
//   * row tiles never straddle two samples (each sample's S rows are tiled
//     on their own, the last tile masked), so a block's column sums belong
//     to one (n, b) and the per-sample coefficients are one column;
//   * each block writes one f32 partial of p and s2 per column; a second
//     kernel sums a sample's partials in a fixed order, in double:
//     deterministic, no atomics.
// Not yet done (later work): mma.sync / wgmma on the tensor cores, TMA
// staging, wider loads.

#include "pw_gemm.cuh"

namespace {

using namespace x3d;

struct PwGeom {
  int B, S, K, N;
  int tps;  // row tiles per sample
};

__device__ __forceinline__ float swish(float v) {
  return __fmul_rn(v, 1.f / (1.f + expf(-v)));
}

template <typename T, bool kAct>
__global__ void __launch_bounds__(kGemmThreads)
    pw_stats_kernel(const T* __restrict__ x, const float* __restrict__ a_cb,
                    const float* __restrict__ b_cb, const T* __restrict__ w,
                    T* __restrict__ y, float* __restrict__ part_p,
                    float* __restrict__ part_s2, PwGeom q) {
  __shared__ GemmSmem sm;
  __shared__ float red_p[16][kBN], red_s2[16][kBN];

  const int n0 = blockIdx.y * kBN;
  const int tile = blockIdx.x % q.tps;
  const int b = blockIdx.x / q.tps;
  const int r0 = tile * kBM;                       // first row within sample
  const size_t row_base = (size_t)b * q.S;         // the sample's first row
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  // the tile's product, with the K6 affine and swish applied while x is
  // staged (the shared body: pw_gemm.cuh)
  gemm_tile<T>(
      w, n0, q.K, q.N,
      [&](int pass, int k) -> float {
        const int row = r0 + threadIdx.x / kBK + kRowsPerPass * pass;
        if (row >= q.S) return 0.f;
        float v = to_f32(x[(row_base + row) * q.K + k]);
        if (kAct) {
          const size_t kb = (size_t)k * q.B + b;
          v = round_to<T>(swish(__fadd_rn(__fmul_rn(v, a_cb[kb]), b_cb[kb])));
        }
        return v;
      },
      sm, acc);

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + tx + 16 * j;
    float sp = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty + 16 * i;
      if (row < q.S && n < q.N) {
        y[(row_base + row) * q.N + n] = from_f32<T>(acc[i][j]);
        sp += acc[i][j];
        ss = fmaf(acc[i][j], acc[i][j], ss);
      }
    }
    red_p[ty][tx + 16 * j] = sp;
    red_s2[ty][tx + 16 * j] = ss;
  }
  __syncthreads();
  if (threadIdx.x < kBN && n0 + threadIdx.x < q.N) {
    float sp = 0.f, ss = 0.f;
    for (int k = 0; k < 16; ++k) {
      sp += red_p[k][threadIdx.x];
      ss += red_s2[k][threadIdx.x];
    }
    const size_t slot = ((size_t)b * q.tps + tile) * q.N + n0 + threadIdx.x;
    part_p[slot] = sp;
    part_s2[slot] = ss;
  }
}

// p, s2: (N, B).  One thread per (column, sample), columns fastest; each sums
// its sample's tps partials in order, in double.
__global__ void sum_partials_kernel(const float* __restrict__ part_p,
                                    const float* __restrict__ part_s2,
                                    float* __restrict__ p,
                                    float* __restrict__ s2, int B, int N,
                                    int tps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * N) return;
  const int n = i % N, b = i / N;
  const size_t base = (size_t)b * tps * N + n;
  double sp = 0.0, ss = 0.0;
  for (int k = 0; k < tps; ++k) {
    sp += part_p[base + (size_t)k * N];
    ss += part_s2[base + (size_t)k * N];
  }
  p[(size_t)n * B + b] = (float)sp;
  s2[(size_t)n * B + b] = (float)ss;
}

template <typename T, bool kAct>
int launch(const void* x, const float* a_cb, const float* b_cb, const void* w,
           void* y, float* part_p, float* part_s2, float* p, float* s2,
           const PwGeom& q, cudaStream_t stream) {
  const dim3 grid(q.B * q.tps, ceil_div(q.N, kBN));
  pw_stats_kernel<T, kAct><<<grid, kGemmThreads, 0, stream>>>(
      static_cast<const T*>(x), a_cb, b_cb, static_cast<const T*>(w),
      static_cast<T*>(y), part_p, part_s2, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = q.B * q.N;
  sum_partials_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(
      part_p, part_s2, p, s2, q.B, q.N, q.tps);
  return cudaGetLastError();
}

template <bool kAct>
int dispatch(const void* x, const void* a_cb, const void* b_cb, const void* w,
             void* y, void* part_p, void* part_s2, void* p, void* s2,
             int dtype, int B, int S, int K, int N, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || ceil_div(N, kBN) > 65535) return cudaErrorInvalidValue;
  const PwGeom q{B, S, K, N, ceil_div(S, kBM)};
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  if (dtype == kF32)
    return launch<float, kAct>(x, f(a_cb), f(b_cb), w, y, m(part_p),
                               m(part_s2), m(p), m(s2), q, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kAct>(x, f(a_cb), f(b_cb), w, y, m(part_p),
                                       m(part_s2), m(p), m(s2), q, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Row tiles per sample: the wrapper allocates two (B, tiles, N) float32
// buffers for the partial sums.
extern "C" int x3d_pw_stats_tiles(int S) { return ceil_div(S, kBM); }

// K5.  x: (B*S, K) and y: (B*S, N) in `dtype` (0 float32, 1 bfloat16); w:
// (N, K) in `dtype`; p, s2: (N, B) float32; part_p, part_s2: scratch as
// above.  Returns a cudaError_t code.
extern "C" int x3d_pw_conv_stats(const void* x, const void* w, void* y,
                                 void* part_p, void* part_s2, void* p,
                                 void* s2, int dtype, int B, int S, int K,
                                 int N, void* stream) {
  return dispatch<false>(x, nullptr, nullptr, w, y, part_p, part_s2, p, s2,
                         dtype, B, S, K, N, stream);
}

// K6.  As K5, with a_cb, b_cb: (K, B) float32 coefficient columns.
extern "C" int x3d_pw_act_conv_stats(const void* x, const void* a_cb,
                                     const void* b_cb, const void* w, void* y,
                                     void* part_p, void* part_s2, void* p,
                                     void* s2, int dtype, int B, int S, int K,
                                     int N, void* stream) {
  return dispatch<true>(x, a_cb, b_cb, w, y, part_p, part_s2, p, s2, dtype, B,
                        S, K, N, stream);
}
