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
// What bounds it on an H100: bytes.  At X3D widths (K, N between 24 and
// 432) a bf16 product does 2*K*N/(2*(K+N)) = 17 to 155 operations per byte,
// below the 295 at which the tensor cores (989 TFLOP/s) and device memory
// (3.35 TB/s) balance; the least time is x read once, y written once, at
// 3.35 TB/s.  The design:
//   * bfloat16 with an even K (every width of the model) runs on
//     pw_gemm.cuh's pipelined tensor-core body (pipe_gemm: W resident in
//     shared memory, x streamed through a cp.async ring over (row tile,
//     k-tile) pairs, mma.sync m16n8k16 with f32 accumulators, the copy
//     granule picked from K's alignment); a block owns all of N up to 192
//     columns, so K6's column tile covers all of its N (<= 192 in the
//     model), and K5's wider N (216, 432) is cut into tiles of up to 128;
//   * K6 applies its affine and swish to each A fragment in registers after
//     ldmatrix, so each element of u is computed once per block and never
//     goes to device memory; u is forced to 0 on rows past the sample and
//     at k >= K, since swish(b) != 0 where x was zero-filled; the sample's
//     coefficients for a k-tile travel in the ring beside it (64 floats a
//     stage), and the exponential runs in the special-function unit;
//   * row tiles (128 rows) never straddle two samples (each sample's S rows
//     are tiled on their own, the last tile masked), so a tile's column sums
//     belong to one (n, b) and its coefficients are one column;
//   * the sums come from the accumulator layout: a lane's two rows, shuffles
//     over the lanes of a column, the 8 warps in order through shared
//     memory; each tile writes one f32 partial of p and s2 per column, and a
//     second kernel sums a sample's partials in a fixed order, in double:
//     deterministic, no atomics;
//   * float32 (no TF32: the parity checks compare against full float32) and
//     bfloat16 with an odd K or unaligned pointers take the CUDA-core tile
//     product gemm_tile, 64 x 64 tiles, with the same sums.
// Not yet done (later work): wgmma and TMA, sharing B fragments between
// warps (the K = 432, N = 192 shape keeps one block an SM with a 3-stage
// ring: its W slice fills 175 KB of shared memory).

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

// The bfloat16 route's swish: the exponential in the special-function unit
// (a few float32 ulps, far below the bfloat16 rounding that follows) and a
// correctly rounded reciprocal.
__device__ __forceinline__ float fast_swish(float v) {
  return __fmul_rn(v, __frcp_rn(1.f + __expf(-v)));
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

int launch_sums(float* part_p, float* part_s2, float* p, float* s2,
                const PwGeom& q, cudaStream_t stream) {
  const int n = q.B * q.N;
  sum_partials_kernel<<<ceil_div(n, 256), 256, 0, stream>>>(
      part_p, part_s2, p, s2, q.B, q.N, q.tps);
  return cudaGetLastError();
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
  return launch_sums(part_p, part_s2, p, s2, q, stream);
}

// ------------------------------------------ bfloat16 on the tensor cores

using bf16 = __nv_bfloat16;

struct MmaGeom {
  int B, S;
  int tps;     // row tiles per sample, of kPipeBM rows
  int width;   // how y is stored (store_width)
};

// K5 (kAct false) and K6 on pipe_gemm; tile = b * tps + (row tile in b).
template <int G, int NT, bool kAct>
__device__ __forceinline__ void stats_tiles(
    const bf16* __restrict__ x, const float* __restrict__ a_cb,
    const float* __restrict__ b_cb, const bf16* __restrict__ w,
    bf16* __restrict__ y, float* __restrict__ part_p,
    float* __restrict__ part_s2, const MmaGeom& m, const PipeShape& q) {
  const int K = q.K, N = q.N;
  auto src = [&](int tile, int r) -> const bf16* {
    const int row = tile % m.tps * kPipeBM + r;
    return row < m.S ? x + ((size_t)(tile / m.tps) * m.S + row) * K : nullptr;
  };
  // K6's coefficient columns a[:, b] and b[:, b] for a k-tile travel in the
  // ring beside it: threads 0 .. kSideFloats - 1 copy one value each
  auto side = [&](int tile, int kt, float* dst) {
    if constexpr (kAct) {
      const int j = threadIdx.x;
      if (j < kSideFloats) {
        const int k = kt * kPipeBK + j % kPipeBK;
        const float* cb = j < kPipeBK ? a_cb : b_cb;
        const bool ok = k < K;
        cp_async<4>(dst + j, ok ? cb + (size_t)k * m.B + tile / m.tps : cb,
                    ok);
      }
    }
  };
  auto xform = [&](int tile, int r, int k, const float* coef,
                   uint32_t (&a)[4]) {
    if constexpr (kAct) {
      // u = swish(x a + b) rounded to bfloat16, 0 where the row or k does
      // not exist
      const int row = tile % m.tps * kPipeBM + r;
      const bool rows_ok[2] = {row < m.S, row + 8 < m.S};
#pragma unroll
      for (int i = 0; i < 4; ++i) {      // a[i]: row r + 8 (i & 1)
        float u[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int kk = (i >> 1) * 8 + h;   // columns k, k + 1, k + 8, k + 9
          const float xv = __uint_as_float(h ? a[i] & 0xffff0000u : a[i] << 16);
          u[h] = rows_ok[i & 1] && k + kk < K
                     ? fast_swish(__fadd_rn(__fmul_rn(xv, coef[kk]),
                                            coef[kPipeBK + kk]))
                     : 0.f;
        }
        const __nv_bfloat162 v = __floats2bfloat162_rn(u[0], u[1]);
        a[i] = *reinterpret_cast<const uint32_t*>(&v);
      }
    }
  };
  uint32_t* out = pipe_out(q);
  const int warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4;
  auto epi = [&](int tile, int n0, const float (&acc)[NT][4]) {
    const int r0 = tile % m.tps * kPipeBM + 16 * warp;
    bf16* yb = y + (size_t)(tile / m.tps) * m.S * N;
    store_tile(acc, out + warp * 16 * kOutWords, n0, q.nt, N, m.width,
               [&](int r) -> bf16* {
                 return r0 + r < m.S ? yb + (size_t)(r0 + r) * N : nullptr;
               });
    const size_t slot = (size_t)tile * N + n0;
    tile_sums(acc, out, r0 + g < m.S, r0 + g + 8 < m.S, q.nt,
              min(N - n0, 8 * q.nt), part_p + slot, part_s2 + slot);
  };
  pipe_gemm<G, NT>(w, q, src, side, xform, epi);
}

template <int G, int NT>
__global__ void __launch_bounds__(kPipeThreads) pw_conv_stats_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a_cb,
    const float* __restrict__ b_cb, const bf16* __restrict__ w,
    bf16* __restrict__ y, float* __restrict__ part_p,
    float* __restrict__ part_s2, MmaGeom m, PipeShape q) {
  stats_tiles<G, NT, false>(x, a_cb, b_cb, w, y, part_p, part_s2, m, q);
}

template <int G, int NT>
__global__ void __launch_bounds__(kPipeThreads) pw_act_conv_stats_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ a_cb,
    const float* __restrict__ b_cb, const bf16* __restrict__ w,
    bf16* __restrict__ y, float* __restrict__ part_p,
    float* __restrict__ part_s2, MmaGeom m, PipeShape q) {
  stats_tiles<G, NT, true>(x, a_cb, b_cb, w, y, part_p, part_s2, m, q);
}

using MmaKernel = void (*)(const bf16*, const float*, const float*,
                           const bf16*, bf16*, float*, float*, MmaGeom,
                           PipeShape);

// q.K, q.N set: the rest of the tiling, and the kernel; nullptr where the
// tensor-core body does not take the call.
MmaKernel plan_mma(bool act, uintptr_t bases, PipeShape& q) {
  if (!pipe_plan(q, bases)) return nullptr;
  return pipe_kernel(q, [&](auto g, auto nt) -> MmaKernel {
    constexpr int G = decltype(g)::value, NT = decltype(nt)::value;
    return act ? pw_act_conv_stats_mma_kernel<G, NT>
               : pw_conv_stats_mma_kernel<G, NT>;
  });
}

template <bool kAct>
int dispatch(const void* x, const void* a_cb, const void* b_cb, const void* w,
             void* y, void* part_p, void* part_s2, void* p, void* s2,
             int dtype, int B, int S, int K, int N, void* stream) {
  if (B <= 0 || S <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || ceil_div(N, kBN) > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* ptr) { return static_cast<const float*>(ptr); };
  auto m = [](void* ptr) { return static_cast<float*>(ptr); };
  if (dtype == kBF16) {
    PipeShape q{};
    q.K = K, q.N = N;
    const MmaKernel kernel = plan_mma(
        kAct, reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w),
        q);
    if (kernel != nullptr) {
      const MmaGeom g{B, S, ceil_div(S, kPipeBM),
                      store_width(N, reinterpret_cast<uintptr_t>(y))};
      if ((long long)B * g.tps > 2147483647LL) return cudaErrorInvalidValue;
      q.tiles = B * g.tps;
      const int rc = pipe_launch(
          kernel, q, s, static_cast<const bf16*>(x), f(a_cb), f(b_cb),
          static_cast<const bf16*>(w), static_cast<bf16*>(y), m(part_p),
          m(part_s2), g);
      if (rc != cudaSuccess) return rc;
      const PwGeom sums{B, S, K, N, g.tps};
      return launch_sums(m(part_p), m(part_s2), m(p), m(s2), sums, s);
    }
  }
  const PwGeom q{B, S, K, N, ceil_div(S, kBM)};
  if (dtype == kF32)
    return launch<float, kAct>(x, f(a_cb), f(b_cb), w, y, m(part_p),
                               m(part_s2), m(p), m(s2), q, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16, kAct>(x, f(a_cb), f(b_cb), w, y, m(part_p),
                                       m(part_s2), m(p), m(s2), q, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Row tiles per sample, the most either route uses (the tensor-core route's
// tiles are twice as tall): the wrapper allocates two (B, tiles, N) float32
// buffers for the partial sums.
extern "C" int x3d_pw_stats_tiles(int S) {
  return ceil_div(S, std::min(kBM, kPipeBM));
}

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

// How a bfloat16 call of K5 (act 0) or K6 (act 1) at widths K, N runs, with
// 16-byte aligned pointers: out[0..5] as pipe_report gives them, all 0 where
// the call takes the CUDA-core route.  Returns a cudaError_t code.
extern "C" int x3d_pw_stats_plan(int K, int N, int act, int* out) {
  PipeShape q{};
  q.K = K, q.N = N;
  for (int i = 0; i < 6; ++i) out[i] = 0;
  if (K <= 0 || N <= 0) return cudaErrorInvalidValue;
  const MmaKernel kernel = plan_mma(act != 0, 0, q);
  return kernel == nullptr ? cudaSuccess
                           : pipe_report((const void*)kernel, q, out);
}
