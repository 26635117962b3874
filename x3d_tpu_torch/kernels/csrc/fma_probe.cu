// K9: the multiply-add rate probe.  Every element of a block of data
// goes through a chain of `unroll * inner` dependent multiply-adds
// v = v * a + b, with one read and one write of the block:
//
//   float32:   fmaf, one element per instruction and lane
//   bfloat16:  __hfma2 on __nv_bfloat162, two elements per instruction and lane
//
// Replaces the TPU kernel of vpu_probe.probe (x3d_tpu/tools/vpu_probe.py:40,
// launched at :55), which asked the same question of the TPU's vector unit:
// does packed bfloat16 arithmetic run at twice the float32 rate?
//
// What bounds it on an H100: operations -- 2 * unroll * inner per element
// against 2 * itemsize bytes; the float32 peak outside the tensor cores is
// 67 TFLOP/s = 33.5e12 multiply-adds per second.  The design: a thread keeps
// 8 values (float32) or 8 pairs (bfloat16) in registers, so 8 independent
// chains hide the multiply-add's latency; the chain loop is unrolled `unroll`
// times by the compiler (a template parameter) and runs `inner` times; a and b
// are kernel arguments held in registers.

#include "common.cuh"

namespace {

using namespace x3d;

constexpr int kProbeThreads = 256;
constexpr int kPerThread = 8;   // float32 values, or bfloat16 pairs, a thread

template <int kUnroll>
__global__ void __launch_bounds__(kProbeThreads)
    fma_chain_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                         float a, float b, int inner, long long n) {
  const long long i0 =
      ((long long)blockIdx.x * kProbeThreads + threadIdx.x) * kPerThread;
  float v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) v[j] = i0 + j < n ? x[i0 + j] : 0.f;
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) v[j] = fmaf(v[j], a, b);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (i0 + j < n) y[i0 + j] = v[j];
}

// n counts pairs: x and y hold 2 n bfloat16 values.
template <int kUnroll>
__global__ void __launch_bounds__(kProbeThreads)
    fma_chain_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                          __nv_bfloat162* __restrict__ y, float a, float b,
                          int inner, long long n) {
  const long long i0 =
      ((long long)blockIdx.x * kProbeThreads + threadIdx.x) * kPerThread;
  const __nv_bfloat162 a2 = __float2bfloat162_rn(a);
  const __nv_bfloat162 b2 = __float2bfloat162_rn(b);
  __nv_bfloat162 v[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    v[j] = i0 + j < n ? x[i0 + j] : __float2bfloat162_rn(0.f);
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) v[j] = __hfma2(v[j], a2, b2);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (i0 + j < n) y[i0 + j] = v[j];
}

template <int kUnroll>
int launch(const void* x, void* y, int dtype, long long n, float a, float b,
           int inner, cudaStream_t stream) {
  if (dtype == kF32) {
    const long long per = (long long)kProbeThreads * kPerThread;
    fma_chain_f32_kernel<kUnroll>
        <<<(unsigned)((n + per - 1) / per), kProbeThreads, 0, stream>>>(
            static_cast<const float*>(x), static_cast<float*>(y), a, b, inner,
            n);
    return cudaGetLastError();
  }
  if (dtype == kBF16) {
    const long long pairs = n / 2;
    const long long per = (long long)kProbeThreads * kPerThread;
    fma_chain_bf16_kernel<kUnroll>
        <<<(unsigned)((pairs + per - 1) / per), kProbeThreads, 0, stream>>>(
            static_cast<const __nv_bfloat162*>(x),
            static_cast<__nv_bfloat162*>(y), a, b, inner, pairs);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K9.  x, y: n values in `dtype` (0 float32, 1 bfloat16; n even for
// bfloat16); every value goes through unroll * inner multiply-adds
// v = v * a + b.  unroll is one of 1, 2, 4, 8, 16, 32.  Returns a cudaError_t
// code.
extern "C" int x3d_fma_chain(const void* x, void* y, int dtype, long long n,
                             float a, float b, int unroll, int inner,
                             void* stream) {
  if (n <= 0) return cudaSuccess;
  if (inner < 0 || (dtype == kBF16 && n % 2 != 0) ||
      (n + 2047) / 2048 > 2147483647LL)
    return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (unroll) {
    case 1: return launch<1>(x, y, dtype, n, a, b, inner, s);
    case 2: return launch<2>(x, y, dtype, n, a, b, inner, s);
    case 4: return launch<4>(x, y, dtype, n, a, b, inner, s);
    case 8: return launch<8>(x, y, dtype, n, a, b, inner, s);
    case 16: return launch<16>(x, y, dtype, n, a, b, inner, s);
    case 32: return launch<32>(x, y, dtype, n, a, b, inner, s);
    default: return cudaErrorInvalidValue;
  }
}
