// Shared pieces of the port's kernels: element conversion, the depthwise
// kernels' block shape and the cp.async copies.  Every kernel here takes
// NDHWC activations (C contiguous) in float32 or bfloat16 and accumulates in
// float32.
#pragma once

#include <cstdint>

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

}  // namespace x3d
