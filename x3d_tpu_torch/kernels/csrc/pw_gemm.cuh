// The tile products shared by the port's 1x1x1-conv kernels (K5, K6 in
// pw_stats.cu; K7 in pointwise.cu).
//
// gemm_tile: a block of kGemmThreads threads computes a kBM x kBN tile of
// y = A @ W^T in float32 on the CUDA cores, from kBM x kBK and kBK x kBN
// tiles of A and W staged in shared memory as float32.  Each thread owns
// 4 x 4 outputs: rows ty + 16 i, columns tx + 16 j.  The caller says how a
// value of A is fetched (which row of device memory feeds a tile row, what is
// applied to it on the way in), so the kernels differ only there and in their
// epilogues.  It serves float32 inputs (no TF32) and K5/K6.
//
// mma_tile: the same product for bfloat16 inputs on the tensor cores
// (mma.sync m16n8k16, float32 accumulators), a kMmaBM x kMmaBN tile a block.
// K7 uses it; moving K5/K6 onto it needs their sum epilogues rewritten for
// its accumulator layout (later work).
#pragma once

#include <cstdint>

#include "common.cuh"

namespace x3d {

constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kGemmThreads = 256;            // 16 x 16, each 4 rows x 4 columns
constexpr int kRowsPerPass = kGemmThreads / kBK;   // tile rows a pass stages
constexpr int kRowPasses = kBM / kRowsPerPass;     // = 4

struct GemmSmem {
  float As[kBK][kBM + 4];
  float Bs[kBK][kBN + 4];
};

// acc += A_tile @ W_tile^T over all of K.  `w` is (N, K) row-major in T;
// columns n0 .. n0 + kBN - 1 (masked at N).  `load_a(pass, k)` returns the
// float32 value of A at tile row threadIdx.x / kBK + kRowsPerPass * pass and
// column k (0 where the row does not exist); k < K is checked here.
template <typename T, typename LoadA>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ w, int n0,
                                          int K, int N, LoadA load_a,
                                          GemmSmem& sm, float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int kk = threadIdx.x % kBK, r = threadIdx.x / kBK;
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int k = k0 + kk;
#pragma unroll
    for (int pass = 0; pass < kRowPasses; ++pass)
      sm.As[kk][r + kRowsPerPass * pass] = k < K ? load_a(pass, k) : 0.f;
#pragma unroll
    for (int pass = 0; pass < kBN / kRowsPerPass; ++pass) {
      const int n = n0 + r + kRowsPerPass * pass;
      sm.Bs[kk][r + kRowsPerPass * pass] =
          (n < N && k < K) ? to_f32(w[(size_t)n * K + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kBK; ++q) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = sm.As[q][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = sm.Bs[q][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ------------------------------------------------- bfloat16, tensor cores

constexpr int kMmaBM = 128, kMmaBN = 64, kMmaBK = 32;
constexpr int kMmaThreads = 256;          // 8 warps, 16 tile rows each
// a tile row in shared memory: kMmaBK bfloat16 = 16 words, padded to 20 so
// that the 8 rows x 4 words a fragment load touches fall into 32 banks
constexpr int kMmaStride = kMmaBK / 2 + 4;
constexpr int kMmaNTiles = kMmaBN / 8;    // 8-column mma tiles a warp owns
constexpr int kMmaAWords = kMmaBM * (kMmaBK / 2) / kMmaThreads;   // = 8
constexpr int kMmaBWords = kMmaBN * (kMmaBK / 2) / kMmaThreads;   // = 4

struct MmaSmem {
  uint32_t As[kMmaBM][kMmaStride];   // [tile row][pair of k]
  uint32_t Bs[kMmaBN][kMmaStride];   // [tile column n][pair of k]
};

// acc[j] += A_tile @ W_tile^T over all of K, K even.  A warp owns tile rows
// 16 warp .. 16 warp + 15 and all kMmaNTiles column tiles; lane (g = lane / 4,
// t = lane % 4) holds, for column tile j, acc[j][0..1] at row g, columns
// 8 j + 2 t and + 1, and acc[j][2..3] at row g + 8 (the m16n8 accumulator
// layout).  `w` is (N, K) row-major; `load_a(pass, k)` returns the two
// bfloat16 values of A at tile row threadIdx.x / 16 + 16 * pass, columns k
// and k + 1, as one word (0 where the row does not exist); k < K is checked
// here.  The next k-tile's
// words are fetched into registers while the tensor cores work on this one.
template <typename LoadA>
__device__ __forceinline__ void mma_tile(const __nv_bfloat16* __restrict__ w,
                                         int n0, int K, int N, LoadA load_a,
                                         MmaSmem& sm,
                                         float (&acc)[kMmaNTiles][4]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int kp = threadIdx.x % (kMmaBK / 2);      // the pair of k staged
  const int r = threadIdx.x / (kMmaBK / 2);       // first tile row staged
  constexpr int kRows = kMmaThreads / (kMmaBK / 2);   // rows a pass stages
  const int ntiles = min(kMmaNTiles, (N - n0 + 7) / 8);
  uint32_t areg[kMmaAWords], breg[kMmaBWords];

  auto fetch = [&](int k0) {
    const int k = k0 + 2 * kp;
#pragma unroll
    for (int p = 0; p < kMmaAWords; ++p)
      areg[p] = k < K ? load_a(p, k) : 0u;
#pragma unroll
    for (int p = 0; p < kMmaBWords; ++p) {
      const int n = n0 + r + kRows * p;
      breg[p] = (n < N && k < K)
                    ? *reinterpret_cast<const uint32_t*>(w + (size_t)n * K + k)
                    : 0u;
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += kMmaBK) {
#pragma unroll
    for (int p = 0; p < kMmaAWords; ++p) sm.As[r + kRows * p][kp] = areg[p];
#pragma unroll
    for (int p = 0; p < kMmaBWords; ++p) sm.Bs[r + kRows * p][kp] = breg[p];
    __syncthreads();
    if (k0 + kMmaBK < K) fetch(k0 + kMmaBK);
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 2; kk += 8) {      // 16 k a step, in words
      if (k0 + 2 * kk >= K) break;
      const uint32_t a0 = sm.As[16 * warp + g][kk + t];
      const uint32_t a1 = sm.As[16 * warp + g + 8][kk + t];
      const uint32_t a2 = sm.As[16 * warp + g][kk + t + 4];
      const uint32_t a3 = sm.As[16 * warp + g + 8][kk + t + 4];
#pragma unroll
      for (int j = 0; j < kMmaNTiles; ++j) {
        if (j >= ntiles) break;
        const uint32_t b0 = sm.Bs[8 * j + g][kk + t];
        const uint32_t b1 = sm.Bs[8 * j + g][kk + t + 4];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
    __syncthreads();
  }
}

}  // namespace x3d
