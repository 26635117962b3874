// The tile products shared by the port's 1x1x1-conv kernels (K5, K6 in
// pw_stats.cu; K7 in pointwise.cu).
//
// pipe_gemm: bfloat16 on the tensor cores, the route of every bfloat16 call
// whose K is even.  These products are bound by bytes on an H100: at X3D
// widths (K, N in 24 .. 432) a bf16 product does 17 to 155 operations per
// byte, below the 295 at which the tensor cores (989 TFLOP/s) and device
// memory (3.35 TB/s) balance.  So the body is built to keep bytes in flight
// and to read A once:
//   * a block owns one column tile of y (all of N up to 192 columns, else
//     tiles of up to 128; 8 warps of 16 rows each, mma.sync m16n8k16 with
//     float32 accumulators, B fragments loaded four at a time) and walks
//     row tiles of 128 rows: tiles slot, slot + slots, ... (one wave of
//     blocks, as many as fit on the card);
//   * its slice of W (all of K) is copied to shared memory once and stays;
//   * A streams through a ring of k-tiles (32 wide) in shared memory,
//     filled with cp.async and drained with cp.async.wait_group, one barrier
//     a stage; the ring runs over (row tile, k-tile) pairs, so where K is
//     one or two k-tiles the next row tile's loads overlap this one's
//     product and epilogue; its depth is picked at launch (with 16-byte
//     copies the most stages, up to 8, that shared memory holds beside the
//     blocks an SM keeps; 3 with narrower ones); a stage can carry a few
//     float32 beside its k-tile (K6's coefficient columns);
//   * the copy granule (16, 8 or 4 bytes) is picked at launch from K and the
//     base pointers (K = 54 and 108 give 108- and 216-byte rows), and shared
//     memory rows are padded by 16 bytes, so ldmatrix reads them without
//     bank conflicts whatever the granule; ragged K is zero-filled in shared
//     memory, never padded in device memory;
//   * an optional transform acts on each A fragment in registers after
//     ldmatrix (K6's swish); each warp owns its rows, so each element is
//     transformed once per block;
//   * the caller's epilogue gets each finished row tile's accumulators;
//     store_tile turns a warp's 16 rows through shared memory, 64 columns
//     at a time, and writes them with 16-byte stores where N % 8 == 0, else
//     4-byte words or single values.
// What this body bounds at small M (each block copies its whole W slice
// before its first product, each of its 8 warps reads all of that slice
// at every k-step, and 128-row tiles leave SMs idle at X3D's stage 5) is
// what pw_wgmma.cuh's Hopper body does away with: wgmma reading a W k-tile
// once a warpgroup, TMA, W streamed or resident by plan, tiles that fill
// the card.  K7 runs that body where it takes the call (K7's "wg"); K5 and
// K6, and K7 at K = 54, 108, the narrowest calls and most strided ones,
// run this one.  A W slice larger than shared memory takes gemm_tile.
//
// gemm_tile: a block of kGemmThreads threads computes a kBM x kBN tile of
// y = A @ W^T in float32 on the CUDA cores, from kBM x kBK and kBK x kBN
// tiles of A and W staged in shared memory as float32.  Each thread owns
// 4 x 4 outputs: rows ty + 16 i, columns tx + 16 j.  The caller says how a
// value of A is fetched (which row of device memory feeds a tile row, what is
// applied to it on the way in).  It serves float32 inputs (no TF32: the
// parity checks compare against full float32) and bfloat16 with an odd K or
// unaligned pointers.
#pragma once

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <mutex>
#include <type_traits>
#include <vector>

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

constexpr int kPipeThreads = 256;        // 8 warps, 16 tile rows each
constexpr int kPipeBM = 128;             // rows of a row tile
constexpr int kPipeBK = 32;              // k of a ring stage
constexpr int kPipeMinStages = 3;        // the ring's depth: picked at launch
constexpr int kPipeMaxStages = 8;
constexpr int kSideFloats = 2 * kPipeBK; // float32 a stage carries beside A
constexpr int kPipeMaxBN = 192;          // columns a block may own
constexpr int kPipeWideBN = 128;         // ... where N is wider than that
// a stage row: kPipeBK bfloat16 and 16 bytes of padding (80 bytes), so the
// 8 rows an ldmatrix reads fall on distinct 16-byte bank groups; a stage is
// kPipeBM such rows and kSideFloats float32 (K6's coefficients)
constexpr int kAStride = kPipeBK + 8;
constexpr int kStageBytes = kPipeBM * kAStride * 2 + kSideFloats * 4;
// shared memory an SM holds for its blocks, and what each block costs beside
// its own (H100)
constexpr size_t kSmemPerSm = 228 * 1024, kSmemPerBlock = 1024;
// y leaves a warp kOutCols columns at a time, through a 16-row buffer whose
// rows hold kOutCols / 2 words and 4 words of padding (144 bytes)
constexpr int kOutCols = 64;
constexpr int kOutWords = kOutCols / 2 + 4;

struct PipeShape {
  int K, N;
  int granule;    // bytes a cp.async copies: 16, 8 or 4
  int nk;         // k-tiles, ceil(K / kPipeBK)
  int nt;         // 8-column mma tiles a warp owns (the block's BN = 8 nt)
  int nct;        // column tiles
  int w_stride;   // bfloat16 a row of W in shared memory: nk * kPipeBK + 8
  int stages;     // ring stages, kPipeMinStages .. kPipeMaxStages
  int tiles;      // row tiles
  int slots;      // row-tile slots: blocks = slots * nct
};

// Rows of W kept in shared memory: 8 nt rounded up to a pair of mma tiles
// (ldmatrix reads two at a time; the extra rows are zeros).
__host__ __device__ __forceinline__ int pipe_w_rows(int nt) {
  return 16 * ((nt + 1) / 2);
}

__host__ __device__ __forceinline__ size_t pipe_ring_offset(
    const PipeShape& q) {       // bytes before the ring
  return sizeof(__nv_bfloat16) * pipe_w_rows(q.nt) * q.w_stride;
}

__host__ __device__ __forceinline__ size_t pipe_out_offset(
    const PipeShape& q) {       // bytes before the warps' output buffers
  return pipe_ring_offset(q) + (size_t)q.stages * kStageBytes;
}

// Dynamic shared memory of a block: W's rows, the ring and the warps'
// output buffers, and at least the rows of W's stride that the B loads
// touch: pipe_gemm loads 8 mma tiles (64 rows) at a time, up to the next
// multiple of 8 past nt, and the rows past W's read the ring or the
// buffers (unused).  Where K is long and nt just past a multiple of 8 that
// reach is the larger (X3D-XL's stage-5 dx: K 630, nt 9 read 12 KB past
// the rest and faulted).
inline size_t pipe_smem(const PipeShape& q) {
  const size_t used =
      pipe_out_offset(q) +
      sizeof(uint32_t) * (kPipeThreads / 32) * 16 * kOutWords;
  const size_t reach =
      sizeof(__nv_bfloat16) * 8 * (ceil_div(q.nt, 8) * 8) * q.w_stride;
  return std::max(used, reach);
}

// Fills q's copy granule, k-tiling and column tiling for q.K, q.N and
// base addresses whose bits are or-ed into `bases`.  The granule is the
// widest of 16, 8 and 4 bytes that divides a row (2 K bytes) and the bases;
// where none does (an odd K, a pointer off a word) the call is not this
// body's, nor where no tiling fits.  The column tiling: the fewest column
// tiles whose W slice fits in shared memory beside the shallowest ring, of
// at most kPipeMaxBN columns where that covers all of N (K6's u is then
// computed once), else of at most kPipeWideBN (the 16-tile register bucket,
// which keeps two blocks an SM where the 24-tile one keeps one).  Returns
// whether this body takes the call.
inline bool pipe_plan(PipeShape& q, uintptr_t bases) {
  q.granule = 0;
  for (int g : {16, 8, 4})
    if ((2 * q.K) % g == 0 && bases % g == 0) {
      q.granule = g;
      break;
    }
  if (q.granule == 0) return false;
  q.nk = ceil_div(q.K, kPipeBK);
  q.w_stride = q.nk * kPipeBK + 8;
  q.stages = kPipeMinStages;
  const int widest = q.N <= kPipeMaxBN ? kPipeMaxBN : kPipeWideBN;
  for (q.nct = ceil_div(q.N, widest);; ++q.nct) {
    q.nt = ceil_div(ceil_div(q.N, q.nct), 8);
    if (pipe_smem(q) <= kMaxSmem) return true;
    if (q.nt == 1) return false;
  }
}

// The instantiation pick(G, NT) of a pipe_gemm kernel for q's copy granule
// G and column tiles, NT (the mma column tiles a warp owns) rounded up to 8,
// 16 or 24, a register budget each; G and NT arrive as
// std::integral_constant.  nullptr for a granule that has none.
template <typename Pick>
auto pipe_kernel(const PipeShape& q, Pick pick) {
  using I16 = std::integral_constant<int, 16>;
  using Ptr = decltype(pick(I16{}, std::integral_constant<int, 8>{}));
  auto by_nt = [&](auto g) -> Ptr {
    if (q.nt <= 8) return pick(g, std::integral_constant<int, 8>{});
    if (q.nt <= 16) return pick(g, I16{});
    return pick(g, std::integral_constant<int, 24>{});
  };
  switch (q.granule) {
    case 16: return by_nt(I16{});
    case 8: return by_nt(std::integral_constant<int, 8>{});
    case 4: return by_nt(std::integral_constant<int, 4>{});
  }
  return Ptr{nullptr};
}

// Blocks of `kernel` that fit on one SM with `smem` bytes of dynamic shared
// memory (-1 on an error), remembered per kernel and size for this process's
// card; the first call also lets the kernel take all of kMaxSmem.
inline int pipe_blocks_per_sm(const void* kernel, size_t smem) {
  struct Seen { const void* kernel; size_t smem; int blocks; };
  static std::mutex mu;
  static std::vector<Seen> seen;
  std::lock_guard<std::mutex> lock(mu);
  for (const Seen& s : seen)
    if (s.kernel == kernel && s.smem == smem) return s.blocks;
  int blocks = 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kMaxSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kPipeThreads, smem) != cudaSuccess)
    return -1;
  seen.push_back({kernel, smem, blocks});
  return blocks;
}

// The ring's depth for `kernel` at q's tiling and copy granule: with
// 16-byte copies (cp.async.cg, which bypasses L1) the most stages, up to
// kPipeMaxStages, that keep the blocks an SM holds at the shallowest ring,
// so that each block keeps as many bytes in flight as shared memory allows;
// with 8- and 4-byte copies (cp.async.ca, staged through L1, which is what
// shared memory leaves of the SM's 256 KB) the shallowest ring, which ran
// faster for them on an H100.  Returns those blocks per SM (-1 on an error)
// and sets q.stages.
inline int pipe_stages(const void* kernel, PipeShape& q) {
  q.stages = kPipeMinStages;
  const int per_sm = pipe_blocks_per_sm(kernel, pipe_smem(q));
  if (per_sm <= 0) return per_sm;
  const size_t budget =
      std::min(kMaxSmem, kSmemPerSm / per_sm - kSmemPerBlock);
  while (q.stages < (q.granule == 16 ? kPipeMaxStages : kPipeMinStages)) {
    ++q.stages;
    if (pipe_smem(q) > budget ||
        pipe_blocks_per_sm(kernel, pipe_smem(q)) < per_sm) {
      --q.stages;
      break;
    }
  }
  return per_sm;
}

// How a call at q's planned widths runs, for the C interface's plan
// functions: out[0] the copy granule in bytes, out[1] the columns a block
// owns, out[2] column tiles, out[3] dynamic shared memory in bytes, out[4]
// blocks an SM holds, out[5] the ring's stages.  Returns a cudaError_t code.
inline int pipe_report(const void* kernel, PipeShape q, int* out) {
  out[4] = pipe_stages(kernel, q);
  out[0] = q.granule, out[1] = 8 * q.nt, out[2] = q.nct;
  out[3] = (int)pipe_smem(q), out[5] = q.stages;
  return out[4] < 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// Launch a pipe_gemm kernel taking (args..., q) over q.tiles row tiles as
// one wave: as many blocks as fit on the card at once (at most one per row
// tile and column tile), the column tiles of one slot next to each other in
// launch order, so that they read the same rows of A at about the same time
// (from device memory once, from the L2 cache after that).
template <typename... Params, typename... Args>
int pipe_launch(void (*kernel)(Params...), PipeShape q, cudaStream_t stream,
                Args... args) {
  const int per_sm = pipe_stages((const void*)kernel, q);
  const int sms = sm_count();
  if (per_sm <= 0 || sms <= 0) return cudaErrorInvalidConfiguration;
  q.slots = std::max(1, std::min(q.tiles, sms * per_sm / q.nct));
  kernel<<<q.slots * q.nct, kPipeThreads, pipe_smem(q), stream>>>(args..., q);
  return cudaGetLastError();
}

extern __shared__ __align__(16) unsigned char pipe_smem_bytes[];

// cp.async.wait_group takes its count as an immediate
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<kPipeMaxStages - 2>(); break;
  }
}
static_assert(kPipeMaxStages - 2 == 6, "cp_async_wait(n) covers 1 .. 6");

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warps' output buffers (16 x kOutWords words each) in shared memory.
__device__ __forceinline__ uint32_t* pipe_out(const PipeShape& q) {
  return reinterpret_cast<uint32_t*>(pipe_smem_bytes + pipe_out_offset(q));
}

// y = A @ W^T for the block's column tile (columns n0 = 8 nt ct ..) and its
// row tiles slot, slot + slots, ... (ct, slot from blockIdx.x), with
// K-granule G and at most NT mma column tiles a warp.  `w` is (N, K)
// row-major.  `src(tile, r)` points at the K values of A that feed row r of
// `tile` (nullptr: no such row; it reads as zeros).  `side(tile, kt, dst)`
// may copy up to kSideFloats float32 into the stage that carries k-tile kt
// of `tile` (cp.async; each thread its own).  `xform(tile, r, k, s, a)` may
// rewrite an A fragment after ldmatrix: it holds rows r (a[0], a[2]) and
// r + 8 (a[1], a[3]) of the tile at columns k, k + 1 (a[0], a[1]) and k + 8,
// k + 9 (a[2], a[3]), two bfloat16 a word, the lower k in the low half; `s`
// points at the stage's side floats for column k (s[kPipeBK] for the second
// half).
// `epi(tile, n0, acc)` gets each finished tile, every thread of the block
// together; lane (g = lane / 4, t = lane % 4) of warp w holds acc[j][0..1] at
// row 16 w + g, columns n0 + 8 j + 2 t and + 1, and acc[j][2..3] at row
// 16 w + g + 8 (the m16n8 accumulator layout).
template <int G, int NT, typename Src, typename Side, typename Xform,
          typename Epi>
__device__ __forceinline__ void pipe_gemm(const __nv_bfloat16* __restrict__ w,
                                          const PipeShape& q, Src src,
                                          Side side, Xform xform, Epi epi) {
  using bf16 = __nv_bfloat16;
  constexpr int kCpr = 2 * kPipeBK / G;              // granules a stage row
  constexpr int kChunks = kPipeBM * kCpr / kPipeThreads;   // a thread's
  constexpr int kRowStep = kPipeThreads / kCpr;
  bf16* ws = reinterpret_cast<bf16*>(pipe_smem_bytes);
  unsigned char* ring = pipe_smem_bytes + pipe_ring_offset(q);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ct = blockIdx.x % q.nct, slot = blockIdx.x / q.nct;
  const int n0 = 8 * q.nt * ct;
  const int items = slot < q.tiles
                        ? ((q.tiles - 1 - slot) / q.slots + 1) * q.nk
                        : 0;

  // W's rows n0 .. n0 + 8 nt - 1 over all of K, once; zeros past them, past
  // N and past K
  const int wcpr = q.nk * kCpr;
  for (int c = threadIdx.x; c < pipe_w_rows(q.nt) * wcpr; c += kPipeThreads) {
    const int r = c / wcpr, k = c % wcpr * (G / 2), n = n0 + r;
    const bool ok = r < 8 * q.nt && n < q.N && k < q.K;
    cp_async<G>(ws + r * q.w_stride + k, ok ? w + (size_t)n * q.K + k : w, ok);
  }

  // the loads run q.stages - 1 (row tile, k-tile) items ahead of the
  // product; a thread copies granule ccol of rows crow + kRowStep i
  const int crow = threadIdx.x / kCpr, ccol = threadIdx.x % kCpr * (G / 2);
  const bf16* rows[kChunks];
  int load_item = 0, load_stage = 0, load_tile = slot, load_kt = 0;
  auto load = [&]() {
    if (load_item < items) {
      if (load_kt == 0) {
#pragma unroll
        for (int i = 0; i < kChunks; ++i)
          rows[i] = src(load_tile, crow + kRowStep * i);
      }
      unsigned char* stage = ring + load_stage * kStageBytes;
      bf16* a = reinterpret_cast<bf16*>(stage);
      const int k = load_kt * kPipeBK + ccol;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const bool ok = rows[i] != nullptr && k < q.K;
        cp_async<G>(a + (crow + kRowStep * i) * kAStride + ccol,
                    ok ? rows[i] + k : w, ok);
      }
      side(load_tile, load_kt,
           reinterpret_cast<float*>(stage + kPipeBM * kAStride * 2));
      if (++load_kt == q.nk) load_kt = 0, load_tile += q.slots;
    }
    cp_async_commit();           // an empty group past the end keeps count
    ++load_item;
    if (++load_stage == q.stages) load_stage = 0;
  };
  for (int s = 0; s < q.stages - 1; ++s) load();   // W rides in group 0

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int g = lane / 4, t = lane % 4;
  int tile = slot, kt = 0, cstage = 0;
  for (int it = 0; it < items; ++it) {
    cp_async_wait(q.stages - 2);        // this thread's copies of item it
    __syncthreads();                    // everyone's; stage it - 1 is free
    load();                             // item it + q.stages - 1
    const bf16* stage =
        reinterpret_cast<const bf16*>(ring + cstage * kStageBytes);
    const float* sides =
        reinterpret_cast<const float*>(ring + cstage * kStageBytes +
                                       kPipeBM * kAStride * 2);
    if (++cstage == q.stages) cstage = 0;
#pragma unroll
    for (int ks = 0; ks < kPipeBK; ks += 16) {
      const int k = kt * kPipeBK + ks;
      if (k >= q.K) break;
      uint32_t a[4];
      ldmatrix_x4(a, stage + (16 * warp + (lane & 15)) * kAStride + ks +
                         (lane >> 4) * 8);
      xform(tile, 16 * warp + g, k + 2 * t, sides + ks + 2 * t, a);
      // B fragments 8 column tiles at a time, their four ldmatrix issued
      // back to back ahead of the eight products (one at a time left each
      // product waiting on its load, slower at the large K of stage 5);
      // the loads of tiles past nt read rows past W's (pipe_smem covers
      // them)
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += 8) {
        if (j0 >= q.nt) break;
        uint32_t b[4][4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          ldmatrix_x4(b[p], ws + (8 * (j0 + 2 * p) + (lane & 7) +
                                  (lane >> 4) * 8) * q.w_stride +
                                k + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int j = j0 + 2 * p;
          if (j < q.nt) mma_bf16(acc[j], a, b[p][0], b[p][1]);
          if (j + 1 < q.nt) mma_bf16(acc[j + 1], a, b[p][2], b[p][3]);
        }
      }
    }
    if (++kt == q.nk) {
      epi(tile, n0, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      kt = 0;
      tile += q.slots;
    }
  }
  cp_async_wait<0>();
}

// How y leaves store_tile: 16-byte vectors (N % 8 == 0, y 16-byte aligned),
// 4-byte words (N even, y word-aligned) or single values.
enum StoreWidth { kStore16 = 16, kStore4 = 4, kStore2 = 2 };

inline int store_width(int N, uintptr_t y) {
  if (N % 8 == 0 && y % 16 == 0) return kStore16;
  if (N % 2 == 0 && y % 4 == 0) return kStore4;
  return kStore2;
}

// Writes the calling warp's 16 rows of a finished tile, rounded to bfloat16,
// columns n0 .. min(N, n0 + 8 nt) - 1.  `row(r)` points at the row of y for
// the warp's row r (nullptr: none).  The values turn through the warp's
// output buffer, kOutCols columns at a time, so that a store writes whole
// 16-byte vectors (or words) of consecutive columns.
template <int NT, typename Row>
__device__ __forceinline__ void store_tile(const float (&acc)[NT][4],
                                           uint32_t* out, int n0, int nt,
                                           int N, int width, Row row) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n_end = min(N, n0 + 8 * nt);
#pragma unroll
  for (int c = 0; c < NT / 8; ++c) {
    const int nc = n0 + kOutCols * c;
    if (nc >= n_end) break;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(
            acc[8 * c + jj][2 * h], acc[8 * c + jj][2 * h + 1]);
        out[(g + 8 * h) * kOutWords + 4 * jj + t] =
            *reinterpret_cast<const uint32_t*>(&v);
      }
    __syncwarp();
    const int cols = min(kOutCols, n_end - nc);
    if (width == kStore16) {
#pragma unroll
      for (int i = lane; i < 16 * 8; i += 32) {
        const int r = i / 8, v = i % 8;
        __nv_bfloat16* y = row(r);
        if (y != nullptr && 8 * v < cols)
          *reinterpret_cast<uint4*>(y + nc + 8 * v) =
              *reinterpret_cast<const uint4*>(out + r * kOutWords + 4 * v);
      }
    } else if (width == kStore4) {
      for (int r = 0; r < 16; ++r) {
        __nv_bfloat16* y = row(r);
        if (y != nullptr && 2 * lane < cols)
          *reinterpret_cast<uint32_t*>(y + nc + 2 * lane) =
              out[r * kOutWords + lane];
      }
    } else {
      const __nv_bfloat16* o = reinterpret_cast<const __nv_bfloat16*>(out);
      for (int r = 0; r < 16; ++r) {
        __nv_bfloat16* y = row(r);
        if (y == nullptr) continue;
        for (int e = lane; e < cols; e += 32) y[nc + e] = o[2 * kOutWords * r + e];
      }
    }
    __syncwarp();
  }
}

// Per-column sums of a finished tile's float32 accumulators over the rows
// that exist (`lo`, `hi`: the lane's rows g and g + 8): part_p[c] and
// part_s2[c] get the sums of y and y^2 of column n0 + c, c < cols.  A warp
// sums its 16 rows (the lane's two, then shuffles over the lane bits that
// hold g), writes them to its output buffer, and after a barrier the 8
// warps' sums are added in order: no atomics, the same bits every run.
// Every thread of the block calls it, after its warp's store_tile.
template <int NT>
__device__ __forceinline__ void tile_sums(const float (&acc)[NT][4],
                                          uint32_t* out_base, bool lo, bool hi,
                                          int nt, int cols,
                                          float* __restrict__ part_p,
                                          float* __restrict__ part_s2) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  constexpr int kWarpWords = 16 * kOutWords;      // >= 2 kPipeMaxBN
  float* mine = reinterpret_cast<float*>(out_base + warp * kWarpWords);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt) break;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float y0 = lo ? acc[j][e] : 0.f, y1 = hi ? acc[j][2 + e] : 0.f;
      float s = y0 + y1, ss = fmaf(y1, y1, y0 * y0);
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, m);
        ss += __shfl_xor_sync(0xffffffffu, ss, m);
      }
      if (g == 0) {
        mine[8 * j + 2 * t + e] = s;
        mine[kPipeMaxBN + 8 * j + 2 * t + e] = ss;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cols; c += kPipeThreads) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < kPipeThreads / 32; ++w8) {
      const float* theirs =
          reinterpret_cast<const float*>(out_base + w8 * kWarpWords);
      s += theirs[c];
      ss += theirs[kPipeMaxBN + c];
    }
    part_p[c] = s;
    part_s2[c] = ss;
  }
}

}  // namespace x3d
