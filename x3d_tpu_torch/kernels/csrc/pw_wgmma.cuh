// The Hopper body of the port's 1x1x1-conv GEMM: y tiles of A @ W^T with A
// (M, K) and W (N, K) in bfloat16, K contiguous, summed in float32 on the
// tensor cores by wgmma, fed by TMA through an mbarrier ring.  K7
// (pointwise.cu) runs it; K5 and K6 stay on pw_gemm.cuh's pipe_gemm.
//
// What bounds it on an H100: bytes.  At X3D widths (K, N in 24 .. 432) a
// product does 17 to 155 operations a byte, below the 295 at which the
// tensor cores (989 TFLOP/s) and device memory (3.35 TB/s) balance.  Where
// pipe_gemm loses at small M (stages 4 and 5: a block gets one or two row
// tiles), it copies its whole W slice before its first product and every
// one of its 8 warps reads all of that slice from shared memory at every
// k-step (mma.sync); and its 128-row tiles leave SMs idle (62 blocks at
// stage 5).  This body:
//   * a block is one producer warp and CONS consumer warpgroups of 64 rows
//     (a row tile is 64 CONS rows); the producer's one lane keeps TMA loads
//     of (row tile, k-tile) stages in flight on full/empty mbarriers, across
//     row tiles, so one tile's epilogue overlaps the next tile's loads;
//   * wgmma m64nBNk16 reads a W k-tile once a warpgroup, from shared memory
//     in TMA's 128-byte swizzle (K-major A and B, 64 k a stage, 16 a step);
//     the sum stays in registers;
//   * a k-tile's products run while the next k-tile's are issued (one
//     wgmma group in flight); its stage goes back to the producer when
//     they are done;
//   * W's k-tiles ride in each stage beside A's (streamed) or are loaded
//     once and stay (resident), as the plan says;
//   * TMA's zero fill outside the tensors replaces the masks for ragged M,
//     N and K: zero rows and columns add nothing, so every k-tile runs all
//     four k-steps, unbranched;
//   * the plan (ops/pointwise.wg_plan) picks the column tiles, 64- or
//     128-row tiles and the number of blocks so that the grid fills the
//     card; a block walks row tiles slot, slot + slots, ...;
//   * each output is one warpgroup's sum over the k-tiles in order: no
//     atomics, no split-K, the same bits every run.
// Not kept (measured slower on an H100, PERF.md §6): a cluster of the two
// column-tile blocks of a slot sharing x by TMA multicast; x in whole rows
// by bulk copies with A from registers.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder is reached
                   // through the runtime's driver entry point

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace x3d {

constexpr int kWgRows = 64;          // rows of a consumer warpgroup (wgmma M)
constexpr int kWgBK = 64;            // k of a stage: one 128-byte swizzle row
constexpr int kWgRowBytes = 2 * kWgBK;
constexpr int kWgMaxStages = 12;
constexpr size_t kWgAlign = 1024;    // a 128-byte-swizzled tile's alignment
constexpr size_t kWgHead = 1024;     // the mbarriers, before the tiles
constexpr int kWgOutBufs = 2;        // y buffers a consumer warpgroup

struct WgShape {
  long long M;
  int K, N;
  int nk;          // k-tiles, ceil(K / kWgBK)
  int nct;         // column tiles of the instantiation's BN columns
  int tiles;       // row tiles of at most 64 CONS rows
  int slots;       // row-tile slots: blocks = slots * nct
  int stages;      // the ring's depth
  int w_resident;  // 1: the block's W slice is loaded once and stays
  // a strided read (r > 0): x is (frames, H, W, K), output row m = (frame,
  // ho, wo) reads x[frame, sh ho, sw wo]; a row tile is r whole output
  // rows (r Wo <= 64 CONS) of one frame, tpf = ceil(Ho / r) tiles a frame.
  // r == 0: row tile t is rows 64 CONS t .. of x as a (M, K) matrix.
  int r, tpf, Ho, Wo, sh;
  uint32_t x_bytes;  // bytes of a stage's x box
};

// Row tile `tile`'s first output row and its number of rows.
template <int CONS>
__device__ __forceinline__ void wg_tile(const WgShape& q, int tile,
                                        long long& m0, int& rows) {
  if (q.r == 0) {
    m0 = (long long)tile * kWgRows * CONS;
    rows = (int)min((long long)kWgRows * CONS, q.M - m0);
  } else {
    const int frame = tile / q.tpf, ho0 = tile % q.tpf * q.r;
    m0 = ((long long)frame * q.Ho + ho0) * q.Wo;
    rows = min(q.r, q.Ho - ho0) * q.Wo;
  }
}

// Shared memory, from a kWgAlign-aligned base: the mbarriers (kWgHead
// bytes), the resident W slice, the ring, then the consumers' y buffers
// (kWgOutBufs of 64 x BN bfloat16 each) and, with the BN epilogue, its
// coefficients; kWgAlign bytes of slack align the base.  Every
// tile is a multiple of 1024 bytes, so every tile base stays aligned.
__host__ __device__ inline size_t wg_w_tile(int bn) {
  return (size_t)bn * kWgRowBytes;
}
__host__ __device__ inline size_t wg_a_tile(int cons) {
  return (size_t)cons * kWgRows * kWgRowBytes;
}
__host__ __device__ inline size_t wg_stage_bytes(int bn, int cons,
                                                 int resident) {
  return wg_a_tile(cons) + (resident ? 0 : wg_w_tile(bn));
}
__host__ __device__ inline size_t wg_resident_bytes(int bn, int nk,
                                                    int resident) {
  return resident ? (size_t)nk * wg_w_tile(bn) : 0;
}
__host__ __device__ inline size_t wg_out_offset(int bn, int cons,
                                                const WgShape& q) {
  return kWgHead + wg_resident_bytes(bn, q.nk, q.w_resident) +
         (size_t)q.stages * wg_stage_bytes(bn, cons, q.w_resident);
}
// Past the y buffers, where a launch has the BN epilogue (common.cuh's
// BnEpilogue): its coefficients of the block's columns, {mul, mul, add,
// add} of each pair, 16 bytes a pair.
__host__ __device__ inline size_t wg_coef_offset(int bn, int cons,
                                                 const WgShape& q) {
  return wg_out_offset(bn, cons, q) +
         (size_t)kWgOutBufs * cons * kWgRows * bn * 2;
}
inline size_t wg_smem(int bn, int cons, const WgShape& q, bool ep = false) {
  return kWgAlign + wg_coef_offset(bn, cons, q) + (ep ? (size_t)8 * bn : 0);
}

extern __shared__ __align__(16) unsigned char wg_smem_bytes[];

__device__ __forceinline__ unsigned char* wg_base() {
  const uint32_t a = smem_u32(wg_smem_bytes);
  return wg_smem_bytes + (kWgAlign - a % kWgAlign) % kWgAlign;
}

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Waits until the phase of parity `parity` has completed (a barrier starts
// in phase 0; parity 1 then counts as complete).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// ------------------------------------------------------------ TMA, bulk

// The box at (c0 along the inner dimension, c1 along the outer) of a 2-D
// tensor map into shared memory; completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar)) : "memory");
}

// The box at (c0, c1, c2, c3) of a 4-D tensor map, likewise.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar)) : "memory");
}

// Brings a tensor map into the cache before its first copy.
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from shared
// memory to global memory, in the calling thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// The box at (c0, c1) of a 2-D tensor map, from shared memory, in the
// calling thread's bulk group; nothing is written outside the tensor.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, int c0,
                                             int c1, const void* src) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(src)) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// All but the calling thread's newest N bulk groups have read their
// sources (shared memory may then be written again or released).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Shared-memory writes of this thread, made visible to the async proxy
// (bulk copies, wgmma) before a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ------------------------------------------------------------------ wgmma

// The descriptor of a K-major tile as TMA's 128-byte swizzle lays it out:
// rows of 128 bytes, groups of 8 rows 1024 bytes apart (the stride offset,
// 64 in 16-byte units), base 1024-aligned, the leading offset unused in
// this layout.  A step of 16 k (32 bytes) within the row adds 2.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// All but the newest N committed wgmma groups are done.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After wgmma_wait: the accumulators count as written here, so no read of
// them moves above the wait.
template <int R>
__device__ __forceinline__ void wgmma_fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A @ B over 16 k, m64nBNk16, bfloat16 in, float32 sums; a and b are
// descriptors, scale 0 overwrites d.  Lane (g = lane / 4, t = lane % 4) of
// warp w of the warpgroup holds d[4 j + 0..1] at row 16 w + g, columns
// 8 j + 2 t and + 1, and d[4 j + 2..3] at row 16 w + g + 8.  The operand
// list spells out every register: the descriptors and scale are %0 .. %2,
// accumulator register r is %(3 + r); X3D_WG_L<G> lists G groups of four,
// X3D_WG_C<G> their constraints.
template <int BN>
__device__ void wgmma_bf16(float (&d)[BN / 2], uint64_t a, uint64_t b,
                           int scale);

#define X3D_WG_ACC4(i) \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define X3D_WG_L1 "%3, %4, %5, %6"
#define X3D_WG_L2 X3D_WG_L1 ", %7, %8, %9, %10"
#define X3D_WG_L3 X3D_WG_L2 ", %11, %12, %13, %14"
#define X3D_WG_L4 X3D_WG_L3 ", %15, %16, %17, %18"
#define X3D_WG_L5 X3D_WG_L4 ", %19, %20, %21, %22"
#define X3D_WG_L6 X3D_WG_L5 ", %23, %24, %25, %26"
#define X3D_WG_L7 X3D_WG_L6 ", %27, %28, %29, %30"
#define X3D_WG_L8 X3D_WG_L7 ", %31, %32, %33, %34"
#define X3D_WG_L9 X3D_WG_L8 ", %35, %36, %37, %38"
#define X3D_WG_L10 X3D_WG_L9 ", %39, %40, %41, %42"
#define X3D_WG_L11 X3D_WG_L10 ", %43, %44, %45, %46"
#define X3D_WG_L12 X3D_WG_L11 ", %47, %48, %49, %50"
#define X3D_WG_L13 X3D_WG_L12 ", %51, %52, %53, %54"
#define X3D_WG_L14 X3D_WG_L13 ", %55, %56, %57, %58"
#define X3D_WG_L15 X3D_WG_L14 ", %59, %60, %61, %62"
#define X3D_WG_L16 X3D_WG_L15 ", %63, %64, %65, %66"
#define X3D_WG_L17 X3D_WG_L16 ", %67, %68, %69, %70"
#define X3D_WG_L18 X3D_WG_L17 ", %71, %72, %73, %74"
#define X3D_WG_L19 X3D_WG_L18 ", %75, %76, %77, %78"
#define X3D_WG_L20 X3D_WG_L19 ", %79, %80, %81, %82"
#define X3D_WG_L21 X3D_WG_L20 ", %83, %84, %85, %86"
#define X3D_WG_L22 X3D_WG_L21 ", %87, %88, %89, %90"
#define X3D_WG_L23 X3D_WG_L22 ", %91, %92, %93, %94"
#define X3D_WG_L24 X3D_WG_L23 ", %95, %96, %97, %98"
#define X3D_WG_L25 X3D_WG_L24 ", %99, %100, %101, %102"
#define X3D_WG_L26 X3D_WG_L25 ", %103, %104, %105, %106"
#define X3D_WG_L27 X3D_WG_L26 ", %107, %108, %109, %110"
#define X3D_WG_L28 X3D_WG_L27 ", %111, %112, %113, %114"
#define X3D_WG_L29 X3D_WG_L28 ", %115, %116, %117, %118"
#define X3D_WG_L30 X3D_WG_L29 ", %119, %120, %121, %122"
#define X3D_WG_L31 X3D_WG_L30 ", %123, %124, %125, %126"
#define X3D_WG_L32 X3D_WG_L31 ", %127, %128, %129, %130"
#define X3D_WG_C1 X3D_WG_ACC4(0)
#define X3D_WG_C2 X3D_WG_C1, X3D_WG_ACC4(4)
#define X3D_WG_C3 X3D_WG_C2, X3D_WG_ACC4(8)
#define X3D_WG_C4 X3D_WG_C3, X3D_WG_ACC4(12)
#define X3D_WG_C5 X3D_WG_C4, X3D_WG_ACC4(16)
#define X3D_WG_C6 X3D_WG_C5, X3D_WG_ACC4(20)
#define X3D_WG_C7 X3D_WG_C6, X3D_WG_ACC4(24)
#define X3D_WG_C8 X3D_WG_C7, X3D_WG_ACC4(28)
#define X3D_WG_C9 X3D_WG_C8, X3D_WG_ACC4(32)
#define X3D_WG_C10 X3D_WG_C9, X3D_WG_ACC4(36)
#define X3D_WG_C11 X3D_WG_C10, X3D_WG_ACC4(40)
#define X3D_WG_C12 X3D_WG_C11, X3D_WG_ACC4(44)
#define X3D_WG_C13 X3D_WG_C12, X3D_WG_ACC4(48)
#define X3D_WG_C14 X3D_WG_C13, X3D_WG_ACC4(52)
#define X3D_WG_C15 X3D_WG_C14, X3D_WG_ACC4(56)
#define X3D_WG_C16 X3D_WG_C15, X3D_WG_ACC4(60)
#define X3D_WG_C17 X3D_WG_C16, X3D_WG_ACC4(64)
#define X3D_WG_C18 X3D_WG_C17, X3D_WG_ACC4(68)
#define X3D_WG_C19 X3D_WG_C18, X3D_WG_ACC4(72)
#define X3D_WG_C20 X3D_WG_C19, X3D_WG_ACC4(76)
#define X3D_WG_C21 X3D_WG_C20, X3D_WG_ACC4(80)
#define X3D_WG_C22 X3D_WG_C21, X3D_WG_ACC4(84)
#define X3D_WG_C23 X3D_WG_C22, X3D_WG_ACC4(88)
#define X3D_WG_C24 X3D_WG_C23, X3D_WG_ACC4(92)
#define X3D_WG_C25 X3D_WG_C24, X3D_WG_ACC4(96)
#define X3D_WG_C26 X3D_WG_C25, X3D_WG_ACC4(100)
#define X3D_WG_C27 X3D_WG_C26, X3D_WG_ACC4(104)
#define X3D_WG_C28 X3D_WG_C27, X3D_WG_ACC4(108)
#define X3D_WG_C29 X3D_WG_C28, X3D_WG_ACC4(112)
#define X3D_WG_C30 X3D_WG_C29, X3D_WG_ACC4(116)
#define X3D_WG_C31 X3D_WG_C30, X3D_WG_ACC4(120)
#define X3D_WG_C32 X3D_WG_C31, X3D_WG_ACC4(124)

// BN columns, G = BN / 8 groups of four accumulator registers
#define X3D_WGMMA(BN, G)                                                  \
  template <>                                                             \
  __device__ __forceinline__ void wgmma_bf16<BN>(                         \
      float(&d)[BN / 2], uint64_t a, uint64_t b, int scale) {             \
    asm volatile(                                                         \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n" #BN "k16.f32.bf16.bf16 {"     \
        X3D_WG_L##G "}, %0, %1, p, 1, 1, 0, 0;\n}\n"                      \
        : "+l"(a), "+l"(b), "+r"(scale), X3D_WG_C##G);                    \
  }

// the column tiles a call may take (ops/pointwise.WG_COLUMNS)
X3D_WGMMA(24, 3)
X3D_WGMMA(48, 6)
X3D_WGMMA(56, 7)
X3D_WGMMA(96, 12)
X3D_WGMMA(112, 14)
X3D_WGMMA(144, 18)
X3D_WGMMA(192, 24)
X3D_WGMMA(216, 27)
X3D_WGMMA(256, 32)

// Calls pick(std::integral_constant<int, BN>) for the instantiated column
// tile bn; returns `none` for any other width.
template <typename Pick, typename R>
R wg_by_columns(int bn, Pick pick, R none) {
  switch (bn) {
    case 24: return pick(std::integral_constant<int, 24>{});
    case 48: return pick(std::integral_constant<int, 48>{});
    case 56: return pick(std::integral_constant<int, 56>{});
    case 96: return pick(std::integral_constant<int, 96>{});
    case 112: return pick(std::integral_constant<int, 112>{});
    case 144: return pick(std::integral_constant<int, 144>{});
    case 192: return pick(std::integral_constant<int, 192>{});
    case 216: return pick(std::integral_constant<int, 216>{});
    case 256: return pick(std::integral_constant<int, 256>{});
  }
  return none;
}

// ------------------------------------------------------------------ body

// The block's row tiles of A @ W^T, column tile ct: block (ct, slot) =
// (blockIdx.x % q.nct, blockIdx.x / q.nct) owns columns BN ct .. and row
// tiles slot, slot + q.slots, ... (wg_tile); xmap's box is kWgBK x 64 CONS
// rows of a (M, K) matrix (q.r == 0) or kWgBK x the strided rows of a row
// tile of a (frames, H, W, K) tensor, wmap's kWgBK x BN, both 128-byte
// swizzled.  Threads 0 .. 128 CONS - 1 are the consumer warpgroups, the
// last warp the producer.  `epi(m0, rows, n0, acc, cg)` gets each finished
// tile of up to 64 rows (rows m0 .. m0 + rows - 1, columns n0 ..) from
// consumer warpgroup cg, its 128 threads together, in wgmma_bf16's layout
// (rows <= 0: none of them exists).
template <int BN, int CONS, typename Epi>
__device__ __forceinline__ void wg_gemm(const CUtensorMap& xmap,
                                        const CUtensorMap& wmap,
                                        const WgShape& q,
                                        unsigned char* base, Epi epi) {
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  uint64_t* empty = full + q.stages;
  uint64_t* w_full = empty + q.stages;
  unsigned char* w_tiles = base + kWgHead;
  unsigned char* ring =
      w_tiles + wg_resident_bytes(BN, q.nk, q.w_resident);
  const size_t a_tile = wg_a_tile(CONS);
  const size_t stage_bytes = wg_stage_bytes(BN, CONS, q.w_resident);
  const int ct = blockIdx.x % q.nct, slot = blockIdx.x / q.nct;
  const int n0 = BN * ct;
  const int tiles =
      slot < q.tiles ? (q.tiles - 1 - slot) / q.slots + 1 : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < q.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * CONS);     // one arrival a consumer warp
    }
    mbar_init(w_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONS) {                 // the producer: one lane
    if (lane == 0) {
      prefetch_tensormap(&xmap);
      prefetch_tensormap(&wmap);
      if (q.w_resident) {
        mbar_expect_tx(w_full,
                       (uint32_t)wg_resident_bytes(BN, q.nk, q.w_resident));
        for (int kt = 0; kt < q.nk; ++kt)
          tma_load_2d(w_tiles + kt * wg_w_tile(BN), &wmap, kWgBK * kt, n0,
                      w_full);
      }
      int s = 0;
      uint32_t phase = 0;
      for (int i = 0; i < tiles; ++i) {
        const int tile = slot + q.slots * i;
        for (int kt = 0; kt < q.nk; ++kt) {
          mbar_wait(&empty[s], phase ^ 1);
          unsigned char* stage = ring + s * stage_bytes;
          const uint32_t w_bytes =
              q.w_resident ? 0u : (uint32_t)wg_w_tile(BN);
          mbar_expect_tx(&full[s], q.x_bytes + w_bytes);
          if (q.r == 0)
            tma_load_2d(stage, &xmap, kWgBK * kt, tile * kWgRows * CONS,
                        &full[s]);
          else
            tma_load_4d(stage, &xmap, kWgBK * kt, 0,
                        tile % q.tpf * q.r * q.sh, tile / q.tpf, &full[s]);
          if (!q.w_resident)
            tma_load_2d(stage + a_tile, &wmap, kWgBK * kt, n0, &full[s]);
          if (++s == q.stages) s = 0, phase ^= 1;
        }
      }
    }
  } else {                                // a consumer warpgroup
    const int cg = warp / 4;
    float acc[BN / 2];
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) acc[r] = 0.f;
    int s = 0;
    uint32_t phase = 0;
    if (q.w_resident) mbar_wait(w_full, 0);
    for (int i = 0; i < tiles; ++i) {
      long long m0;
      int rows;
      wg_tile<CONS>(q, slot + q.slots * i, m0, rows);
      int last = -1;      // the stage of the k-tile before, still read
      for (int kt = 0; kt < q.nk; ++kt) {
        mbar_wait(&full[s], phase);
        const unsigned char* stage = ring + s * stage_bytes;
        const uint64_t da =
            sw128_desc(stage + (size_t)cg * kWgRows * kWgRowBytes);
        const uint64_t db = sw128_desc(
            q.w_resident ? w_tiles + kt * wg_w_tile(BN) : stage + a_tile);
        // every step of the k-tile, also past K (zeros there): a wgmma
        // under a branch is serialized by ptxas (C7520)
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kWgBK / 16; ++ks)
          wgmma_bf16<BN>(acc, da + 2 * ks, db + 2 * ks, (kt | ks) != 0);
        wgmma_commit();
        // the k-tile before is done: its stage goes back to the producer
        // while this one's products run
        wgmma_wait<1>();
        if (last >= 0 && lane == 0) mbar_arrive(&empty[last]);
        last = s;
        if (++s == q.stages) s = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      wgmma_fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[last]);
      epi(m0 + kWgRows * cg, min(kWgRows, rows - kWgRows * cg), n0, acc, cg);
    }
  }
}

}  // namespace x3d
