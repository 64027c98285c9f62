// Hopper mainloop shared by K1 (int8) and K2 (f32, bf16): the lower-triangular
// raw Gram X·Xᵀ of an entry-major (n, p) panel, one templated kernel.
//
// Replaces: genomicbreedingmodels_tpu/ops/pallas_kernels.py
//   `gram_tri_kernel_int8` (K1, launched by `_grm_pallas_padded_int8`) and
//   `gram_tri_kernel` (K2, launched by `_grm_pallas_padded`): a 1-D grid of
//   lower-triangular output tiles with the marker blocks as the inner loop.
//
// What bounds it on an H100: operations. The lower half of X·Xᵀ is n(n+1)/2·p
// multiply-adds on n·p operand bytes, n ops per byte against a ridge of ~600
// (int8) or ~300 (bf16): int8 at 1979 TOP/s, bf16 at 989 TFLOP/s, f32 on the
// tensor cores as three TF32 products at 495 TFLOP/s each. A tile reads its
// operands from L2 once per marker slab, so the bytes staged from L2 into
// shared memory per operation are the next limit:
// - K1: a 128x256 int8 tile does 170 ops per byte it stages, and K1 at
//   8192x262144 with one CTA per tile staged 106 GB from L2 in 15 ms
//   (7.1 TB/s). So K1 runs in clusters of two CTAs that share each B slab
//   (below): 71 GB.
// - K2 on bf16: a 128x128 tile does 64 flop per byte it stages. One CTA per
//   tile staged 2080 tiles x 4096 k-blocks x 32 KB = 279 GB at 8192x262144,
//   in 71 ms on an H100 (3.9 TB/s, 25 % of the bound). In 2x2 clusters that
//   multicast both operands (below) each CTA loads one 16 KB box a k-block
//   for two CTAs: 528 x 4096 x 64 KB = 142 GB, 128 flop per staged byte, in
//   32 ms (55 % of the bound). A 2x1 cluster sharing B alone (213 GB) on all
//   132 SMs took 55 ms: the bytes staged, not the 12 SMs that 30 four-CTA
//   clusters leave idle, set the time.
//
// Design (sm_90a only: wgmma and setmaxnreg):
// - Operands by TMA. One CUtensorMap over the panel, 2-D boxes of
//   (128 rows x 128 bytes) with 128-byte swizzle into a ring of STAGES
//   shared-memory stages, each guarded by a `full` (TMA bytes landed) and an
//   `empty` (the consumer warpgroups of every CTA this one loads into done)
//   mbarrier. The panel is
//   entry-major, so both operands are K-major as they stand: no transpose.
//   Ragged n and p are zero-filled by TMA's out-of-bounds fill; the wrapper
//   guarantees the 16-byte base and row-stride alignment TMA needs.
// - Warp specialisation: warpgroup 0 is the producer (one thread issues the
//   loads; setmaxnreg.dec to 40 registers), warpgroups 1 and 2 each own 64
//   rows of the CTA's 128-row output tile (setmaxnreg.inc to 232) and issue
//   wgmma.mma_async straight from the swizzled stages.
// - K1 in 2x1 clusters (CLUSTER_M x CLUSTER_N CTAs): one cluster owns a
//   256x256 tile, each CTA 128 rows of it, and each CTA loads its own A rows
//   and one 128-row box of the shared B slab, multicast into both CTAs. A
//   stage is free once the consumers of both CTAs released it (remote
//   mbarrier arrives). With BN = 2·BM the two row blocks of a cluster need
//   the same column blocks, so no cluster tile is half empty. The arrives are
//   CTA-scope releases, as CUTLASS's: a cluster-scope release waited for the
//   wgmmas still in flight and made K1 twice as slow on an H100.
// - K2 on bf16 at large n in 2x2 clusters (OpBF16Quad): one cluster owns a
//   256x256 tile and CTA (r, c) = rank (2r + c) its 128x128 quarter at rows
//   128r, columns 128c. Each k-block, CTA (r, r) multicasts the A box of row
//   block r to (r, 0) and (r, 1), and CTA (1 - c, c) the B box of column
//   block c to (0, c) and (1, c): one 16 KB box per CTA, 32 KB landing in
//   each. A CTA's consumers release a stage to the two CTAs that loaded it;
//   a loader refills its slot once both of its readers released it. On a
//   diagonal cluster tile CTA (0, 1) lies above the diagonal: it still loads
//   and computes, and writes nothing. The CTA tile, mainloop and fold are
//   OpBF16's, so the two schedules give the same bits where they split the
//   markers alike. The CTA tile stays 128x128 because of the fold's
//   registers (below): K1's 128x256 CTA tile would need 256 a thread.
// - K2's schedule on bf16 (`bf16_quad`): one CTA per 128x128 tile where those
//   tiles fit one wave of the card's SMs (n <= 1920 on 132 SMs), 2x2
//   clusters beyond. 30 four-CTA clusters fit an H100 at once, so where one
//   CTA per tile takes a single wave the clusters' coarser waves lose
//   (1844x16384: 0.20 against 0.18 ms); past it they win (2048x32768: 0.34
//   against 0.43 ms; 8192x262144: 32 against 71 ms).
// - Persistent CTAs, one per SM, in an L2-aware order: the lower-triangular
//   (cluster) tiles are enumerated in groups of GROUP row blocks, column
//   block outer, row block inner, and work unit u goes to cluster
//   u % clusters. A wave of consecutive tiles then covers ~GROUP row blocks
//   and a few column blocks, so each marker slab comes from HBM about once
//   per wave. `kernels/gram_tri.py:tile_schedule` mirrors this enumeration.
// - Marker splits against the last, partial wave: where splitting every tile's
//   markers S ways fills the waves better (`marker_splits`), a work unit is
//   (tile, split) and adds its partial sum into the zero-filled output with
//   atomics. int32 sums are exact in any order; float tiles split at most in
//   two, and 0 + a + b == 0 + b + a, so the result stays deterministic.
// - Only tiles that touch the lower triangle are visited; a tile crossing
//   the diagonal writes only col <= row, so the strict upper triangle keeps
//   the zeros the wrapper allocated.
// - K1 (Op S8): m64n256k32 s8·s8 -> s32, exact (the wrapper keeps
//   p·ploidy² < 2³¹). Tile 128x256 per CTA, 256x256 per cluster, 4 stages
//   of 48 KB.
// - K2 bf16 (Op BF16, OpBF16Quad): m64n128k16 bf16·bf16 -> f32. Tile
//   128x128 per CTA, 6 stages of 32 KB (7 ran no faster in 2x2 clusters).
// - K2 f32 (Op TF32): 3xTF32. After a stage lands, the consumers split it in
//   shared memory into hi = round-to-TF32(x) (in place) and lo = x - hi (the
//   stage's second half; the split is elementwise, so lo keeps the swizzled
//   layout), then issue lo·hi + hi·lo + hi·hi through m64n128k8 tf32. The
//   lo·lo term (~2⁻²² relative) is dropped. Tile 128x128, 3 stages of 32 KB
//   of operands + 32 KB of lo: a fourth TMA stage with lo in three buffers
//   beside the ring fits too (225 KB) but ran 7-9 % slower on an H100. The
//   split costs each consumer thread 8 float4 loads and 16 stores of shared
//   memory and one named barrier per stage, in place of a pre-pass over the
//   panel (2·n·p·4 more bytes of HBM traffic and a second kernel).
// - Float accumulation: the tensor cores add each k-step into an f32
//   register accumulator, and their rounding grows with the number of
//   k-steps summed. Over tens of thousands of markers it approaches the
//   1e-5·max|G| the port is held to, so the float paths accumulate a window
//   of markers into `part` and fold it into `acc` with one FADD per element
//   and a drain of the wgmma pipeline: 256 markers for 3xTF32 (three
//   products per k-step: 2.9e-6·max|G| at 2048x32768 on an H100), 1024 for
//   bf16 (2.4e-6·max|G| there, against 1.1e-6 and a 10 % longer run when
//   folding every 256). acc + part need 128 registers a thread at n128 and
//   256 at n256, more than a consumer thread can hold, which is why the float
//   CTA tiles are 128x128 and the int8 tile, which needs no fold, is 128x256;
//   bf16 shares operands across CTAs instead (2x2 clusters, above).

#pragma once

#include <cuda.h>  // CUtensorMap and the driver enums only: the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace gbm_sm90 {

constexpr int BM = 128;           // output tile rows: two consumer warpgroups x 64
constexpr int ROW_BYTES = 128;    // bytes of one operand row per stage: one 128-byte swizzle span
constexpr int A_BYTES = BM * ROW_BYTES;
constexpr int GROUP = 16;         // row blocks per L2 group of the tile order
constexpr int THREADS = 384;      // producer warpgroup + two consumer warpgroups
constexpr int MIN_SPLIT_BLOCKS = 64;  // k-blocks (stages) per marker split, at least: a split
                                      // adds a pipeline fill and an epilogue of atomics
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;  // 128·40 + 256·232 <= 65536

// ---- the tile order (mirrored by kernels/gram_tri.py:tile_schedule) ---------

__host__ __device__ inline int cdiv(long long a, int b) { return static_cast<int>((a + b - 1) / b); }

// Last column block that row block i of bm rows needs: the one holding column
// bm·i + bm - 1.
__host__ __device__ inline int last_col_block(int i, int bm, int bn, int nc) {
  const int j = (bm * i + bm - 1) / bn;
  return j < nc - 1 ? j : nc - 1;
}

// The lower-triangular tiles of bm x bn (bm: the rows of one cluster's tile).
struct TileCursor {
  int nr, nc, bm, bn, g0, g1, i, j, jend;
  __host__ __device__ TileCursor(long long n, int bm_, int bn_)
      : nr(cdiv(n, bm_)), nc(cdiv(n, bn_)), bm(bm_), bn(bn_) {
    g0 = 0;
    g1 = GROUP < nr ? GROUP : nr;
    j = 0;
    i = g0 - 1;
    jend = last_col_block(g1 - 1, bm, bn, nc);
  }
  // Advance to the next lower-triangular tile; false once all were visited.
  // Each tile comes once: a new group starts at its own first row block.
  __host__ __device__ bool next(int& ti, int& tj) {
    for (;;) {
      if (++i >= g1) {
        if (++j > jend) {
          g0 = g1;
          if (g0 >= nr) return false;
          g1 = g0 + GROUP < nr ? g0 + GROUP : nr;
          j = 0;
          jend = last_col_block(g1 - 1, bm, bn, nc);
        }
        i = g0;
      }
      if (j <= last_col_block(i, bm, bn, nc)) {
        ti = i;
        tj = j;
        return true;
      }
    }
  }
};

inline int count_tiles(long long n, int bm, int bn) {
  const int nr = cdiv(n, bm), nc = cdiv(n, bn);
  int t = 0;
  for (int i = 0; i < nr; ++i) t += last_col_block(i, bm, bn, nc) + 1;
  return t;
}

// Marker splits per tile (mirrored by kernels/gram_tri.py:marker_splits): the
// fewest S <= max_splits that minimise the waves ceil(S·tiles / ctas) / S,
// with at least MIN_SPLIT_BLOCKS k-blocks per split; ctas counts the
// persistent clusters. 136 tiles on 132 SMs run in two waves unsplit and in
// 1.5 split in two; 528 cluster tiles (K1's headline) fill 66 clusters 8
// times and stay whole.
inline int marker_splits(int tiles, int ctas, int nk, int max_splits) {
  int best = 1;
  for (int s = 2; s <= max_splits && s * MIN_SPLIT_BLOCKS <= nk; ++s)
    if (static_cast<long long>(cdiv(static_cast<long long>(s) * tiles, ctas)) * best <
        static_cast<long long>(cdiv(static_cast<long long>(best) * tiles, ctas)) * s)
      best = s;
  return best;
}

// K2's schedule on a bf16 panel (mirrored by kernels/gram_tri.py:bf16_quad):
// one CTA per 128x128 tile (OpBF16) where those tiles fit one wave of the
// card's `sms` SMs, 2x2 clusters of such CTAs (OpBF16Quad) beyond.
inline bool bf16_quad(long long n, int sms) { return count_tiles(n, BM, BM) > sms; }

// ---- PTX helpers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive on the mbarrier at `bar`'s offset in cluster CTA `cta` (this CTA too).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Spin until the phase of parity `parity` has completed. No wait of a correct
// run lasts a millisecond; one that lasts 2³⁴ cycles (~9 s) is a broken
// pipeline, and the kernel traps: the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

// One (128 rows x 128 bytes) box at (marker k, row r) into `dst`; completes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k, int r,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(r), "r"(smem_u32(bar))
      : "memory");
}

// The same box into `dst` of every CTA in `mask`, each completing on its own
// mbarrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, int k, int r,
                                                   uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k), "r"(r), "r"(smem_u32(bar)), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in the 128-byte swizzle
// layout TMA wrote: 8-row core groups 1024 bytes apart (SBO), start address in
// 16-byte units; a k-step inside the 128-byte row advances the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the accumulator in place across the asynchronous wgmma (as CUTLASS's
// warpgroup_fence_operand): the compiler may not move or reuse these registers.
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float round_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// ---- wgmma, one k-step (32 bytes of each operand row) -------------------------

__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_s8_n256(int32_t (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- operand types -------------------------------------------------------------

struct OpS8 {  // K1
  using T = int8_t;
  using Acc = int32_t;
  static constexpr int BN = 256, STAGES = 4, FOLD = 0;  // FOLD: stages per partial sum, 0 = none
  static constexpr int MAX_SPLITS = 8;  // int32 atomics are exact in any order
  static constexpr int CLUSTER_M = 2, CLUSTER_N = 1;  // 2x1 CTAs sharing each B slab by TMA multicast
  static constexpr bool HI_LO = false;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  __device__ __forceinline__ static void mma(Acc (&d)[BN / 2], uint32_t a, uint32_t b, uint32_t,
                                             uint32_t) {
    wgmma_s8_n256(d, desc_sw128(a), desc_sw128(b), 1);
  }
};

struct OpBF16 {  // K2, bf16 panels, one CTA per tile (small n)
  using T = __nv_bfloat16;
  using Acc = float;
  static constexpr int BN = 128, STAGES = 6, FOLD = 1024 / (ROW_BYTES / 2);  // 1024 markers
  static constexpr int MAX_SPLITS = 2;  // 0 + a + b == 0 + b + a: two float partials stay deterministic
  static constexpr int CLUSTER_M = 1, CLUSTER_N = 1;
  static constexpr bool HI_LO = false;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  __device__ __forceinline__ static void mma(Acc (&d)[BN / 2], uint32_t a, uint32_t b, uint32_t,
                                             uint32_t) {
    wgmma_bf16_n128(d, desc_sw128(a), desc_sw128(b), 1);
  }
};

// K2, bf16 panels at large n: the same CTA tile, mainloop and fold in 2x2
// clusters that multicast both operands (`bf16_quad` chooses).
struct OpBF16Quad : OpBF16 {
  static constexpr int CLUSTER_M = 2, CLUSTER_N = 2;
};

struct OpTF32 {  // K2, f32 panels, 3xTF32
  using T = float;
  using Acc = float;
  static constexpr int BN = 128, STAGES = 3, FOLD = 256 / (ROW_BYTES / 4);  // 256 markers
  static constexpr int MAX_SPLITS = 2;
  static constexpr int CLUSTER_M = 1, CLUSTER_N = 1;
  static constexpr bool HI_LO = true;
  static constexpr CUtensorMapDataType DTYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  // Small terms first: lo·hi + hi·lo, then hi·hi.
  __device__ __forceinline__ static void mma(Acc (&d)[BN / 2], uint32_t a, uint32_t b,
                                             uint32_t a_lo, uint32_t b_lo) {
    wgmma_tf32_n128(d, desc_sw128(a_lo), desc_sw128(b), 1);
    wgmma_tf32_n128(d, desc_sw128(a), desc_sw128(b_lo), 1);
    wgmma_tf32_n128(d, desc_sw128(a), desc_sw128(b), 1);
  }
};

// Shared memory: the ring of STAGES stages (A rows, then B rows, then for
// 3xTF32 their lo halves), then the mbarriers.
template <class Op>
struct Layout {
  static constexpr int B_BYTES = Op::BN * ROW_BYTES;
  static constexpr int TX_BYTES = A_BYTES + B_BYTES;                   // bytes TMA lands per stage
  static constexpr int STAGE_BYTES = TX_BYTES * (Op::HI_LO ? 2 : 1);  // + lo halves for 3xTF32
  static constexpr int BAR_OFFSET = Op::STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFFSET + 2 * Op::STAGES * 8 + 1024;
  static constexpr int K_ELEMS = ROW_BYTES / static_cast<int>(sizeof(typename Op::T));
  static constexpr int NREG = Op::BN / 2;  // accumulator registers per thread (m64 x BN / 128)
  static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");
  static_assert(Op::BN % BM == 0, "B is loaded in BM-row boxes");
  static_assert(Op::CLUSTER_N == 1 ? (Op::BN / BM) % Op::CLUSTER_M == 0
                                   : Op::CLUSTER_M == 2 && Op::CLUSTER_N == 2 && Op::BN == BM,
                "clusters are 1x1, Nx1 sharing whole boxes of B, or 2x2 of one box per CTA");
};

// 3xTF32 split of this warpgroup's share of a landed stage: its 64 A rows and
// half of the B rows. hi replaces x in place, lo goes to the same offset of
// the stage's second half.
template <class Op>
__device__ __forceinline__ void split_stage(uint8_t* st, int w, int t) {
  using L = Layout<Op>;
  constexpr int A_HALF = A_BYTES / 2, B_HALF = L::B_BYTES / 2;
  float4* a = reinterpret_cast<float4*>(st + w * A_HALF);
  float4* a_lo = reinterpret_cast<float4*>(st + L::TX_BYTES + w * A_HALF);
  float4* b = reinterpret_cast<float4*>(st + A_BYTES + w * B_HALF);
  float4* b_lo = reinterpret_cast<float4*>(st + L::TX_BYTES + A_BYTES + w * B_HALF);
  auto split = [](float4* x, float4* lo, int idx) {
    const float4 v = x[idx];
    const float4 h = make_float4(round_tf32(v.x), round_tf32(v.y), round_tf32(v.z), round_tf32(v.w));
    x[idx] = h;
    lo[idx] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  };
#pragma unroll
  for (int q = 0; q < A_HALF / 16 / 128; ++q) split(a, a_lo, t + 128 * q);
#pragma unroll
  for (int q = 0; q < B_HALF / 16 / 128; ++q) split(b, b_lo, t + 128 * q);
}

template <class Op>
__global__ void __launch_bounds__(THREADS, 1)
gram_tri_sm90_kernel(const __grid_constant__ CUtensorMap map, typename Op::Acc* __restrict__ out,
                     long long n, long long p, int splits) {
  using L = Layout<Op>;
  using Acc = typename Op::Acc;
  constexpr int STAGES = Op::STAGES, NREG = L::NREG;
  constexpr int CM = Op::CLUSTER_M, CN = Op::CLUSTER_N, CLUSTER = CM * CN;
  // A cluster's tile is BMC x BNC; CTA `rank` = (crow, ccol) owns BM x BN of it.
  constexpr int BMC = BM * CM, BNC = Op::BN * CN;
  // CTAs whose consumers read what this CTA's producer loads, each releasing
  // the stage to it: Nx1, the column (its own A rows, its B box multicast);
  // 2x2, the two CTAs its one box is multicast to.
  constexpr int READERS = CN == 1 ? CM : 2;
  const uint32_t rank = CLUSTER > 1 ? cluster_rank() : 0;
  const uint32_t crow = rank / CN, ccol = rank % CN;

  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle wants 1024-byte aligned boxes.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFFSET);
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);             // the producer's arrive.expect_tx
      mbar_init(&empty[s], 8 * READERS);  // lane 0 of the 8 consumer warps of each reader
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(&map)) : "memory");
  }
  if constexpr (CLUSTER > 1)
    cluster_sync();  // the partners' barriers are initialised before any multicast
  else
    __syncthreads();

  const int nk = cdiv(p, L::K_ELEMS);
  const int wg = threadIdx.x / 128;
  TileCursor cur(n, BMC, BNC);
  int ti, tj, stage = 0;
  uint32_t phase = 0;
  // Work unit u = (cluster tile, marker split s) goes to cluster u % clusters;
  // split s takes k-blocks [s·nk/splits, (s+1)·nk/splits).
  const int cluster = blockIdx.x / CLUSTER, clusters = gridDim.x / CLUSTER;
  int u = 0;
  auto mine = [&]() { return u++ % clusters == cluster; };

  if (wg == 0) {
    // ---- producer: one thread keeps the ring full --------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      while (cur.next(ti, tj)) for (int s = 0; s < splits; ++s) {
        if (!mine()) continue;
        const int k0 = s * nk / splits, k1 = (s + 1) * nk / splits;
        for (int kb = k0; kb < k1; ++kb) {
          // In a cluster, the stage is free once the consumers of every CTA this
          // one loads into released it: its multicast writes their copies too.
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], L::TX_BYTES);  // all of A and B land in every CTA
          uint8_t* st = smem + stage * L::STAGE_BYTES;
          if constexpr (CN == 1) {
            tma_load(st, &map, kb * L::K_ELEMS, ti * BMC + rank * BM, &full[stage]);
#pragma unroll
            for (int c = 0; c < Op::BN / BM; ++c) {
              uint8_t* dst = st + A_BYTES + c * A_BYTES;
              if constexpr (CLUSTER > 1) {
                if (c % CLUSTER == static_cast<int>(rank))
                  tma_load_multicast(dst, &map, kb * L::K_ELEMS, tj * Op::BN + c * BM, &full[stage],
                                     static_cast<uint16_t>((1 << CLUSTER) - 1));
              } else {
                tma_load(dst, &map, kb * L::K_ELEMS, tj * Op::BN + c * BM, &full[stage]);
              }
            }
          } else if (crow == ccol) {  // 2x2: A of cluster row crow, to ranks 2·crow and 2·crow + 1
            tma_load_multicast(st, &map, kb * L::K_ELEMS, ti * BMC + crow * BM, &full[stage],
                               static_cast<uint16_t>(3u << (2 * crow)));
          } else {  // 2x2: B of cluster column ccol, to ranks ccol and 2 + ccol
            tma_load_multicast(st + A_BYTES, &map, kb * L::K_ELEMS, tj * BNC + ccol * BM, &full[stage],
                               static_cast<uint16_t>(5u << ccol));
          }
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup w owns rows 64w..64w+63 of the tile ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int w = wg - 1, tw = threadIdx.x & 127, lane = threadIdx.x & 31, warp = tw / 32;
    Acc acc[NREG];
    Acc part[Op::FOLD ? NREG : 1];
    auto release = [&](int s) {
      if (lane == 0) {
        if constexpr (CN > 1) {  // 2x2: the loaders of this stage's A, (crow, crow), and B, (1 - ccol, ccol)
          mbar_arrive_cluster(&empty[s], 3 * crow);
          mbar_arrive_cluster(&empty[s], 2 - ccol);
        } else if constexpr (CLUSTER > 1) {
#pragma unroll
          for (int q = 0; q < CLUSTER; ++q) mbar_arrive_cluster(&empty[s], q);
        } else {
          mbar_arrive(&empty[s]);
        }
      }
    };

    while (cur.next(ti, tj)) for (int s = 0; s < splits; ++s) {
      if (!mine()) continue;
      const int k0 = s * nk / splits, k1 = (s + 1) * nk / splits;
#pragma unroll
      for (int r = 0; r < NREG; ++r) acc[r] = Acc(0);
      if constexpr (Op::FOLD) {
#pragma unroll
        for (int r = 0; r < NREG; ++r) part[r] = Acc(0);
      }
      int pend = -1;  // stage whose wgmmas may still be in flight
      for (int kb = k0; kb < k1; ++kb) {
        mbar_wait(&full[stage], phase);
        uint8_t* st = smem + stage * L::STAGE_BYTES;
        if constexpr (Op::HI_LO) {
          split_stage<Op>(st, w, tw);
          // generic-proxy writes -> wgmma (async proxy), then both halves of B.
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, 256;" ::: "memory");
        }
        const uint32_t a = smem_u32(st) + w * (A_BYTES / 2), b = smem_u32(st) + A_BYTES;
        const uint32_t a_lo = a + L::TX_BYTES, b_lo = b + L::TX_BYTES;
        if constexpr (Op::FOLD) {
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < ROW_BYTES / 32; ++kk)
            Op::mma(part, a + 32 * kk, b + 32 * kk, a_lo + 32 * kk, b_lo + 32 * kk);
          wgmma_commit();
          fence_regs(part);
        } else {
          fence_regs(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < ROW_BYTES / 32; ++kk)
            Op::mma(acc, a + 32 * kk, b + 32 * kk, a_lo + 32 * kk, b_lo + 32 * kk);
          wgmma_commit();
          fence_regs(acc);
        }
        if (Op::FOLD && ((kb + 1 - k0) % (Op::FOLD ? Op::FOLD : 1) == 0 || kb + 1 == k1)) {
          wgmma_wait<0>();
          if constexpr (Op::FOLD) {
            fence_regs(part);
#pragma unroll
            for (int r = 0; r < NREG; ++r) {
              acc[r] += part[r];
              part[r] = Acc(0);
            }
          }
          if (pend >= 0) release(pend);
          release(stage);
          pend = -1;
        } else {
          wgmma_wait<1>();  // the previous stage's wgmmas are done
          if (pend >= 0) release(pend);
          pend = stage;
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (pend >= 0) release(pend);

      // Epilogue: the m64nBN accumulator layout; lower triangle only. Split
      // tiles add their partial sums into the zero-filled output.
      const long long r0 =
          static_cast<long long>(ti) * BMC + crow * BM + 64 * w + 16 * warp + (lane >> 2);
      const long long c0 = static_cast<long long>(tj) * BNC + ccol * Op::BN + 2 * (lane & 3);
      auto epilogue = [&](auto put) {
#pragma unroll
        for (int r = 0; r < NREG; ++r) {
          const long long row = r0 + 8 * ((r >> 1) & 1);
          const long long col = c0 + 8 * (r >> 2) + (r & 1);
          if (row < n && col <= row) put(&out[row * n + col], acc[r]);
        }
      };
      if (splits == 1)
        epilogue([](Acc* o, Acc v) { *o = v; });
      else
        epilogue([](Acc* o, Acc v) { atomicAdd(o, v); });
    }
  }
  // No CTA of a cluster exits while a partner may still arrive on its
  // barriers or multicast into its shared memory.
  if constexpr (CLUSTER > 1) cluster_sync();
}

// ---- host side -----------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no -lcuda at link time.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// X: (n, p) row-major on the device, base 16-byte aligned, p·sizeof(T) % 16 == 0
// (the wrapper pads and copies to guarantee both). out: (n, n), zero-filled.
template <class Op>
int launch(const void* X, void* out, long long n, long long p, void* stream) {
  using L = Layout<Op>;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorSymbolNotFound);
  if ((reinterpret_cast<uintptr_t>(X) & 15) || (p * sizeof(typename Op::T)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(p * sizeof(typename Op::T))};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(L::K_ELEMS), static_cast<cuuint32_t>(BM)};
  const cuuint32_t estride[2] = {1, 1};
  if (encode(&map, Op::DTYPE, 2, const_cast<void*>(X), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(gram_tri_sm90_kernel<Op>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int CLUSTER = Op::CLUSTER_M * Op::CLUSTER_N;
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = CLUSTER;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM_BYTES;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = CLUSTER > 1 ? 1 : 0;
  // Persistent: as many clusters as fit on the card at once (one CTA per SM).
  int clusters = 0;
  if constexpr (CLUSTER > 1) {
    cfg.gridDim = dim3(CLUSTER);
    err = cudaOccupancyMaxActiveClusters(&clusters, gram_tri_sm90_kernel<Op>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&clusters, cudaDevAttrMultiProcessorCount, dev);
  }
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int tiles = count_tiles(n, BM * Op::CLUSTER_M, Op::BN * Op::CLUSTER_N);
  const int splits = marker_splits(tiles, clusters, cdiv(p, L::K_ELEMS), Op::MAX_SPLITS);
  const int units = tiles * splits;
  cfg.gridDim = dim3(CLUSTER * (units < clusters ? units : clusters));
  err = cudaLaunchKernelEx(&cfg, gram_tri_sm90_kernel<Op>, map, static_cast<typename Op::Acc*>(out),
                           n, p, splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// K2 on a bf16 panel, in the schedule `bf16_quad` picks for its n on this card.
inline int launch_bf16(const void* X, void* out, long long n, long long p, void* stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return bf16_quad(n, sms) ? launch<OpBF16Quad>(X, out, n, p, stream) : launch<OpBF16>(X, out, n, p, stream);
}

}  // namespace gbm_sm90
