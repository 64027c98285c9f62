// K1: lower-triangular raw Gram D·Dᵀ of an int8 dosage panel, exact int32.
//
// Replaces: genomicbreedingmodels_tpu/ops/pallas_kernels.py
//   `gram_tri_kernel_int8` (launched by `_grm_pallas_padded_int8`), which
//   walks a 1-D grid of lower-triangular (tm, tm) tiles decoded by
//   `_tri_decode` and accumulates marker blocks in VMEM.
//
// What bounds it on an H100: the algorithm is compute bound (n²p/2 multiply-
// adds on n·p bytes, ~n ops per byte against a ~600 ops/byte int8/HBM ridge),
// but one 128x128 tile reads 256 bytes per marker for 32768 ops, 128 ops per
// byte: the kernel reaches the int8 tensor-core rate only as far as L2 serves
// the row blocks that concurrent tiles share. Larger tiles, a persistent
// L2-aware tile order and wgmma are later work.
//
// Design: one CTA per lower-triangular 128x128 output tile (the Pallas 1-D
// triangular grid, decoded here from blockIdx.x with an integer sqrt and the
// same two boundary corrections), so the upper tiles cost neither FLOPs nor
// HBM traffic. The marker loop runs inside the CTA (CUDA blocks have no order
// to carry a sum across): 64-byte slabs of both row blocks are staged through
// shared memory, the next slab is fetched into registers while the tensor
// cores work on the current one, and 8 warps each own a 64x32 sub-tile
// computed with mma.sync.m16n8k32 s8·s8->s32. Exact while p·k² < 2³¹ (the
// wrapper raises otherwise). wgmma, TMA and a deeper pipeline are later work.
//
// Traps handled: 64-bit row offsets (row·p passes 2³¹ just above the 8192 x
// 262144 panel); ragged n and p masked with zeros at the shared-memory load
// (16-byte vector loads only when p % 16 == 0 and the base is 16-byte
// aligned, byte loads otherwise); diagonal tiles write only col <= row, so the
// strict upper triangle keeps the zeros the wrapper allocated.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;           // output tile edge (rows and columns)
constexpr int BK = 64;            // markers (bytes) per shared-memory slab
constexpr int LDS = BK + 16;      // smem row stride: 80 B keeps fragment reads conflict-free
constexpr int THREADS = 256;      // 8 warps: 2 along rows x 4 along columns
constexpr int WM = 64, WN = 32;   // warp sub-tile
constexpr int MT = WM / 16, NT = WN / 8;              // mma tiles per warp
constexpr int CHUNKS = BM * BK / 16 / THREADS;        // 16-byte loads per thread per operand

__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  int r = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  if (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  i = r;
  j = static_cast<int>(t - static_cast<long long>(r) * (r + 1) / 2);
}

union Chunk {
  int4 v;
  int8_t b[16];
};

// 16 bytes of row `row` starting at marker `k`, zero outside the panel.
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ D, long long row,
                                           long long k, long long n, long long p, bool vec) {
  Chunk c;
  c.v = make_int4(0, 0, 0, 0);
  if (row >= n || k >= p) return c.v;
  const int8_t* src = D + row * p + k;
  if (vec) return *reinterpret_cast<const int4*>(src);  // p % 16 == 0: chunk fully inside
#pragma unroll
  for (int q = 0; q < 16; ++q) c.b[q] = (k + q < p) ? src[q] : int8_t(0);
  return c.v;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
gram_tri_int8_kernel(const int8_t* __restrict__ D, int32_t* __restrict__ out,
                     long long n, long long p, bool vec) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BM * LDS];

  int ti, tj;
  tri_decode(blockIdx.x, ti, tj);
  const long long row0 = static_cast<long long>(ti) * BM;
  const long long col0 = static_cast<long long>(tj) * BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;  // mma group id / thread in group
  const int wm = (warp & 1) * WM, wn = (warp >> 1) * WN;

  int acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0;

  // Load slot q of this thread: tile row (tid + q*THREADS) / 4, byte column 16*(.. % 4).
  int4 ra[CHUNKS], rb[CHUNKS];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const int c = tid + q * THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      ra[q] = load_chunk(D, row0 + r, k0 + kc, n, p, vec);
      rb[q] = load_chunk(D, col0 + r, k0 + kc, n, p, vec);
    }
  };

  fetch(0);
  for (long long k0 = 0; k0 < p; k0 += BK) {
#pragma unroll
    for (int q = 0; q < CHUNKS; ++q) {
      const int c = tid + q * THREADS;
      const int r = c >> 2, kc = (c & 3) * 16;
      *reinterpret_cast<int4*>(As + r * LDS + kc) = ra[q];
      *reinterpret_cast<int4*>(Bs + r * LDS + kc) = rb[q];
    }
    __syncthreads();
    if (k0 + BK < p) fetch(k0 + BK);  // in flight while the tensor cores run

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const int8_t* s = As + (wm + m * 16 + g) * LDS + kk + tig * 4;
        af[m][0] = *reinterpret_cast<const uint32_t*>(s);
        af[m][1] = *reinterpret_cast<const uint32_t*>(s + 8 * LDS);
        af[m][2] = *reinterpret_cast<const uint32_t*>(s + 16);
        af[m][3] = *reinterpret_cast<const uint32_t*>(s + 8 * LDS + 16);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int8_t* s = Bs + (wn + t * 8 + g) * LDS + kk + tig * 4;
        bf[t][0] = *reinterpret_cast<const uint32_t*>(s);
        bf[t][1] = *reinterpret_cast<const uint32_t*>(s + 16);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int t = 0; t < NT; ++t) mma_s8(acc[m][t], af[m], bf[t]);
    }
    __syncthreads();
  }

  const bool diag = (ti == tj);
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long r = row0 + wm + m * 16 + g + (e >> 1) * 8;
        const long long c = col0 + wn + t * 8 + tig * 2 + (e & 1);
        if (r < n && c < n && (!diag || c <= r)) out[r * n + c] = acc[m][t][e];
      }
}

}  // namespace

extern "C" int gbm_gram_tri_int8(const void* D, void* out, long long n, long long p,
                                 void* stream) {
  const long long nt = (n + BM - 1) / BM;
  const bool vec = (p % 16 == 0) && (reinterpret_cast<uintptr_t>(D) % 16 == 0);
  gram_tri_int8_kernel<<<static_cast<unsigned>(nt * (nt + 1) / 2), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(D), static_cast<int32_t*>(out), n, p, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
