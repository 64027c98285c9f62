// K2: lower-triangular raw Gram X·Xᵀ of an f32 or bf16 panel, f32 accumulation.
//
// Replaces: genomicbreedingmodels_tpu/ops/pallas_kernels.py `gram_tri_kernel`
//   (launched by `_grm_pallas_padded`): the same triangular tile walk as K1,
//   for continuous / imputed allele frequencies that are not on the dosage
//   grid.
//
// What bounds it on an H100: true float32 FFMA (67 TFLOP/s at 700 W), not
// memory: a 128x128 tile does 32768 FMAs per marker on 1 KB of f32 operands.
// TF32 tensor cores are ruled out on purpose: they keep ~10 mantissa bits,
// and the port is held to 1e-5·max|G| against a float64 product.
//
// Design: one CTA per lower-triangular 128x128 tile, tile id decoded from
// blockIdx.x as in K1. 256 threads each own an 8x8 block of outputs (two 4x4
// quadrants 64 apart, so the float4 shared-memory reads do not conflict).
// Markers are staged 8 at a time through shared memory, transposed to
// k-major with a 4-float pad, and the next slab is fetched into registers
// while the current one is consumed. bf16 operands are widened to f32 on the
// way into shared memory (exact), so both input types use the same FFMA loop.
// Accuracy: products accumulate into a partial sum that is folded into the
// running total every 256 markers, which keeps the rounding of a 32768-term
// sum near that of a 256-term one at the cost of 64 more registers.
// Ragged n and p are masked with zeros at the load; offsets are 64-bit;
// diagonal tiles write only col <= row (the strict upper triangle keeps the
// wrapper's zeros).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 128;              // output tile edge
constexpr int BK = 8;                // markers per shared-memory slab
constexpr int LDA = BM + 4;          // padded smem row (k-major): conflict-free transposed stores
constexpr int THREADS = 256;         // 16 x 16 threads, 8x8 outputs each
constexpr int LOADS = BM * BK / THREADS;  // operand elements per thread per slab
constexpr int FOLD = 32;             // slabs per partial sum (256 markers)

__device__ __forceinline__ void tri_decode(long long t, int& i, int& j) {
  int r = static_cast<int>((sqrt(8.0 * static_cast<double>(t) + 1.0) - 1.0) * 0.5);
  if (static_cast<long long>(r + 1) * (r + 2) / 2 <= t) ++r;
  if (static_cast<long long>(r) * (r + 1) / 2 > t) --r;
  i = r;
  j = static_cast<int>(t - static_cast<long long>(r) * (r + 1) / 2);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_tri_float_kernel(const T* __restrict__ X, float* __restrict__ out, long long n, long long p) {
  __shared__ __align__(16) float As[BK][LDA];
  __shared__ __align__(16) float Bs[BK][LDA];

  int ti, tj;
  tri_decode(blockIdx.x, ti, tj);
  const long long row0 = static_cast<long long>(ti) * BM;
  const long long col0 = static_cast<long long>(tj) * BM;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[8][8], part[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = part[a][b] = 0.f;

  // Load slot q: tile row (tid + q*THREADS) / BK, marker (.. % BK): a warp reads
  // 4 rows x 8 consecutive markers.
  float ra[LOADS], rb[LOADS];
  auto fetch = [&](long long k0) {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + q * THREADS;
      const int r = e / BK, kk = e % BK;
      const long long k = k0 + kk;
      const long long gi = row0 + r, gj = col0 + r;
      ra[q] = (gi < n && k < p) ? to_f32(X[gi * p + k]) : 0.f;
      rb[q] = (gj < n && k < p) ? to_f32(X[gj * p + k]) : 0.f;
    }
  };

  fetch(0);
  int slab = 0;
  for (long long k0 = 0; k0 < p; k0 += BK) {
#pragma unroll
    for (int q = 0; q < LOADS; ++q) {
      const int e = tid + q * THREADS;
      As[e % BK][e / BK] = ra[q];
      Bs[e % BK][e / BK] = rb[q];
    }
    __syncthreads();
    if (k0 + BK < p) fetch(k0 + BK);

#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) part[u][v] = fmaf(a[u], b[v], part[u][v]);
    }
    __syncthreads();

    if (++slab == FOLD) {
      slab = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          acc[u][v] += part[u][v];
          part[u][v] = 0.f;
        }
    }
  }

  const bool diag = (ti == tj);
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const long long r = row0 + ty * 4 + (u & 3) + (u >> 2) * 64;
      const long long c = col0 + tx * 4 + (v & 3) + (v >> 2) * 64;
      if (r < n && c < n && (!diag || c <= r)) out[r * n + c] = acc[u][v] + part[u][v];
    }
}

template <typename T>
int launch(const void* X, void* out, long long n, long long p, void* stream) {
  const long long nt = (n + BM - 1) / BM;
  gram_tri_float_kernel<T><<<static_cast<unsigned>(nt * (nt + 1) / 2), THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(X), static_cast<float*>(out), n, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gbm_gram_tri_f32(const void* X, void* out, long long n, long long p,
                                void* stream) {
  return launch<float>(X, out, n, p, stream);
}

extern "C" int gbm_gram_tri_bf16(const void* X, void* out, long long n, long long p,
                                 void* stream) {
  return launch<__nv_bfloat16>(X, out, n, p, stream);
}
