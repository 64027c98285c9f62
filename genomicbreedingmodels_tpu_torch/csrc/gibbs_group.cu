// K3: one marker block's grouped 2^K-pattern collapsed Gibbs draw (BayesB/C,
// BLπ, BayesTπ).
//
// Replaces: genomicbreedingmodels_tpu/ops/pallas_gibbs.py `_kernel` (launched
//   by `grouped_block_update`): for each of the G = bs/K marker groups in
//   sequence, score all 2^K inclusion patterns γ by the collapsed
//   (effect-integrated) log-weight
//     Σγ·logπ + Σ(1−γ)·log(1−π) − ½Σ_γ log s² − ½log|P(γ)| + ½‖L⁻¹(v∘γ)‖² + gumbel,
//   with P(γ) = (C_gg∘γγᵀ)/σ²ₑ + diag(γ/s² + 1−γ) = L·Lᵀ and
//   v = (u − cdelta + C_gg·b_g)/σ²ₑ; take the Gumbel-argmax pattern; draw the
//   group's effects b = L⁻ᵀ(L⁻¹v + η) masked to it; and fold the change d
//   into the running correlation of the later groups, cdelta += d·Cb[gK:gK+K, :].
//
// What bounds it on an H100: latency. The group loop is inherently
// sequential (group g+1 scores against the residual that group g's draw left)
// and each step is a few hundred flops per pattern, so the kernel keeps ONE
// SM of 132 busy and its time is the length of the dependent chain per group:
// a few block-wide barriers, one argmax across the patterns, one K-row read of
// Cb (the block Gram, 1.44 MB at bs=600, stays in L2), and the K-step
// elimination in registers. Neither FLOPs nor HBM bytes come close to a limit.
//
// Design: one CTA per call with max(32, 2^K) threads; thread t owns pattern t.
// The TPU kernel keeps every (group, pattern) factor resident in two
// (K, K, G·2^K) f32 VMEM tables (4.9 MB each at bs=600, K=8: far beyond the
// 227 KB of shared memory a block may use), so here each thread instead builds
// its K×K precision in registers per group, factors it with the same clamped
// elimination as the reference (max(d, 1e-30), rsqrt), forward-solves L⁻¹(v∘γ)
// alongside it, and forms its log-weight. A warp-shuffle + shared-memory
// argmax picks the pattern (ties to the lowest index, as jnp.argmax). The
// winning thread back-solves and publishes d to shared memory, and all threads
// apply the rank-K update to w = u − cdelta, which lives in shared memory
// (bs floats). Noise (η, Gumbel) is drawn by the caller, so the kernel has no
// RNG. σ²ₑ and π are read from device memory: a block step never syncs the
// host. Left for later: factoring group g+1 while group g scans (the factors
// do not depend on the residual), batching chains/folds across CTAs, and a
// CUDA graph per sweep.

#include <cuda_runtime.h>
#include <climits>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;

template <int K>
__global__ void __launch_bounds__((1 << K) < WARP ? WARP : (1 << K))
gibbs_group_kernel(const float* __restrict__ Cb, const float* __restrict__ u,
                   const float* __restrict__ b, const float* __restrict__ s2,
                   const float* __restrict__ val, const float* __restrict__ eta,
                   const float* __restrict__ gum, const float* __restrict__ sig_e2_p,
                   const float* __restrict__ pi_p, float* __restrict__ delta,
                   float* __restrict__ b_new, float* __restrict__ incl, int bs) {
  constexpr int NPAT = 1 << K;
  constexpr int NT = NPAT < WARP ? WARP : NPAT;
  constexpr int NWARP = NT / WARP;

  extern __shared__ float sh_w[];  // (bs,) u − cdelta
  __shared__ float sh_c[K * K];    // this group's diagonal Gram block C_gg
  __shared__ float sh_b[K], sh_s2[K], sh_val[K], sh_v[K], sh_d[K];
  __shared__ float red_s[NWARP];
  __shared__ int red_i[NWARP];
  __shared__ int sh_best;

  const int tid = threadIdx.x;
  const float sig = *sig_e2_p;
  const float pi = *pi_p;
  const float log_pi = logf(pi);
  const float log_1mpi = log1pf(-fminf(pi, 1.f - 1e-7f));
  for (int c = tid; c < bs; c += NT) sh_w[c] = u[c];

  const int G = bs / K;
  for (int g = 0; g < G; ++g) {
    const int r0 = g * K;
    __syncthreads();  // previous group's update of sh_w (or the init) is complete
    if (tid < K * K) sh_c[tid] = Cb[static_cast<long long>(r0 + tid / K) * bs + r0 + tid % K];
    if (tid < K) {
      sh_b[tid] = b[r0 + tid];
      sh_s2[tid] = s2[r0 + tid];
      sh_val[tid] = val[r0 + tid];
    }
    __syncthreads();
    if (tid < K) {
      float cb = 0.f;
#pragma unroll
      for (int l = 0; l < K; ++l) cb = fmaf(sh_c[tid * K + l], sh_b[l], cb);
      sh_v[tid] = (sh_w[r0 + tid] + cb) / sig;
    }
    __syncthreads();

    // ---- this thread's pattern: precision, clamped Cholesky, L⁻¹(v∘γ) ----
    float L[K][K];
    float z[K];
    float mk[K];
    float score = -CUDART_INF_F;
    if (tid < NPAT) {
      float npos = 0.f, nneg = 0.f, nbad = 0.f, logs2 = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const bool bit = (tid >> i) & 1;
        const bool ok = sh_val[i] > 0.f;
        mk[i] = (bit && ok) ? 1.f : 0.f;
        npos += mk[i];
        nneg += (!bit && ok) ? 1.f : 0.f;
        nbad += (bit && !ok) ? 1.f : 0.f;
        if (bit && ok) logs2 += logf(sh_s2[i]);
      }
#pragma unroll
      for (int i = 0; i < K; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) L[i][j] = (sh_c[i * K + j] / sig) * (mk[i] * mk[j]);
        L[i][i] += mk[i] > 0.f ? 1.f / sh_s2[i] : 1.f;
        z[i] = mk[i] > 0.f ? sh_v[i] : 0.f;  // border row: becomes L⁻¹(v∘γ)
      }
      float half_logdet = 0.f, quad = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float dj = fmaxf(L[j][j], 1e-30f);
        half_logdet += 0.5f * logf(dj);
        const float r = rsqrtf(dj);
#pragma unroll
        for (int i = j; i < K; ++i) L[i][j] *= r;
        z[j] *= r;
        quad = fmaf(z[j], z[j], quad);
#pragma unroll
        for (int k = j + 1; k < K; ++k) {
#pragma unroll
          for (int i = k; i < K; ++i) L[i][k] = fmaf(-L[i][j], L[k][j], L[i][k]);
          z[k] = fmaf(-L[k][j], z[j], z[k]);
        }
      }
      score = npos * log_pi + nneg * log_1mpi - 0.5f * logs2 - half_logdet + 0.5f * quad -
              1e30f * nbad + gum[static_cast<long long>(g) * NPAT + tid];
    }

    // ---- Gumbel-argmax over the patterns; ties to the lowest index ----------
    float best = score;
    int bi = tid < NPAT ? tid : INT_MAX;
#pragma unroll
    for (int off = WARP / 2; off > 0; off >>= 1) {
      const float os = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (os > best || (os == best && oi < bi)) {
        best = os;
        bi = oi;
      }
    }
    if ((tid & (WARP - 1)) == 0) {
      red_s[tid / WARP] = best;
      red_i[tid / WARP] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      float s = red_s[0];
      int i0 = red_i[0];
      for (int w = 1; w < NWARP; ++w)
        if (red_s[w] > s || (red_s[w] == s && red_i[w] < i0)) {
          s = red_s[w];
          i0 = red_i[w];
        }
      sh_best = i0 == INT_MAX ? 0 : i0;  // all scores NaN: pattern 0
    }
    __syncthreads();

    // ---- the winner draws b = L⁻ᵀ(L⁻¹v + η), masked to its pattern ---------
    if (tid == sh_best) {
      float bn[K];
#pragma unroll
      for (int j = K - 1; j >= 0; --j) {
        float acc = z[j] + eta[r0 + j];
#pragma unroll
        for (int i = j + 1; i < K; ++i) acc = fmaf(-L[i][j], bn[i], acc);
        bn[j] = acc / L[j][j];
      }
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float v = mk[j] > 0.f ? bn[j] : 0.f;
        const float d = v - sh_b[j];
        sh_d[j] = d;
        delta[r0 + j] = d;
        b_new[r0 + j] = v;
        incl[r0 + j] = mk[j];
      }
    }
    __syncthreads();

    // ---- rank-K update of the later groups' correlation: w −= d·Cb rows ----
    for (int c = tid; c < bs; c += NT) {
      float acc = sh_w[c];
#pragma unroll
      for (int k = 0; k < K; ++k)
        acc = fmaf(-sh_d[k], Cb[static_cast<long long>(r0 + k) * bs + c], acc);
      sh_w[c] = acc;
    }
  }
}

template <int K>
int launch(const void* Cb, const void* u, const void* b, const void* s2, const void* val,
           const void* eta, const void* gum, const void* sig, const void* pi, void* delta,
           void* b_new, void* incl, long long bs, cudaStream_t stream) {
  constexpr int NT = (1 << K) < WARP ? WARP : (1 << K);
  gibbs_group_kernel<K><<<1, NT, static_cast<size_t>(bs) * sizeof(float), stream>>>(
      static_cast<const float*>(Cb), static_cast<const float*>(u),
      static_cast<const float*>(b), static_cast<const float*>(s2),
      static_cast<const float*>(val), static_cast<const float*>(eta),
      static_cast<const float*>(gum), static_cast<const float*>(sig),
      static_cast<const float*>(pi), static_cast<float*>(delta),
      static_cast<float*>(b_new), static_cast<float*>(incl), static_cast<int>(bs));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are device float32: Cb (bs, bs) row-major; u, b, s2, val, eta,
// delta, b_new, incl (bs,); gum (bs/K, 2^K); sig_e2 and pi one float each.
extern "C" int gbm_gibbs_group(const void* Cb, const void* u, const void* b, const void* s2,
                               const void* val, const void* eta, const void* gum,
                               const void* sig_e2, const void* pi, void* delta, void* b_new,
                               void* incl, long long bs, long long K, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
#define GBM_K3_CASE(k)                                                                   \
  case k:                                                                                \
    return launch<k>(Cb, u, b, s2, val, eta, gum, sig_e2, pi, delta, b_new, incl, bs, st);
  switch (K) {
    GBM_K3_CASE(1)
    GBM_K3_CASE(2)
    GBM_K3_CASE(3)
    GBM_K3_CASE(4)
    GBM_K3_CASE(5)
    GBM_K3_CASE(6)
    GBM_K3_CASE(7)
    GBM_K3_CASE(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GBM_K3_CASE
}
