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
// What bounds it on an H100: latency. Group g+1 scores against the residual
// that group g's draw left, so the group loop is sequential, and its time is
// the length of the dependent chain per group. Neither FLOPs nor HBM bytes
// come close to a limit.
//
// Design: one launch per block (of every fold chain at once), two roles.
//  - Builder CTAs (blockIdx ≥ F) take everything that does not depend on the
//    residual off the critical path, across SMs, as the TPU kernel's first
//    phase does: one thread per (group, pattern) runs the clamped elimination
//    (max(d, 1e-30), rsqrt) and the row-wise inverse of the plain version,
//    and writes W̃ = L⁻¹ masked to γ (its K(K+1)/2 lower entries) and the
//    pattern's constant log-weight plus its Gumbel draw into the group's
//    slice of a workspace in device memory (it stays in L2). The group's
//    C_gg·b_g, the K×K block Cb[(g−1)K.., gK..] that links it to the group
//    before, b_g, η_g and the validity mask go into the same slice. Each
//    builder CTA then publishes one flag for its groups (st.release.gpu of
//    this launch's epoch, after a CTA barrier). Builders never wait, so the
//    launch cannot deadlock whatever order its CTAs are scheduled in.
//  - The scan CTA (blockIdx f < F, 8 warps). Warp 0 runs the groups in sequence:
//    lanes i < K form v_i from shared memory (w, the previous group's d
//    through the linking block, C_gg·b_g) and broadcast v by shuffles; each
//    lane scores 1 to 8 neighbouring patterns (Z = W̃v, const + ½‖Z‖², W̃
//    read by 8- or 16-byte loads); two warp reductions give every lane the
//    Gumbel-argmax (the largest order-keeping integer key of the scores, then
//    the lowest pattern that holds it, as jnp.argmax breaks ties). Up to K=6
//    every lane also draws b = W̃ᵀ(Z + η) for its own patterns while the
//    reductions run, and the winner's lane keeps its draw; at K=7-8 one lane
//    draws for the winner. The (d, b_new, incl) record goes to shared
//    memory. No block barrier sits inside that chain.
//  - Warps 1-7 of the scan CTA work off the chain: they apply the previous
//    group's d to the running correlation w = u − cdelta (in shared memory)
//    of the groups after the next one, store the previous group's record to
//    device memory, and keep a 3-deep ring of the coming groups' inputs
//    filling: while group g scores, one thread has issued bulk copies (TMA,
//    completing on an mbarrier per slot) of group g+2's table slice, once
//    warp 1 has seen its flag, and of the K Cb rows its update needs. Each
//    update thread owns fixed column quads. Where a Cb row does not start on
//    16 bytes (bs % 4 ≠ 0), each thread copies its own quads by cp.async
//    instead. Where the rows would overflow shared memory (bs beyond ~1024
//    at K=8) the first `staged` quads are staged and the update reads the
//    rest from L2, with the same arithmetic. One __syncthreads per group
//    joins the two sides.
//
// Fold axis: one launch updates block `blk` of F independent chains (the
// row-masked fold chains of cross-validation). Fold f has its own scan CTA,
// its own builders, its own slice of the workspace (G table slices and one
// flag per builder) and its own σ²ₑ and π; `val` is shared. The grid is
// [F scan CTAs | builders chunk-major: chunk c of fold f at F + c·F + f], so
// the first builder wave covers the first groups of every fold; F = 1 runs
// the single-chain kernel, the launch as it was. Progress: only a scan CTA
// ever waits, and only on builders of its own fold, which never wait. So the
// launch progresses as long as one CTA slot is left to builders whatever
// order the hardware dispatches in, and the wrapper caps F per launch at half
// the SM count (one CTA per SM is the worst case of this kernel's shared
// memory) and splits larger F into several launches. That bound assumes the
// launch shares the card with no other launch of this kernel and no other
// tenant's CTAs that hold SMs while it runs: the port issues K3 on one stream
// (host threads share the current stream), so its launches run one after
// another. Two fold launches on two streams, or a co-resident tenant, could
// fill every slot with waiting scans; a scan then traps after
// WAIT_TRAP_CYCLES and the launch fails instead of hanging.
//
// Reused workspace and stale flags: the wrapper passes an epoch that it
// increments per launch, so a flag left by an earlier launch never reads as
// ready. Warp 1 polls 32 builder CTAs' flags at once and fences (acquire)
// once per poll; fence.proxy.async then orders the builders' generic
// writes before the TMA reads. A flag poll or mbarrier wait that lasts 2³²
// cycles (~2 s) traps: a fault fails the launch instead of holding the card.
// Noise (η, Gumbel) is drawn by the caller; σ²ₑ and π are read from device
// memory, so a block step never syncs the host.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <math_constants.h>

namespace {

constexpr int WARP = 32;
constexpr int NT = 256;         // threads of every CTA
constexpr int NU = NT - WARP;   // update/copy threads of the scan CTA (warps 1-7)
constexpr int STAGES = 3;       // table/row ring: group g+2 lands while g scores
constexpr long long WAIT_TRAP_CYCLES = 1LL << 32;
constexpr unsigned FULL = 0xffffffffu;

// One group's table slice, in floats (the wrapper's `k3_layout` mirrors it).
template <int K>
struct Slice {
  static constexpr int NPAT = 1 << K;
  static constexpr int KT = K * (K + 1) / 2;
  static constexpr int W = 0;                 // (KT, NPAT): W̃[i][j] of pattern p at (i(i+1)/2 + j)·NPAT + p
  static constexpr int CST = KT * NPAT;       // (NPAT,) constant log-weight + Gumbel
  static constexpr int CB = CST + NPAT;       // (K,) C_gg·b_g
  static constexpr int LINK = CB + K;         // (K, K) Cb[(g−1)K + k, gK + i] at k·K + i; 0 for g = 0
  static constexpr int B = LINK + K * K;      // (K,) b_g
  static constexpr int ETA = B + K;           // (K,) η_g
  static constexpr int VAL = ETA + K;         // (K,) validity; the stride rounds VAL + K up to 4 floats
};

__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// N consecutive floats of shared memory (N = 1, 2, 4 or 8, `p` aligned to
// min(N, 4) floats) in as few loads as the width allows.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&out)[N]) {
  if constexpr (N == 1) {
    out[0] = p[0];
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
#pragma unroll
    for (int h = 0; h < N / 4; ++h) {
      const float4 x = reinterpret_cast<const float4*>(p)[h];
      out[4 * h] = x.x, out[4 * h + 1] = x.y, out[4 * h + 2] = x.z, out[4 * h + 3] = x.w;
    }
  }
}

// An unsigned key in the order of the float: larger score, larger key.
__device__ __forceinline__ unsigned score_key(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity`; trap after ~2 s (a broken pipeline).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > WAIT_TRAP_CYCLES) __trap();
  }
}

// A 1-D bulk copy (TMA) of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Called by a whole warp with the same s: lane l reads the flag of builder
// CTA s/gpc + l, and the warp learns how many CTAs from there on have
// published this launch's `epoch`. It spins until the first has (and traps
// after ~2 s), then an acquire fence and a warp barrier order every lane's
// later reads of those groups' tables after the builders' releases. Returns
// the last group known ready. One poll covers up to 32 builder CTAs.
__device__ int wait_ready(const int* flags, int s, int gpc, int builders, int epoch) {
  const int c0 = s / gpc;
  const int q = c0 + (threadIdx.x & (WARP - 1));
  const long long t0 = clock64();
  while (true) {
    const bool ok = q >= builders || ld_relaxed(flags + q) == epoch;
    const unsigned pending = __ballot_sync(FULL, !ok);
    const int n = pending ? __ffs(pending) - 1 : WARP;
    if (n > 0) {
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
      __syncwarp();
      return (c0 + n) * gpc - 1;
    }
    if (clock64() - t0 > WAIT_TRAP_CYCLES) __trap();
  }
}

struct Args {
  const float* Cb;
  const float* u;
  const float* b;
  const float* s2;
  const float* val;
  const float* eta;
  const float* gum;
  const float* sig_e2;
  const float* pi;
  float* delta;
  float* b_new;
  float* incl;
  float* tables;  // (G, slice) workspace
  int* flags;     // (≥ builder CTAs,) workspace
  int bs, epoch, slice, staged;
};

// A fold-batched launch: fold 0's Args, the fold count, and the fold strides
// in floats of the per-fold inputs (rows of length bs, or Cb's (bs, bs) and
// gum's (G, 2^K), contiguous within a fold). The outputs are (F, bs)
// contiguous, sig_e2 and pi (F,), the workspace F slices of tables and F
// runs of builder flags.
struct FoldArgs {
  Args a;
  int folds;
  long long cb_fs, u_fs, b_fs, s2_fs, eta_fs, gum_fs;
};

// Fold f's view of the launch: its inputs, outputs and workspace slices.
template <int K>
__device__ __forceinline__ Args fold_args(const FoldArgs& fa, int f, int builders) {
  const Args& a = fa.a;
  Args o = a;
  const long long G = a.bs / K;
  o.Cb += f * fa.cb_fs;
  o.u += f * fa.u_fs;
  o.b += f * fa.b_fs;
  o.s2 += f * fa.s2_fs;
  o.eta += f * fa.eta_fs;
  o.gum += f * fa.gum_fs;
  o.sig_e2 += f;
  o.pi += f;
  o.delta += f * static_cast<long long>(a.bs);
  o.b_new += f * static_cast<long long>(a.bs);
  o.incl += f * static_cast<long long>(a.bs);
  o.tables += f * G * a.slice;
  o.flags += f * builders;
  return o;
}

// ---- builders: one thread per (group, pattern) ---------------------------------

template <int K>
__device__ void build_tables(const Args& a, int chunk) {
  using S = Slice<K>;
  constexpr int NPAT = S::NPAT;
  constexpr int GPC = NPAT >= NT ? 1 : NT / NPAT;  // groups per builder CTA
  const int G = a.bs / K;
  const int tid = threadIdx.x;
  const int g = chunk * GPC + tid / NPAT;
  const int p = tid % NPAT;
  if (g < G) {
    const int bs = a.bs, r0 = g * K;
    float* T = a.tables + static_cast<long long>(g) * a.slice;
    const float sig = *a.sig_e2, pi = *a.pi;
    const float log_pi = logf(pi);
    const float log_1mpi = log1pf(-fminf(pi, 1.f - 1e-7f));
    if (p < K) {  // the group's residual-independent scan inputs; NPAT ≥ K
      const long long row = static_cast<long long>(r0 + p) * bs;
      float cb = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) cb = fmaf(a.Cb[row + r0 + j], a.b[r0 + j], cb);
      T[S::CB + p] = cb;
#pragma unroll
      for (int k = 0; k < K; ++k)
        T[S::LINK + k * K + p] = g > 0 ? a.Cb[static_cast<long long>(r0 - K + k) * bs + r0 + p] : 0.f;
      T[S::B + p] = a.b[r0 + p];
      T[S::ETA + p] = a.eta[r0 + p];
      T[S::VAL + p] = a.val[r0 + p];
    }
    float m[K];
    float npos = 0.f, nneg = 0.f, nbad = 0.f, logs2 = 0.f;
    float L[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float bit = static_cast<float>((p >> i) & 1);
      const float vi = a.val[r0 + i], s2i = a.s2[r0 + i];
      m[i] = bit * vi;
      npos += m[i];
      nneg += vi * (1.f - bit);
      nbad += bit * (1.f - vi);
      if (m[i] > 0.f) logs2 += logf(s2i);
#pragma unroll
      for (int j = 0; j <= i; ++j)
        L[i][j] = (a.Cb[static_cast<long long>(r0 + i) * bs + r0 + j] / sig) * (m[i] * m[j]);
      L[i][i] += m[i] > 0.f ? 1.f / fmaxf(s2i, 1e-12f) : 1.f;
    }
    // Clamped Cholesky, column by column, in place (the plain version's order).
    float half_logdet = 0.f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float dj = fmaxf(L[j][j], 1e-30f);
      half_logdet += 0.5f * logf(dj);
      const float r = rsqrtf(dj);
#pragma unroll
      for (int i = j; i < K; ++i) L[i][j] *= r;
#pragma unroll
      for (int k = j + 1; k < K; ++k)
#pragma unroll
        for (int i = k; i < K; ++i) L[i][k] = fmaf(-L[i][j], L[k][j], L[i][k]);
    }
    // W = L⁻¹ row by row, masked to the pattern; lower entries only.
    float W[K][K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const float inv = 1.f / L[i][i];
#pragma unroll
      for (int j = 0; j < i; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int k = j; k < i; ++k) acc = fmaf(L[i][k], W[k][j], acc);
        W[i][j] = -acc * inv;
      }
      W[i][i] = inv;
    }
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) T[S::W + tri(i, j) * NPAT + p] = W[i][j] * (m[i] * m[j]);
    const float cst = npos * log_pi + nneg * log_1mpi - 0.5f * logs2 - half_logdet - 1e30f * nbad;
    T[S::CST + p] = cst + a.gum[static_cast<long long>(g) * NPAT + p];
  }
  __syncthreads();  // every thread's table writes, then one release for the CTA's groups
  if (tid == 0) st_release(a.flags + chunk, a.epoch);
}

// ---- the scan CTA ---------------------------------------------------------------

// Output value t of group g (t < 3K: d, b_new, incl by K) from its smem record.
template <int K>
__device__ __forceinline__ void put_output(const Args& a, const float* obuf, int g, int t) {
  const float x = obuf[(g & 1) * 3 * K + t];
  const int r = g * K + t % K;
  float* out = t < K ? a.delta : t < 2 * K ? a.b_new : a.incl;
  out[r] = x;
}

template <int K>
__device__ void scan(const Args& a) {
  using S = Slice<K>;
  constexpr int NPAT = S::NPAT;
  constexpr int PPL = NPAT > WARP ? NPAT / WARP : 1;  // patterns per lane
  constexpr int D = STAGES - 1;                       // prefetch distance
  constexpr int GPC = NPAT >= NT ? 1 : NT / NPAT;     // groups per builder CTA
  const int bs = a.bs, slice = a.slice, staged = a.staged;
  const int G = bs / K, quads = (bs + 3) / 4;
  extern __shared__ __align__(16) float smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);  // STAGES mbarriers: item landed
  float* ring = smem + 8;                             // STAGES × slice
  float4* rows = reinterpret_cast<float4*>(ring + STAGES * slice);  // STAGES × (K, staged)
  float* w = reinterpret_cast<float*>(rows + STAGES * K * staged);  // (4·quads,) u − cdelta
  float* obuf = w + 4 * quads;  // 2 × (3, K): (d, b_new, incl) of the last two groups
  const int tid = threadIdx.x;
  const int ut = tid - WARP;  // update thread: owns column quads ut, ut + NU, ...
  // Bulk copies and 16-byte loads of Cb where its rows start on 16 bytes.
  const bool vec = bs % 4 == 0 && reinterpret_cast<uintptr_t>(a.Cb) % 16 == 0;
  for (int c = tid; c < bs; c += NT) w[c] = a.u[c];
  if (tid < 6 * K) obuf[tid] = 0.f;
  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(full + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Item s of the ring: group s's table slice and group s−1's Cb rows (their
  // staged quads). Thread 0 of warp 1 issues one bulk copy (TMA) of the
  // slice, once warp 1 has seen the slice's flag, and where the rows start
  // on 16 bytes one per row; the item lands on mbarrier full[s % STAGES].
  // Otherwise each update thread copies its own quads of the rows by
  // cp.async, one commit group per item.
  int ready = -1;  // warp 1: the last group seen ready
  auto issue = [&](int s) {
    if (s < G) {
      const int slot = s % STAGES;
      float4* rdst = rows + slot * K * staged;
      const float* rsrc = a.Cb + static_cast<long long>(s - 1) * K * bs;
      if (tid < 2 * WARP) {
        if (s > ready) ready = wait_ready(a.flags, s, GPC, (G + GPC - 1) / GPC, a.epoch);
        if (tid == WARP) {
          // The builders wrote the slice through the generic proxy; TMA reads
          // through the async proxy.
          asm volatile("fence.proxy.async.global;" ::: "memory");
          const bool rows_too = vec && s >= 1 && staged > 0;
          mbar_expect_tx(full + slot, 4u * slice + (rows_too ? 16u * K * staged : 0u));
          bulk_copy(ring + slot * slice, a.tables + static_cast<long long>(s) * slice, 4u * slice,
                    full + slot);
          if (rows_too)
            for (int k = 0; k < K; ++k)
              bulk_copy(rdst + k * staged, rsrc + static_cast<long long>(k) * bs, 16u * staged, full + slot);
        }
      }
      if (!vec && s >= 1) {
        for (int qi = ut; qi < staged; qi += NU) {
          const int c = 4 * qi;
          if (c + 4 <= (s + 1) * K) continue;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float* d4 = reinterpret_cast<float*>(rdst + k * staged + qi);
            const float* s4 = rsrc + static_cast<long long>(k) * bs + c;
            for (int e = 0; e < 4 && c + e < bs; ++e) cp_async4(d4 + e, s4 + e);
          }
        }
      }
    }
    cp_async_commit();  // one group per item, empty or not: the wait count stays fixed
  };
  // Item s has landed: its mbarrier's phase, and this thread's cp.async group.
  auto landed = [&](int s) {
    cp_async_wait<D - 1>();
    if (s < G) mbar_wait(full + s % STAGES, (s / STAGES) & 1);
  };

  if (tid >= WARP) {
    for (int s = 0; s < D; ++s) issue(s);
    landed(0);
  }
  __syncthreads();
  const float inv_sig = 1.f / *a.sig_e2;
  const int lane = tid;

  for (int g = 0; g < G; ++g) {
    const float* T = ring + (g % STAGES) * slice;
    if (tid >= WARP) {
      // ---- off the critical path: the ring, and d_{g−1} into groups ≥ g+1 ----
      issue(g + D);
      if (g >= 1) {
        float d[K];
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = obuf[((g - 1) & 1) * 3 * K + k];
        if (ut < 3 * K) put_output<K>(a, obuf, g - 1, ut);
        const float4* R = rows + (g % STAGES) * K * staged;
        const float* rsrc = a.Cb + static_cast<long long>(g - 1) * K * bs;
        const int lo = (g + 1) * K;
        for (int qi = ut; qi < quads; qi += NU) {
          const int c = 4 * qi;
          if (c + 4 <= lo) continue;
          const float4 old = *reinterpret_cast<const float4*>(w + c);
          float4 acc = old;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            float4 r;
            if (qi < staged) {
              r = R[k * staged + qi];
            } else {  // beyond the staged quads: straight from L2
              const float* s4 = rsrc + static_cast<long long>(k) * bs + c;
              if (vec) {
                r = __ldg(reinterpret_cast<const float4*>(s4));
              } else {
                r.x = __ldg(s4);
                r.y = c + 1 < bs ? __ldg(s4 + 1) : 0.f;
                r.z = c + 2 < bs ? __ldg(s4 + 2) : 0.f;
                r.w = c + 3 < bs ? __ldg(s4 + 3) : 0.f;
              }
            }
            acc.x = fmaf(-d[k], r.x, acc.x);
            acc.y = fmaf(-d[k], r.y, acc.y);
            acc.z = fmaf(-d[k], r.z, acc.z);
            acc.w = fmaf(-d[k], r.w, acc.w);
          }
          // Columns below lo belong to groups ≤ g: they keep their value.
          *reinterpret_cast<float4*>(w + c) =
              make_float4(c >= lo ? acc.x : old.x, c + 1 >= lo ? acc.y : old.y,
                          c + 2 >= lo ? acc.z : old.z, c + 3 >= lo ? acc.w : old.w);
        }
      }
      landed(g + 1);
    } else {
      // ---- the critical path: warp 0 ----
      float vi = 0.f;
      if (lane < K) {
        const float* dprev = obuf + ((g + 1) & 1) * 3 * K;  // d_{g−1} (zeros at g = 0)
        float acc = w[g * K + lane];
#pragma unroll
        for (int k = 0; k < K; ++k) acc = fmaf(-dprev[k], T[S::LINK + k * K + lane], acc);
        vi = (acc + T[S::CB + lane]) * inv_sig;
      }
      float v[K];
#pragma unroll
      for (int i = 0; i < K; ++i) v[i] = __shfl_sync(FULL, vi, i);
      float best = -CUDART_INF_F;
      int bi = INT_MAX;
      // Up to K = 6 (two patterns a lane) each lane also draws its patterns'
      // b = W̃ᵀ(Z + η) while the argmax runs, from W̃ and Z in its registers.
      constexpr bool SPECULATE = PPL <= 2;
      float bc[SPECULATE ? K : 1][PPL];
      if (lane * PPL < NPAT) {  // lane l holds patterns l·PPL .. l·PPL + PPL − 1
        float quad[PPL];
        float zz[SPECULATE ? K : 1][PPL];
#pragma unroll
        for (int q = 0; q < PPL; ++q) quad[q] = 0.f;
#pragma unroll
        for (int i = 0; i < K; ++i) {
          float z[PPL];
#pragma unroll
          for (int q = 0; q < PPL; ++q) z[q] = 0.f;
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            float wv[PPL];
            load_vec<PPL>(T + S::W + tri(i, j) * NPAT + lane * PPL, wv);
#pragma unroll
            for (int q = 0; q < PPL; ++q) z[q] = fmaf(wv[q], v[j], z[q]);
          }
#pragma unroll
          for (int q = 0; q < PPL; ++q) {
            quad[q] = fmaf(z[q], z[q], quad[q]);
            if constexpr (SPECULATE) zz[i][q] = z[q] + T[S::ETA + i];
          }
        }
        float cst[PPL];
        load_vec<PPL>(T + S::CST + lane * PPL, cst);
#pragma unroll
        for (int q = 0; q < PPL; ++q) {
          const float score = cst[q] + 0.5f * quad[q];
          if (score > best) {  // ascending patterns: ties keep the lowest
            best = score;
            bi = lane * PPL + q;
          }
        }
        if constexpr (SPECULATE) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
#pragma unroll
            for (int q = 0; q < PPL; ++q) bc[j][q] = 0.f;
#pragma unroll
            for (int i = j; i < K; ++i) {
              float wv[PPL];
              load_vec<PPL>(T + S::W + tri(i, j) * NPAT + lane * PPL, wv);
#pragma unroll
              for (int q = 0; q < PPL; ++q) bc[j][q] = fmaf(wv[q], zz[i][q], bc[j][q]);
            }
          }
        }
      }
      // The group's old effects and validity, read before the argmax.
      float bold[K], valk[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        bold[j] = T[S::B + j];
        valk[j] = T[S::VAL + j];
        asm volatile("" : "+f"(bold[j]), "+f"(valk[j]));
      }
      // Gumbel-argmax across the lanes: the largest score by an order-keeping
      // integer key, then the lowest pattern that holds it; two reductions.
      const unsigned key = score_key(best);
      const unsigned top = __reduce_max_sync(FULL, key);
      const int bw = __reduce_min_sync(FULL, key == top ? bi : INT_MAX);
      const int win = bw == INT_MAX ? 0 : bw;  // all scores NaN: pattern 0
      float bsel[K];
      int writer;
      if constexpr (SPECULATE) {
        writer = win / PPL;  // the lane that holds the winner has drawn it
        if (lane == writer) {
#pragma unroll
          for (int j = 0; j < K; ++j) bsel[j] = (PPL == 1 || win % PPL == 0) ? bc[j][0] : bc[j][PPL - 1];
        }
      } else {
        // One lane draws for the winning pattern: no lane waits on another,
        // and the column reads of W̃ meet no bank conflict.
        writer = 0;
        if (lane == 0) {
          float z[K];
#pragma unroll
          for (int i = 0; i < K; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j <= i; ++j) acc = fmaf(T[S::W + tri(i, j) * NPAT + win], v[j], acc);
            z[i] = acc + T[S::ETA + i];
          }
#pragma unroll
          for (int j = 0; j < K; ++j) {
            bsel[j] = 0.f;
#pragma unroll
            for (int i = j; i < K; ++i) bsel[j] = fmaf(T[S::W + tri(i, j) * NPAT + win], z[i], bsel[j]);
          }
        }
      }
      if (lane == writer) {  // the update warps store them to device memory next iteration
        float* o = obuf + (g & 1) * 3 * K;
#pragma unroll
        for (int j = 0; j < K; ++j) {
          o[j] = bsel[j] - bold[j];
          o[K + j] = bsel[j];
          o[2 * K + j] = ((win >> j) & 1) ? valk[j] : 0.f;
        }
      }
    }
    __syncthreads();
  }
  if (ut >= 0 && ut < 3 * K) put_output<K>(a, obuf, G - 1, ut);
}

// The single-chain kernel, with the Args of the launch before the fold axis:
// its code is that launch's. A scan on a fold's copy of its arguments
// (pointers in registers) ran 7 % slower at F = 1, one kernel holding both
// scans 27 %, and this kernel with the fold fields in its Args 3.7 % at
// bs = 600; hence a kernel of its own.
template <int K>
__global__ void __launch_bounds__(NT, 1) gibbs_group_kernel(const Args a) {
  if (blockIdx.x == 0)
    scan<K>(a);
  else
    build_tables<K>(a, blockIdx.x - 1);
}

// F folds: F scan CTAs, then the builders chunk-major.
template <int K>
__global__ void __launch_bounds__(NT, 1) gibbs_group_fold_kernel(const FoldArgs fa) {
  constexpr int NPAT = 1 << K;
  constexpr int GPC = NPAT >= NT ? 1 : NT / NPAT;
  const int builders = (fa.a.bs / K + GPC - 1) / GPC;
  const int F = fa.folds;
  const int i = blockIdx.x;
  if (i < F) {
    scan<K>(fold_args<K>(fa, i, builders));
  } else {
    const int j = i - F;  // chunk-major: chunk j / F of fold j % F
    build_tables<K>(fold_args<K>(fa, j % F, builders), j / F);
  }
}

constexpr int MAX_DEVICES = 64;

// The chain launches once per block from the host: raise `kernel`'s
// shared-memory limit only when a launch needs more than this device's last
// setting (`smem_set`, one record per kernel instance), not on every launch.
template <typename P>
int launch_kernel(void (*kernel)(P), const P& params, size_t smem, int grid, int* smem_set,
                  cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES || static_cast<int>(smem) > smem_set[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < MAX_DEVICES) smem_set[dev] = static_cast<int>(smem);
  }
  kernel<<<grid, NT, smem, stream>>>(params);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const FoldArgs& fa, cudaStream_t stream) {
  constexpr int NPAT = 1 << K;
  constexpr int GPC = NPAT >= NT ? 1 : NT / NPAT;
  const Args& a = fa.a;
  const int G = a.bs / K;
  const int builders = (G + GPC - 1) / GPC;
  const size_t smem = sizeof(float) * (8 + static_cast<size_t>(STAGES) * a.slice + 4 * ((a.bs + 3) / 4) + 6 * K) +
                      sizeof(float4) * static_cast<size_t>(STAGES) * K * a.staged;
  static int single_set[MAX_DEVICES], fold_set[MAX_DEVICES];
  if (fa.folds == 1) return launch_kernel(gibbs_group_kernel<K>, a, smem, 1 + builders, single_set, stream);
  return launch_kernel(gibbs_group_fold_kernel<K>, fa, smem, fa.folds * (1 + builders), fold_set,
                       stream);
}

}  // namespace

// All pointers are device memory, for F = `folds` chains: Cb (F, bs, bs) row-major
// float32; u, b, s2, eta (F, bs) and gum (F, bs/K, 2^K) float32, each fold at its
// fold stride (`*_fs`, floats; rows contiguous); val (bs,) shared; sig_e2 and pi
// (F,); delta, b_new, incl (F, bs) contiguous outputs; tables (F, bs/K, slice)
// float32 and flags (F, builder CTAs) int32, the workspace. `epoch` differs from
// every flag value an earlier launch left; `slice` (floats per group, a multiple
// of 4) and `staged` (column quads of Cb staged in shared memory) come from the
// wrapper's layout.
extern "C" int gbm_gibbs_group(const void* Cb, const void* u, const void* b, const void* s2,
                               const void* val, const void* eta, const void* gum,
                               const void* sig_e2, const void* pi, void* delta, void* b_new,
                               void* incl, long long bs, long long K, void* tables, void* flags,
                               long long epoch, long long slice, long long staged, long long folds,
                               long long cb_fs, long long u_fs, long long b_fs, long long s2_fs,
                               long long eta_fs, long long gum_fs, void* stream) {
  const Args a{static_cast<const float*>(Cb), static_cast<const float*>(u),
               static_cast<const float*>(b), static_cast<const float*>(s2),
               static_cast<const float*>(val), static_cast<const float*>(eta),
               static_cast<const float*>(gum), static_cast<const float*>(sig_e2),
               static_cast<const float*>(pi), static_cast<float*>(delta),
               static_cast<float*>(b_new), static_cast<float*>(incl),
               static_cast<float*>(tables), static_cast<int*>(flags), static_cast<int>(bs),
               static_cast<int>(epoch), static_cast<int>(slice), static_cast<int>(staged)};
  const FoldArgs fa{a, static_cast<int>(folds), cb_fs, u_fs, b_fs, s2_fs, eta_fs, gum_fs};
  if (folds < 1) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define GBM_K3_CASE(k) \
  case k:              \
    return launch<k>(fa, st);
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
