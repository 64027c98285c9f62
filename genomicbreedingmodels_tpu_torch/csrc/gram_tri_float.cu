// K2: lower-triangular raw Gram X·Xᵀ of an f32 or bf16 panel, f32 accumulation.
//
// Replaces: genomicbreedingmodels_tpu/ops/pallas_kernels.py `gram_tri_kernel`
//   (launched by `_grm_pallas_padded`): the triangular tile walk of K1 for
//   continuous / imputed allele frequencies that are not on the dosage grid.
//
// The kernel is the Hopper mainloop of gram_tri_sm90.cuh: bf16 panels through
// wgmma m64n128k16 bf16 -> f32 (989 TFLOP/s), f32 panels as 3xTF32 through
// wgmma m64n128k8 tf32 (hi·hi + hi·lo + lo·hi, hi rounded to TF32 in shared
// memory). They fold a partial sum every 256 (f32) or 1024 (bf16) markers to
// hold 1e-5·max|G| against a float64 product; the header gives the numbers.

#include "gram_tri_sm90.cuh"

extern "C" int gbm_gram_tri_f32(const void* X, void* out, long long n, long long p,
                                void* stream) {
  return gbm_sm90::launch<gbm_sm90::OpTF32>(X, out, n, p, stream);
}

extern "C" int gbm_gram_tri_bf16(const void* X, void* out, long long n, long long p,
                                 void* stream) {
  return gbm_sm90::launch_bf16(X, out, n, p, stream);
}

// The same in the schedule named (quad != 0: 2x2 clusters, else one CTA per
// tile) whatever the shape rule picks: to hold or time one against the other.
extern "C" int gbm_gram_tri_bf16_schedule(const void* X, void* out, long long n, long long p, int quad,
                                          void* stream) {
  return quad ? gbm_sm90::launch<gbm_sm90::OpBF16Quad>(X, out, n, p, stream)
              : gbm_sm90::launch<gbm_sm90::OpBF16>(X, out, n, p, stream);
}
