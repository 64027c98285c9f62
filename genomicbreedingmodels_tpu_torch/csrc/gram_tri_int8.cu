// K1: lower-triangular raw Gram D·Dᵀ of an int8 dosage panel, exact int32.
//
// Replaces: genomicbreedingmodels_tpu/ops/pallas_kernels.py
//   `gram_tri_kernel_int8` (launched by `_grm_pallas_padded_int8`).
//
// The kernel is the Hopper mainloop of gram_tri_sm90.cuh with the s8 operand
// type: TMA ring, one producer and two consumer warpgroups, wgmma
// m64n256k32 s8·s8 -> s32, persistent 2-CTA clusters sharing each B slab by
// TMA multicast, in an L2-aware tile order. It is
// compute bound (1979 TOP/s int8); the header says why and what the design
// does about it. Exact while p·ploidy² < 2³¹; the wrapper raises otherwise.

#include "gram_tri_sm90.cuh"

extern "C" int gbm_gram_tri_int8(const void* D, void* out, long long n, long long p,
                                 void* stream) {
  return gbm_sm90::launch<gbm_sm90::OpS8>(D, out, n, p, stream);
}

extern "C" const char* gbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
