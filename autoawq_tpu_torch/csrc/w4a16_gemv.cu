// K1: W4A16 GEMV / small-M GEMM, y = x @ dequant(qweight, scales, qzeros).
//
// Replaces autoawq_tpu/ops/pallas_gemm.py::_kernel (called from
// awq_matmul_pallas), which the TPU runs for every int4 linear with M < 256.
//
// Bound on the H100: bytes. Below M ~ 150 the int4 weight stream over 3.35
// TB/s is the least time (2M flops per 0.5 byte read, under the card's
// ~295 flops/byte balance point).
//
// Design (w4a16_gemv.cuh): the weight is the A operand of mma.sync
// m16n8k16 and the rows of x its n8 tiles (y^T = W^T x^T), so each weight
// word is read once per call for all M rows (up to 256 in a CTA); each
// warp streams its weight words and x through its own cp.async ring (x
// via L1, shared by the warps of a row group), turns nibbles into exact
// bf16 (q - z) pairs with a lop3 and a bf16x2 subtraction, and scales each
// group's f32 sum once. The CTA's warps split K; where the CTAs alone
// leave SMs idle, a cluster of CTAs splits K further and reduces through
// distributed shared memory, in a fixed order, in the same launch. The
// wrapper (ops/gemm.gemv_plan) chooses the n8 tiles a warp holds (nt),
// the row groups of a CTA (rg) and the cluster (csize); M above 256 runs
// in row chunks of 256 (grid.y), each reading the weight again.
#include "w4a16_gemv.cuh"

// N % 4 == 0, group_size % 32 == 0 and 16-byte aligned operands (checked
// by the wrapper; refused here too). The CTA's shape (ops/gemm.gemv_plan):
// nt n8 tiles a warp (1, 2 or 4: rows up to 8, 16, 32 a warp) and rg row
// groups of 32 (1, 2, 4 or 8); its columns: 32 for nt < 4, else 128 /
// 32 / 64 / 32 for rg = 1 / 2 / 4 / 8; csize CTAs a cluster (1, 2, 4 or
// 8) split K.
extern "C" int w4a16_gemv(const void* x, const void* qw, const void* sc,
                          const void* qz, void* out, int M, int K, int N,
                          int group_size, int nt, int rg, int csize,
                          void* stream) {
  if (M < 1 || N % 4 != 0 || group_size % 32 != 0 || K % group_size != 0 ||
      !awq::gv::plan_ok(nt, rg, csize, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const awq::gv::DenseJob job{static_cast<const __nv_bfloat16*>(x),
                              static_cast<const int32_t*>(qw),
                              static_cast<const float*>(sc),
                              static_cast<const int32_t*>(qz),
                              static_cast<__nv_bfloat16*>(out),
                              M,
                              K,
                              N,
                              group_size,
                              csize};
  return static_cast<int>(awq::gv::launch_plan<true>(
      job, nt, rg, static_cast<cudaStream_t>(stream)));
}
