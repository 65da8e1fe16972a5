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

namespace {

struct Args {
  const __nv_bfloat16* x;
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
  __nv_bfloat16* out;
  int M, K, N, gs, csize;
};

// grid.x: column tiles x csize (clusters along x); grid.y: row chunks of
// 32 RG rows (one unless M > 256)
template <int NT, int CS, int RG, int MIN_CTAS>
__global__ void __launch_bounds__(awq::gv::THREADS, MIN_CTAS)
gemv_kernel(Args a) {
  using L = awq::gv::Shape<NT, CS, RG>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int rank = blockIdx.x % a.csize;
  const int n0 = (blockIdx.x / a.csize) * L::COLS;
  const int m0 = blockIdx.y * L::ROWS;
  awq::gv::gemv_block<NT, CS, RG>(
      a.x + (size_t)m0 * a.K, min(L::ROWS, a.M - m0), a.qw, a.sc, a.qz,
      a.out + (size_t)m0 * a.N, a.K, a.N, a.gs, n0, rank, a.csize, smem);
}

template <int NT, int CS, int RG, int MIN_CTAS>
cudaError_t launch(Args a, cudaStream_t st) {
  using L = awq::gv::Shape<NT, CS, RG>;
  static bool ready = false;
  auto* kernel = gemv_kernel<NT, CS, RG, MIN_CTAS>;
  cudaError_t err = awq::gv::allow_smem(kernel, L::SMEM, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(((a.N + L::COLS - 1) / L::COLS) * a.csize,
                  (a.M + L::ROWS - 1) / L::ROWS);
  return awq::gv::launch_clustered(kernel, grid, a.csize, L::SMEM, a, st);
}

}  // namespace

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
  const bool ok_shape = (rg == 1 && (nt == 1 || nt == 2 || nt == 4)) ||
                        ((rg == 2 || rg == 4 || rg == 8) && nt == 4);
  if (M < 1 || N % 4 != 0 || group_size % 32 != 0 || K % group_size != 0 ||
      !ok_shape || (csize != 1 && csize != 2 && csize != 4 && csize != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const int32_t*>(qw),
               static_cast<const float*>(sc),
               static_cast<const int32_t*>(qz),
               static_cast<__nv_bfloat16*>(out), M, K, N, group_size, csize};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rg == 1)
    err = nt == 1   ? launch<1, 1, 1, 3>(a, st)
          : nt == 2 ? launch<2, 1, 1, 2>(a, st)
                    : launch<4, 4, 1, 2>(a, st);
  else
    err = rg == 2   ? launch<4, 1, 2, 2>(a, st)
          : rg == 4 ? launch<4, 2, 4, 2>(a, st)
                    : launch<4, 1, 8, 2>(a, st);
  return static_cast<int>(err);
}
