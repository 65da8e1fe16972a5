// K2: W4A16 GEMM for M >= 256 (prefill), y = x @ dequant(qweight).
//
// Replaces autoawq_tpu/ops/pallas_gemm.py::_kernel_ws (called from _ws_matmul),
// the TPU's weights-stationary mode for M >= WS_MIN_M.
//
// Bound on the H100: operations once M is in the hundreds (2*M*N*K flops on
// 0.5*N*K weight bytes passes the ~295 flops/byte balance point near
// M = 150); the tensor cores are the limit.
//
// Design (simple first; wgmma and TMA are later work): a 128x128 output
// tile per block of 8 warps, the tile body of w4a16_tile.cuh (the weight
// tile dequantized once into shared memory as bf16, mma.sync.m16n8k16 with
// f32 accumulators; single-buffered, so the time follows the K loop).
// Ragged M and N are masked on load (zeros) and on store.
#include "w4a16_tile.cuh"

namespace {

__global__ void __launch_bounds__(256)
w4a16_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ qw,
                  const float* __restrict__ sc,
                  const int32_t* __restrict__ qz,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N,
                  int group_size) {
  const int m0 = blockIdx.y * 128;
  awq::gemm_tile<4>(x + (size_t)m0 * K, min(128, M - m0), qw, sc, qz,
                    out + (size_t)m0 * N, K, N, blockIdx.x * awq::TILE_N,
                    group_size);
}

}  // namespace

extern "C" int w4a16_gemm(const void* x, const void* qw, const void* sc,
                          const void* qz, void* out, int M, int K, int N,
                          int group_size, void* stream) {
  dim3 grid((N + awq::TILE_N - 1) / awq::TILE_N, (M + 127) / 128);
  w4a16_gemm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(sc), static_cast<const int32_t*>(qz),
      static_cast<__nv_bfloat16*>(out), M, K, N, group_size);
  return static_cast<int>(cudaGetLastError());
}
