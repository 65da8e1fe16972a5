// K2: W4A16 GEMM for M >= 256 (prefill), y = x @ dequant(qweight).
//
// Replaces autoawq_tpu/ops/pallas_gemm.py::_kernel_ws (called from _ws_matmul),
// the TPU's weights-stationary mode for M >= WS_MIN_M: each weight
// superblock dequantized once and reused for every M tile.
//
// Bound on the H100: operations once M is in the hundreds (2*M*N*K flops on
// 0.5*N*K weight bytes passes the ~295 flops/byte balance point near
// M = 150); at the main path's shapes the tensor cores are the limit.
//
// Design (w4a16_wgmma.cuh): the Hopper form of "dequantize once, reuse
// across M". A 227 KB shared memory cannot hold a K x 128 bf16 weight slab,
// so each block takes 128 weight columns by 256 rows of x (128 where
// 256-row tiles would leave SMs idle) and walks K 64 deep: a producer
// warpgroup keeps a 4-stage TMA ring of x tiles and PACKED weight tiles (a quarter
// of bf16's bytes) in flight, and two consumer warpgroups compute the
// tile's transpose with wgmma m64nTOKk16 whose A operand is the
// dequantized weight in registers (each value dequantized once per block,
// for all its rows), double-buffered so the next step's dequant runs while
// this step's wgmmas do. Blocks are rastered in groups of 16 row tiles, so
// a weight tile is read from memory about once per group. The tensor maps
// are encoded per call on the host (the driver's cuTensorMapEncodeTiled,
// reached through the runtime). K6's prefill instance (moe_gemm.cu) runs
// the same body with an expert's offsets.
#include "w4a16_wgmma.cuh"

namespace {

template <int TOK>
__global__ void __launch_bounds__(awq::wg::THREADS, 1)
w4a16_gemm_kernel(awq::wg::Params p, const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw,
                  const __grid_constant__ CUtensorMap ts,
                  const __grid_constant__ CUtensorMap tz) {
  using namespace awq::wg;
  extern __shared__ uint8_t smem[];
  int mi, ni;
  tile_of(blockIdx.x, (p.M + TOK - 1) / TOK, (p.N + BN - 1) / BN, mi, ni);
  const Tile tile{mi * TOK, p.M, ni * BN, 0, 0, 0};
  gemm_block<TOK>(p, &tx, &tw, &ts, &tz, smem, tile);
}

template <int TOK>
int launch(const void* x, const void* qw, const void* sc, const void* qz,
           const awq::wg::Params& p, cudaStream_t stream) {
  using namespace awq::wg;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        w4a16_gemm_kernel<TOK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<TOK>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int G = p.K / p.gs;
  CUtensorMap tx, tw, ts, tz;
  if (!maps(TOK, x, p.M, p.K, qw, p.K / 8, sc, G, qz, (G + 7) / 8, p.N, &tx,
            &tw, &ts, &tz))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = ((p.M + TOK - 1) / TOK) * ((p.N + BN - 1) / BN);
  w4a16_gemm_kernel<TOK><<<blocks, THREADS, Layout<TOK>::SMEM, stream>>>(
      p, tx, tw, ts, tz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// N must be a multiple of 4 and every pointer 16-byte aligned (TMA).
extern "C" int w4a16_gemm(const void* x, const void* qw, const void* sc,
                          const void* qz, void* out, int M, int K, int N,
                          int group_size, void* stream) {
  using namespace awq::wg;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (N % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Params p{static_cast<__nv_bfloat16*>(out), M, K, N, group_size,
           qz != nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 256-row tiles halve the dequant work per flop; take them when they
  // still give every SM a block
  const int tall = ((M + 255) / 256) * ((N + BN - 1) / BN);
  return tall >= sms ? launch<256>(x, qw, sc, qz, p, st)
                     : launch<128>(x, qw, sc, qz, p, st);
}
