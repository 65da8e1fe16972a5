// K1: W4A16 GEMV / small-M GEMM, y = x @ dequant(qweight, scales, qzeros).
//
// Replaces autoawq_tpu/ops/pallas_gemm.py::_kernel (called from
// awq_matmul_pallas), which the TPU runs for every int4 linear with M < 256.
//
// Bound on the H100: bytes. At decode (M <= 8) each packed weight is used M
// times, so the kernel does ~2M flops per 0.5 byte read, far below the
// card's ~295 flops/byte balance point; the least time is the weight stream
// over 3.35 TB/s.
//
// Design: one thread per output column (coalesced 128-byte warp loads of
// the column-major packed words), nibbles unpacked in registers, (q - z) * s
// applied in f32 per element, f32 accumulation (w4a16_common.cuh). A single
// TinyLlama linear has only N / 128 = 16..88 column blocks, too few for 132
// SMs, so K is split across the grid (blocks of packed rows, not aligned to
// groups) and a second, deterministic pass sums the f32 partials. Group
// sizes 32, 64 and 128 and symmetric weights (qz == null) all run here;
// the Pallas kernel could not run g < 128 on the TPU.
#include "w4a16_common.cuh"

extern "C" int w4a16_gemv(const void* x, const void* qw, const void* sc,
                          const void* qz, void* out, void* ws, int M, int K,
                          int N, int group_size, int splits, void* stream) {
  return static_cast<int>(awq::launch_gemv(x, qw, sc, qz, out, ws, M, K, N,
                                           group_size, splits,
                                           static_cast<cudaStream_t>(stream)));
}
