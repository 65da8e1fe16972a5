// K8: three-operand decode MLP, y = down(act(gate(x)) * up(x)) over separate
// int4 gate [K/8, inter], up [K/8, inter] and down [inter/8, N2] operands
// (the checkpoint layout that from_quantized(fuse_layers=False) keeps),
// M <= 32, silu, gelu(tanh) or exact gelu.
//
// Replaces autoawq_tpu/ops/sharded_mlp.py::_kernel (called from
// fused_mlp3_pallas), which the TPU runs on one chip for unfused gate/up
// at decode, and per tensor-parallel rank on its slice of inter (that
// part waits for the port's torch.distributed work).
//
// Bound on the H100: bytes (the int4 gate, up and down weights, read once).
//
// Design: K3's (fused_mlp_common.cuh) with the gate and up columns j read
// from their own operands (one group size for both): only h = act(g) * u
// reaches device memory (bf16), then K1's job for down. Two CUDA launches.
#include "fused_mlp_common.cuh"

// h: bf16 scratch [M, inter]; nt, cs1, cs2 from ops/gemm.gemv_plan.
extern "C" int fused_mlp3(const void* x, const void* g_qw, const void* g_sc,
                          const void* g_qz, const void* u_qw,
                          const void* u_sc, const void* u_qz,
                          const void* d_qw, const void* d_sc,
                          const void* d_qz, void* h, void* out, int M, int H,
                          int inter, int N2, int gs_gu, int gs_d, int act,
                          int nt, int cs1, int cs2, void* stream) {
  const awq::MlpOperand gate{static_cast<const int32_t*>(g_qw),
                             static_cast<const float*>(g_sc),
                             static_cast<const int32_t*>(g_qz)};
  const awq::MlpOperand up{static_cast<const int32_t*>(u_qw),
                           static_cast<const float*>(u_sc),
                           static_cast<const int32_t*>(u_qz)};
  return static_cast<int>(awq::launch_mlp(
      x, gate, up, inter, d_qw, d_sc, d_qz, h, out, M, H, inter, N2, gs_gu,
      gs_d, act, nt, cs1, cs2, static_cast<cudaStream_t>(stream)));
}
