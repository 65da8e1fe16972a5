// K3: fused decode MLP, y = down(act(gate(x)) * up(x)), int4 gate_up and
// down, M <= 32, silu, gelu(tanh) or exact gelu.
//
// Replaces autoawq_tpu/ops/fused_mlp.py::_kernel (called from
// fused_mlp_pallas).
// What the TPU kernel buys is that the [M, 2 * inter] gate_up intermediate
// never reaches device memory.
//
// Bound on the H100: bytes (the int4 gate_up and down weights, read once).
//
// Design: fused_mlp_common.cuh, with gate column j and its up partner
// inter + j of the fused gate_up layout as the two operands (the same
// words, scales and zeros, offset by inter columns).
#include "fused_mlp_common.cuh"

// h: bf16 scratch [M, inter]; ws: f32 scratch [splits, M, N2] (splits > 1).
extern "C" int fused_mlp(const void* x, const void* gu_qw, const void* gu_sc,
                         const void* gu_qz, const void* dn_qw,
                         const void* dn_sc, const void* dn_qz, void* h,
                         void* out, void* ws, int M, int H, int inter,
                         int N2, int gs1, int gs2, int act, int splits,
                         void* stream) {
  const auto* qw = static_cast<const int32_t*>(gu_qw);
  const auto* sc = static_cast<const float*>(gu_sc);
  const auto* qz = static_cast<const int32_t*>(gu_qz);
  const awq::MlpOperand gate{qw, sc, qz, 2 * inter, gs1};
  const awq::MlpOperand up{qw + inter, sc + inter,
                           qz == nullptr ? nullptr : qz + inter, 2 * inter,
                           gs1};
  return static_cast<int>(awq::launch_mlp(
      x, gate, up, dn_qw, dn_sc, dn_qz, h, out, ws, M, H, inter, N2, gs2, act,
      splits, static_cast<cudaStream_t>(stream)));
}
