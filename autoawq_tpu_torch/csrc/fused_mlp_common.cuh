// The decode MLP y = down(act(gate(x)) * up(x)) for M <= 32 rows, shared by
// K3 (fused_mlp.cu: gate and up fused into one [K/8, 2 * inter] operand)
// and K8 (fused_mlp3.cu: three separate operands, the checkpoint layout).
//
// Bound on the H100: bytes (the int4 gate, up and down weights, read once).
//
// Design: two launches of the tensor-core GEMV core (w4a16_gemv.cuh), no
// workspace. Pass 1 places gate column j of the CTA's pairs in the first
// half of its columns and up column j (the same j of the up operand) in
// the second, so after the CTA's reduction it holds g and u of each of its
// pairs; its tile epilogue (ActMul) writes only h = act(g) * u, as bf16
// [M, inter] (a few KB; the TPU kernels likewise cast h to x's dtype
// before the down product). Pass 2 is K1's job (DenseJob, named DownJob
// here) on h against the down weights. Both passes take the CTA shape and
// cluster of ops/gemm.gemv_plan for their own K and N. Pass 2 is a
// programmatic dependent launch: its CTAs start while pass 1's last ones
// run and copy their first weights (which do not depend on h) before they
// wait for pass 1 to finish (0.6-1.2 us a call faster than a plain launch
// on the H100; PERF.md).
#pragma once

#include "w4a16_gemv.cuh"

namespace awq {

__device__ __forceinline__ float mlp_act(float g, int act) {
  if (act == 0) return g / (1.0f + __expf(-g));  // silu
  if (act == 2) return 0.5f * g * (1.0f + erff(g * 0.7071067811865476f));
  // gelu, tanh approximation (jax.nn.gelu(approximate=True))
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// Pass 1's tile epilogue: h[r][p0 + c] = bf16(act(g) * u) with g, u the
// CTA's columns c and c + half of row r.
struct ActMul {
  static constexpr bool TILE = true;
  __nv_bfloat16* h;
  int inter, p0, half, act;
  __device__ __forceinline__ void finish(const float* red, int rows, int e0,
                                         int step) const {
    for (int q = e0; q < rows * half; q += step) {
      const int r = q / half, c = q % half;
      if (p0 + c >= inter) continue;
      const float g = red[r * 2 * half + c];
      const float u = red[r * 2 * half + half + c];
      h[(size_t)r * inter + p0 + c] = __float2bfloat16(mlp_act(g, act) * u);
    }
  }
};

struct ActOut {
  static constexpr bool TRIGGER = true;  // pass 2 may start early
  __nv_bfloat16* h;
  int inter, act;
  __device__ ActMul at(int p0, int half, int m0) const {
    return {h + (size_t)m0 * inter, inter, p0, half, act};
  }
};

// Pass 2: K1's job, under a name of its own in profiles; it copies its
// first weights before it waits for pass 1 (WAIT: a dependent launch).
struct DownJob : gv::DenseJob {
  static constexpr bool WAIT = true;
};

// One gate or up operand: packed words, f32 scales and packed zeros (null:
// symmetric), their row stride given beside them.
struct MlpOperand {
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
};

// The two launches on `stream`: gate and up of row stride ld and group
// size gs1 over x [M, H]; down [inter/8, N2] of group size gs2; h bf16
// [M, inter]; nt n8 tiles a warp, cs1 / cs2 CTAs a cluster in each pass.
inline cudaError_t launch_mlp(const void* x, MlpOperand gate, MlpOperand up,
                              int ld, const void* dn_qw, const void* dn_sc,
                              const void* dn_qz, void* h, void* out, int M,
                              int H, int inter, int N2, int gs1, int gs2,
                              int act, int nt, int cs1, int cs2,
                              cudaStream_t stream) {
  if (M < 1 || M > 32 || inter % 4 != 0 || N2 % 4 != 0 || gs1 % 32 != 0 ||
      gs2 % 32 != 0 || H % gs1 != 0 || inter % gs2 != 0 ||
      !gv::plan_ok(nt, 1, cs1, false) || !gv::plan_ok(nt, 1, cs2, false))
    return cudaErrorInvalidValue;
  auto* hb = static_cast<__nv_bfloat16*>(h);
  const gv::PairJob<ActOut> p1{
      static_cast<const __nv_bfloat16*>(x),
      M, H, gs1, ld, cs1,
      gv::Pairs{{gate.qw, up.qw}, {gate.sc, up.sc}, {gate.qz, up.qz},
                inter, inter, inter, 0, 0},
      ActOut{hb, inter, act}};
  cudaError_t err = gv::launch_plan<false>(p1, nt, 1, stream);
  if (err != cudaSuccess) return err;
  const DownJob p2{{hb, static_cast<const int32_t*>(dn_qw),
                    static_cast<const float*>(dn_sc),
                    static_cast<const int32_t*>(dn_qz),
                    static_cast<__nv_bfloat16*>(out), M, inter, N2, gs2,
                    cs2}};
  return gv::launch_plan<false>(p2, nt, 1, stream);
}

}  // namespace awq
