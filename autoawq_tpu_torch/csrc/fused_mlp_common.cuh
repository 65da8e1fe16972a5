// The decode MLP y = down(act(gate(x)) * up(x)) for M <= 32 rows, shared by
// K3 (fused_mlp.cu: gate and up fused into one [K/8, 2 * inter] operand)
// and K8 (fused_mlp3.cu: three separate operands, the checkpoint layout).
//
// Bound on the H100: bytes (the int4 gate, up and down weights, read once).
//
// Design: launch 1 (gate_up_act) pairs columns. A block of 8 warps owns 32
// gate columns j (one per lane) and the up columns j beside them; each warp
// walks one eighth of K, the eight partial sums meet in shared memory, and
// only h = act(g) * u goes out, as bf16 [M, inter] (a few KB; the TPU
// kernels likewise cast h to x's dtype before the down product). Launches
// 2 and 3 are the split-K GEMV and its reduction pass from
// w4a16_common.cuh (the K1 machinery) on h against the down weights. One
// call therefore costs three CUDA launches; a grid-wide sync that folds
// them into one is later work.
#pragma once

#include "w4a16_common.cuh"

namespace awq {

constexpr int MLP_WARPS = 8;
constexpr int MLP_MT = 8;  // rows per pass; M tiles beyond 8 run on grid.y

__device__ __forceinline__ float mlp_act(float g, int act) {
  if (act == 0) return g / (1.0f + __expf(-g));  // silu
  if (act == 2) return 0.5f * g * (1.0f + erff(g * 0.7071067811865476f));
  // gelu, tanh approximation (jax.nn.gelu(approximate=True))
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

// One operand of the gate/up pass: packed words [K/8, ld], f32 scales and
// packed zeros (null: symmetric) of row stride ld, groups of gs rows.
struct MlpOperand {
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
  int ld;
  int gs;
};

__global__ void __launch_bounds__(MLP_WARPS * 32)
gate_up_act(const __nv_bfloat16* __restrict__ x, MlpOperand gate,
            MlpOperand up, __nv_bfloat16* __restrict__ h, int M, int K,
            int inter, int act) {
  __shared__ float part[MLP_WARPS][2][MLP_MT][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;  // column of both operands
  const int m0 = blockIdx.y * MLP_MT;
  const int K8 = K / 8;
  const int per = (K8 + MLP_WARPS - 1) / MLP_WARPS;
  const int r0 = warp * per;
  const int r1 = min(K8, r0 + per);
  float ag[MLP_MT], au[MLP_MT];
#pragma unroll
  for (int m = 0; m < MLP_MT; ++m) ag[m] = au[m] = 0.0f;
  if (j < inter) {
    int gg_cur = -1, gu_cur = -1;
    float sg = 0.f, zg = 0.f, su = 0.f, zu = 0.f;
    for (int r = r0; r < r1; ++r) {
      const uint32_t wg =
          static_cast<uint32_t>(__ldg(gate.qw + (size_t)r * gate.ld + j));
      const uint32_t wu =
          static_cast<uint32_t>(__ldg(up.qw + (size_t)r * up.ld + j));
      const int gg = (8 * r) / gate.gs;
      if (gg != gg_cur) {
        sg = __ldg(gate.sc + (size_t)gg * gate.ld + j);
        zg = zero_point(gate.qz, gg, j, gate.ld);
        gg_cur = gg;
      }
      const int gu = (8 * r) / up.gs;
      if (gu != gu_cur) {
        su = __ldg(up.sc + (size_t)gu * up.ld + j);
        zu = zero_point(up.qz, gu, j, up.ld);
        gu_cur = gu;
      }
      float vg[8], vu[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        vg[i] = (nibble(wg, i) - zg) * sg;
        vu[i] = (nibble(wu, i) - zu) * su;
      }
#pragma unroll
      for (int m = 0; m < MLP_MT; ++m) {
        if (m0 + m < M) {
          float xv[8];
          load_x8(x + (size_t)(m0 + m) * K + 8 * r, xv);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            ag[m] = fmaf(xv[i], vg[i], ag[m]);
            au[m] = fmaf(xv[i], vu[i], au[m]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MLP_MT; ++m) {
    part[warp][0][m][lane] = ag[m];
    part[warp][1][m][lane] = au[m];
  }
  __syncthreads();
  if (warp == 0 && j < inter) {
#pragma unroll
    for (int m = 0; m < MLP_MT; ++m) {
      if (m0 + m >= M) break;
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int w = 0; w < MLP_WARPS; ++w) {
        g += part[w][0][m][lane];
        u += part[w][1][m][lane];
      }
      h[(size_t)(m0 + m) * inter + j] = __float2bfloat16(mlp_act(g, act) * u);
    }
  }
}

// The three launches on `stream`. h: bf16 scratch [M, inter]; ws: f32
// scratch [splits, M, N2] (splits > 1).
inline cudaError_t launch_mlp(const void* x, MlpOperand gate, MlpOperand up,
                              const void* dn_qw, const void* dn_sc,
                              const void* dn_qz, void* h, void* out, void* ws,
                              int M, int H, int inter, int N2, int dn_gs,
                              int act, int splits, cudaStream_t stream) {
  dim3 grid((inter + 31) / 32, (M + MLP_MT - 1) / MLP_MT);
  gate_up_act<<<grid, MLP_WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), gate, up,
      static_cast<__nv_bfloat16*>(h), M, H, inter, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_gemv(h, dn_qw, dn_sc, dn_qz, out, ws, M, inter, N2, dn_gs,
                     splits, stream);
}

}  // namespace awq
