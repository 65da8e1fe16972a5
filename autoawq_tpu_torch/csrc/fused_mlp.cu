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
// Design: launch 1 (gate_up_act) pairs columns. A block of 8 warps owns 32
// gate columns j (one per lane) and their up partners inter + j in the
// fused gate_up layout; each warp walks one eighth of K, the eight partial
// sums meet in shared memory, and only h = act(g) * u goes out, as bf16
// [M, inter] (a few KB; the TPU kernel likewise casts h to x's dtype
// before the down product). Launches 2 and 3 are the split-K GEMV and its
// reduction pass from w4a16_common.cuh (the K1 machinery) on h against the
// down weights. One call therefore costs three CUDA launches; a grid-wide
// sync that folds them into one is later work.
#include "w4a16_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int MT = 8;  // rows per pass; M tiles beyond 8 run on grid.y

__device__ __forceinline__ float act_fn(float g, int act) {
  if (act == 0) return g / (1.0f + __expf(-g));  // silu
  if (act == 2) return 0.5f * g * (1.0f + erff(g * 0.7071067811865476f));
  // gelu, tanh approximation (jax.nn.gelu(approximate=True))
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * g * (1.0f + tanhf(c * (g + 0.044715f * g * g * g)));
}

__global__ void __launch_bounds__(WARPS * 32)
gate_up_act(const __nv_bfloat16* __restrict__ x,
            const int32_t* __restrict__ qw, const float* __restrict__ sc,
            const int32_t* __restrict__ qz, __nv_bfloat16* __restrict__ h,
            int M, int K, int N1, int inter, int group_size, int act) {
  __shared__ float part[WARPS][2][MT][32];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * 32 + lane;  // gate column; up is inter + j
  const int m0 = blockIdx.y * MT;
  const int K8 = K / 8;
  const int per = (K8 + WARPS - 1) / WARPS;
  const int r0 = warp * per;
  const int r1 = min(K8, r0 + per);
  float ag[MT], au[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) ag[m] = au[m] = 0.0f;
  if (j < inter) {
    const int ju = inter + j;
    int g_cur = -1;
    float sg = 0.f, zg = 0.f, su = 0.f, zu = 0.f;
    for (int r = r0; r < r1; ++r) {
      const uint32_t wg =
          static_cast<uint32_t>(__ldg(qw + (size_t)r * N1 + j));
      const uint32_t wu =
          static_cast<uint32_t>(__ldg(qw + (size_t)r * N1 + ju));
      const int g = (8 * r) / group_size;
      if (g != g_cur) {
        sg = __ldg(sc + (size_t)g * N1 + j);
        su = __ldg(sc + (size_t)g * N1 + ju);
        zg = awq::zero_point(qz, g, j, N1);
        zu = awq::zero_point(qz, g, ju, N1);
        g_cur = g;
      }
      float vg[8], vu[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        vg[i] = (awq::nibble(wg, i) - zg) * sg;
        vu[i] = (awq::nibble(wu, i) - zu) * su;
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m0 + m < M) {
          float xv[8];
          awq::load_x8(x + (size_t)(m0 + m) * K + 8 * r, xv);
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
  for (int m = 0; m < MT; ++m) {
    part[warp][0][m][lane] = ag[m];
    part[warp][1][m][lane] = au[m];
  }
  __syncthreads();
  if (warp == 0 && j < inter) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m >= M) break;
      float g = 0.f, u = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        g += part[w][0][m][lane];
        u += part[w][1][m][lane];
      }
      h[(size_t)(m0 + m) * inter + j] = __float2bfloat16(act_fn(g, act) * u);
    }
  }
}

}  // namespace

// h: bf16 scratch [M, inter]; ws: f32 scratch [splits, M, N2] (splits > 1).
extern "C" int fused_mlp(const void* x, const void* gu_qw, const void* gu_sc,
                         const void* gu_qz, const void* dn_qw,
                         const void* dn_sc, const void* dn_qz, void* h,
                         void* out, void* ws, int M, int H, int inter,
                         int N2, int gs1, int gs2, int act, int splits,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((inter + 31) / 32, (M + MT - 1) / MT);
  gate_up_act<<<grid, WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const int32_t*>(gu_qw), static_cast<const float*>(gu_sc),
      static_cast<const int32_t*>(gu_qz), static_cast<__nv_bfloat16*>(h), M,
      H, 2 * inter, inter, gs1, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(awq::launch_gemv(h, dn_qw, dn_sc, dn_qz, out, ws, M,
                                           inter, N2, gs2, splits, st));
}
