// K4: causal prefill attention, out = softmax(q k^T * scale + causal) v,
// GQA by index. q [B, S, nh, hd], k/v [B, S, nkv, hd] bf16 (the token
// stride may exceed heads * hd, so slices of a fused qkv output need no
// copy); out [B, S, nh * hd] bf16, the convention of _flash_prefill.
//
// Replaces jax's stock TPU flash_attention as reached from
// autoawq_tpu/nn/modules.py::_flash_prefill (prefill with s >= 128).
//
// Bound on the H100: operations at long prompts (4 * S^2 / 2 * hd flops per
// head against 2 * S * hd * 4 bytes), bytes at short ones. This first
// kernel runs its dot products on the CUDA cores in f32, so it stays far
// from the tensor-core bound; mma-based tiles are later work.
//
// Design: one block per (q tile of BQ rows, head, batch). HD / 32 threads
// share one query row, each owning 32 of its dims (partial dot products
// meet by warp shuffles). The block walks BKV-key tiles of K and V through
// shared memory only up to the diagonal, reading its kv head h / (nh / nkv)
// directly (no repeat is materialized), and keeps the online softmax
// (running max, running sum, rescaled f32 accumulator) in registers.
// Instances: HD 64 and 128 with 64-row tiles; HD 256 with 32-row tiles, so
// its 256 threads and 32 KB of K/V tiles fit as the others do. The wrapper
// zero-pads any other head dim up to the next instance (exact, as
// _flash_prefill pads to a multiple of 64).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

template <int HD, int BQ, int BKV>
__global__ void __launch_bounds__(BQ * (HD / 32))
prefill_attn_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, int S, int NH, int NKV,
                    long long q_tok, long long k_tok, long long v_tok,
                    float scale_log2) {
  constexpr int TPR = HD / 32;  // threads per query row
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV][HD];
  __shared__ __align__(16) __nv_bfloat16 Vs[BKV][HD];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / NKV);
  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int i = qt * BQ + row;
  const int d0 = part * 32;

  float qf[32], o[32];
  {
    const __nv_bfloat16* qp = q + ((long long)b * S + i) * q_tok + h * HD + d0;
#pragma unroll
    for (int d = 0; d < 32; ++d) {
      qf[d] = i < S ? __bfloat162float(qp[d]) * scale_log2 : 0.0f;
      o[d] = 0.0f;
    }
  }
  float m_run = -CUDART_INF_F, l_run = 0.0f;

  const int kend = min(S, qt * BQ + BQ);
  for (int j0 = 0; j0 < kend; j0 += BKV) {
    __syncthreads();
    constexpr int CHUNKS = BKV * HD / 8;  // 16-byte chunks per tile
    for (int c = threadIdx.x; c < CHUNKS; c += blockDim.x) {
      const int jj = c / (HD / 8);
      const int dd = (c % (HD / 8)) * 8;
      const int j = j0 + jj;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (j < S) {
        kv4 = *reinterpret_cast<const uint4*>(
            k + ((long long)b * S + j) * k_tok + kvh * HD + dd);
        vv4 = *reinterpret_cast<const uint4*>(
            v + ((long long)b * S + j) * v_tok + kvh * HD + dd);
      }
      *reinterpret_cast<uint4*>(&Ks[jj][dd]) = kv4;
      *reinterpret_cast<uint4*>(&Vs[jj][dd]) = vv4;
    }
    __syncthreads();

    float s[BKV];
    float m_new = m_run;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      const __nv_bfloat162* kr =
          reinterpret_cast<const __nv_bfloat162*>(&Ks[jj][d0]);
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        const float2 kf = __bfloat1622float2(kr[d]);
        acc = fmaf(qf[2 * d], kf.x, acc);
        acc = fmaf(qf[2 * d + 1], kf.y, acc);
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int j = j0 + jj;
      s[jj] = (j <= i && j < S) ? acc : -CUDART_INF_F;
      m_new = fmaxf(m_new, s[jj]);
    }
    // rows past S see only masked keys; keep their arithmetic finite
    const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
    const float corr = exp2f(m_run - m_use);
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < 32; ++d) o[d] *= corr;
#pragma unroll
    for (int jj = 0; jj < BKV; ++jj) {
      const float p = exp2f(s[jj] - m_use);
      l_run += p;
      const __nv_bfloat162* vr =
          reinterpret_cast<const __nv_bfloat162*>(&Vs[jj][d0]);
#pragma unroll
      for (int d = 0; d < 16; ++d) {
        const float2 vf = __bfloat1622float2(vr[d]);
        o[2 * d] = fmaf(p, vf.x, o[2 * d]);
        o[2 * d + 1] = fmaf(p, vf.y, o[2 * d + 1]);
      }
    }
    m_run = m_new;
  }

  if (i < S) {
    const float inv = 1.0f / l_run;
    __nv_bfloat16* op = out + (((long long)b * S + i) * NH + h) * HD + d0;
#pragma unroll
    for (int d = 0; d < 32; d += 2) {
      *reinterpret_cast<__nv_bfloat162*>(op + d) =
          __floats2bfloat162_rn(o[d] * inv, o[d + 1] * inv);
    }
  }
}

template <int HD, int BQ, int BKV>
void launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
            const __nv_bfloat16* v, __nv_bfloat16* out, int B, int S, int NH,
            int NKV, long long q_tok, long long k_tok, long long v_tok,
            float scale_log2, cudaStream_t st) {
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  prefill_attn_kernel<HD, BQ, BKV><<<grid, BQ * (HD / 32), 0, st>>>(
      q, k, v, out, S, NH, NKV, q_tok, k_tok, v_tok, scale_log2);
}

}  // namespace

extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 void* out, int B, int S, int NH, int NKV,
                                 int HD, long long q_tok, long long k_tok,
                                 long long v_tok, float scale, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;  // exp -> exp2
  auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* kb = static_cast<const __nv_bfloat16*>(k);
  auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64) {
    launch<64, 64, 64>(qb, kb, vb, ob, B, S, NH, NKV, q_tok, k_tok, v_tok,
                       scale_log2, st);
  } else if (HD == 128) {
    launch<128, 64, 64>(qb, kb, vb, ob, B, S, NH, NKV, q_tok, k_tok, v_tok,
                        scale_log2, st);
  } else if (HD == 256) {
    launch<256, 32, 32>(qb, kb, vb, ob, B, S, NH, NKV, q_tok, k_tok, v_tok,
                        scale_log2, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
