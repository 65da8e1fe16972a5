// Shared pieces of the port's W4A16 kernels (sm_90a).
//
// Weight layout (autoawq_tpu_torch/core/packing.py): qweight int32 [K/8, N],
// nibble i of word (r, n) is element (8r + i, n); zero points int32
// [ceil(G/8), N] packed the same way along G (null = symmetric, zero point
// 8); scales float32 [G, N]. x and outputs are bf16, row-major.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace awq {

__device__ __forceinline__ float nibble(uint32_t w, int i) {
  return static_cast<float>((w >> (4 * i)) & 0xFu);
}

__device__ __forceinline__ float zero_point(const int32_t* qz, int g, int n,
                                            int N) {
  if (qz == nullptr) return 8.0f;
  uint32_t w = static_cast<uint32_t>(qz[(size_t)(g >> 3) * N + n]);
  return nibble(w, g & 7);
}

// Eight consecutive bf16 of x (16 bytes, aligned because K % 8 == 0).
__device__ __forceinline__ void load_x8(const __nv_bfloat16* p, float* out) {
  uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Split-K GEMV partial: one thread per output column, the grid's y axis
// walks M tiles of MT rows and its z axis splits K (in packed rows of 8).
// Each thread reads its column's packed words top to bottom (neighbouring
// threads read neighbouring words: coalesced), unpacks the 8 nibbles in
// registers, dequantizes (q - z) * s in f32 and accumulates in f32. With
// ws == nullptr (one split) it writes bf16 to out directly; otherwise it
// writes f32 partials ws[split][m][n] for gemv_reduce.
template <int MT>
__global__ void __launch_bounds__(128)
gemv_partial(const __nv_bfloat16* __restrict__ x,
             const int32_t* __restrict__ qw, const float* __restrict__ sc,
             const int32_t* __restrict__ qz, __nv_bfloat16* __restrict__ out,
             float* __restrict__ ws, int M, int K, int N, int group_size,
             int rows_per_split) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m0 = blockIdx.y * MT;
  const int split = blockIdx.z;
  const int K8 = K / 8;
  const int r0 = split * rows_per_split;
  const int r1 = min(K8, r0 + rows_per_split);
  if (n >= N) return;
  float acc[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) acc[m] = 0.0f;
  int g_cur = -1;
  float s = 0.0f, z = 0.0f;
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    const uint32_t w = static_cast<uint32_t>(__ldg(qw + (size_t)r * N + n));
    const int g = (8 * r) / group_size;
    if (g != g_cur) {
      s = __ldg(sc + (size_t)g * N + n);
      z = zero_point(qz, g, n, N);
      g_cur = g;
    }
    float wv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) wv[i] = (nibble(w, i) - z) * s;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m < M) {
        float xv[8];
        load_x8(x + (size_t)(m0 + m) * K + 8 * r, xv);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[m] = fmaf(xv[i], wv[i], acc[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) break;
    if (ws == nullptr) {
      out[(size_t)(m0 + m) * N + n] = __float2bfloat16(acc[m]);
    } else {
      ws[((size_t)split * M + (m0 + m)) * N + n] = acc[m];
    }
  }
}

// Second pass of the split-K GEMV: out[m][n] = sum over splits, in a fixed
// order (deterministic, unlike atomics).
__global__ void gemv_reduce(const float* __restrict__ ws,
                            __nv_bfloat16* __restrict__ out, int M, int N,
                            int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)M * N;
  if (i >= total) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += ws[(size_t)s * total + i];
  out[i] = __float2bfloat16(acc);
}

// Launch the split-K GEMV on `stream`. ws must hold splits * M * N floats
// when splits > 1.
inline cudaError_t launch_gemv(const void* x, const void* qw, const void* sc,
                               const void* qz, void* out, void* ws, int M,
                               int K, int N, int group_size, int splits,
                               cudaStream_t stream) {
  const int K8 = K / 8;
  const int rows_per_split = (K8 + splits - 1) / splits;
  const int threads = 128;
  const int mt = M >= 8 ? 8 : (M >= 4 ? 4 : (M >= 2 ? 2 : 1));
  dim3 grid((N + threads - 1) / threads, (M + mt - 1) / mt, splits);
  auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* qwb = static_cast<const int32_t*>(qw);
  auto* scb = static_cast<const float*>(sc);
  auto* qzb = static_cast<const int32_t*>(qz);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  float* wsb = splits > 1 ? static_cast<float*>(ws) : nullptr;
  switch (mt) {
    case 8:
      gemv_partial<8><<<grid, threads, 0, stream>>>(
          xb, qwb, scb, qzb, ob, wsb, M, K, N, group_size, rows_per_split);
      break;
    case 4:
      gemv_partial<4><<<grid, threads, 0, stream>>>(
          xb, qwb, scb, qzb, ob, wsb, M, K, N, group_size, rows_per_split);
      break;
    case 2:
      gemv_partial<2><<<grid, threads, 0, stream>>>(
          xb, qwb, scb, qzb, ob, wsb, M, K, N, group_size, rows_per_split);
      break;
    default:
      gemv_partial<1><<<grid, threads, 0, stream>>>(
          xb, qwb, scb, qzb, ob, wsb, M, K, N, group_size, rows_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = (size_t)M * N;
  gemv_reduce<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      wsb, ob, M, N, splits);
  return cudaGetLastError();
}

}  // namespace awq
