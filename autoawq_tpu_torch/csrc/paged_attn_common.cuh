// Shared pieces of the paged decode attention kernels K7 (paged_attn.cu) and
// K9 (paged_attn_stock.cu), sm_90a.
//
// Page pools are [nkv, P, ps, hd] row-major (one page of one kv head is ps
// contiguous rows of hd elements); a slot's page table row is
// table[b * pps + page_block]. One CTA serves one (slot, kv head) and one
// warp one query head of that kv head's group; lane owns dims
// d = lane + 32 i (i < E), so each row is read with coalesced loads and
// dims >= hd are masked.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace paged {

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pool row of token t of slot b's sequence for kv head g: the index of its
// first element divided by hd (also the index of its int8 scale).
__device__ __forceinline__ size_t pool_row(const int* __restrict__ table_b,
                                           int t, int g, int P, int ps) {
  return ((size_t)g * P + table_b[t / ps]) * ps + t % ps;
}

// One row's E dims per lane, as f32 (zero past hd).
template <int E, typename PT>
__device__ __forceinline__ void load_row(const PT* __restrict__ pool,
                                         size_t row, int hd, int lane,
                                         bool ok, float* out) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int d = lane + 32 * i;
    out[i] = (ok && d < hd) ? to_f(pool[row * hd + d]) : 0.0f;
  }
}

}  // namespace paged
