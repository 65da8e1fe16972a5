// K9: the bf16 paged decode attention of jax's stock TPU kernel
// (jax.experimental.pallas.ops.tpu.paged_attention), as the JAX package
// calls it. Per slot b and kv head g, for each query head of the group:
// q arrives pre-scaled and in the pages' type (bf16); the sequence is cut
// into compute blocks of pages_per_compute_block pages (bk rows), and
// blocks at or past `length` are skipped. Per live block: scores q . k in
// f32, optional softcap, the additive mask -0.7 * FLT_MAX on rows at or
// past `length`, the block's own max m_c, p = exp(s - m_c) and its sum l_c;
// then the running (m, l, o) is merged and o renormalised:
//   m' = max(m, m_c), a = exp(m - m'), c = exp(m_c - m'), l' = a l + c l_c,
//   o' = (l a o + c (p @ v)) / l'.
// The stock kernel keeps o in q's type when the group (nh / nkv) is a
// multiple of 8 and in f32 otherwise, so o' is rounded to bf16 after every
// block in the first case. Output bf16 [B, nh, hd].
//
// Replaces jax's stock paged_attention (paged_flash_attention_kernel),
// reached from autoawq_tpu/nn/modules.py:459-466 with
// AWQ_TPU_PAGED_ATTN=stock.
//
// Bound on the H100: bytes (each live row of K and V read once; ~4 flops
// per element per query head).
//
// Design. The first port had one CTA walk a slot's blocks in order, each in
// three phases separated by barriers (K rows, the softmax in shared memory,
// then V rows), so V's loads waited on the scores and one CTA's latency
// walk set the time. Here the split kernels of paged_attn_common.cuh (scale
// 1, no window; on bf16 pools the tensor-core one: K and V rows copied
// together with 16-byte cp.async, q k^T and p v with mma.sync, p split into
// bf16 hi + lo parts) give every split of spp pages its own CTA; a split
// never straddles a compute block (spp divides pages_per_compute_block).
// Rows at or past `length` are not read: their masked score gives p = 0
// exactly in the stock kernel, so leaving them out changes no value, and a
// split with none live is an empty partial. The second kernel rebuilds
// each block's own (m_c, l_c, p @ v) from its splits' partials in f32 (a
// reordering of the same sums), then applies the stock merge above block
// by block, in order, rounding o' to bf16 after every block when the group
// is a multiple of 8. One call is two device kernels on the caller's
// stream, counted as one launch.
#include "paged_attn_common.cuh"

namespace {

// One thread per (slot, query head, dim): the blocks in order. The splits'
// (m, l) are staged in shared memory first, so no load waits on another.
__global__ void __launch_bounds__(128) stock_combine_kernel(
    const float* __restrict__ part, int B, int nh, int hd, int nsplit,
    int spb, int acc_bf16, __nv_bfloat16* __restrict__ out) {
  extern __shared__ float ml[];  // [nsplit][2]
  const int bh = blockIdx.x;
  const float* acc = part + (size_t)bh * nsplit * hd;
  const float* mlg =
      part + (size_t)B * nh * nsplit * hd + (size_t)bh * nsplit * 2;
  for (int i = threadIdx.x; i < 2 * nsplit; i += blockDim.x) ml[i] = mlg[i];
  __syncthreads();
  // the live blocks: a block's first split is live iff the block starts
  // before length, and every later block starts later
  int nblk = 0;
  while (nblk < nsplit / spb && ml[2 * nblk * spb] != -INFINITY) ++nblk;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float m = -INFINITY, l = 0.0f, o = 0.0f;
#pragma unroll 4
    for (int blk = 0; blk < nblk; ++blk) {
      const float* mb = ml + 2 * blk * spb;
      float mc = -INFINITY;
      for (int j = 0; j < spb; ++j) mc = fmaxf(mc, mb[2 * j]);
      float lc = 0.0f, pv = 0.0f;
      for (int j = 0; j < spb; ++j) {
        const float ms = mb[2 * j];
        if (ms == -INFINITY) continue;
        const float e = expf(ms - mc);
        lc += e * mb[2 * j + 1];
        pv += e * acc[(size_t)(blk * spb + j) * hd + d];
      }
      const float m_next = fmaxf(m, mc);
      const float alpha = expf(m - m_next);  // 0 on the first block
      const float beta = expf(mc - m_next);
      const float l_next = alpha * l + beta * lc;
      float v = (l * alpha * o + beta * pv) / l_next;
      if (acc_bf16) v = __bfloat162float(__float2bfloat16(v));
      o = v;
      l = l_next;
      m = m_next;
    }
    out[(size_t)bh * hd + d] = __float2bfloat16(o);
  }
}

}  // namespace

// q bf16 [B, nh, hd] (pre-scaled); kp / vp bf16 [nkv, P, ps, hd], 16-byte
// aligned; lengths int32 [B]; table int32 [B, pps] of page ids in [0, P);
// pps a multiple of ppcb, ppcb a multiple of spp (pages a split), nsplit =
// pps / spp; part f32 scratch of B * nh * nsplit * (hd + 2); softcap 0 =
// none; acc_bf16 rounds the running output to bf16 after each block. Out
// bf16 [B, nh, hd].
extern "C" int paged_attn_stock(const void* q, const void* kp,
                                const void* vp, const void* lengths,
                                const void* table, void* part, void* out,
                                int B, int nh, int nkv, int hd, int P, int ps,
                                int pps, int ppcb, int spp, int nsplit,
                                int acc_bf16, float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const paged::SplitArgs a = paged::split_args(
      q, kp, vp, nullptr, nullptr, table, lengths, nullptr, part, B, nh, nkv,
      hd, P, ps, pps, spp, nsplit, 0, 1.0f, softcap);
  cudaError_t err =
      paged::launch_split_for<__nv_bfloat16, __nv_bfloat16>(a, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  stock_combine_kernel<<<B * nh, 128, 2 * nsplit * sizeof(float), st>>>(
      static_cast<const float*>(part), B, nh, hd, nsplit, ppcb / spp,
      acc_bf16, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
