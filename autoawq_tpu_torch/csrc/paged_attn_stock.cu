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
// per element per query head); at decode lengths, the latency of the
// dependent page-table and row loads.
//
// Design. One CTA per (slot, kv head, chunk of up to RC query heads), NW
// warps; the slot's table row is staged in shared memory. Per block, three
// phases separated by barriers: (1) the warps split the block's rows, each
// warp loads a row once for all RC heads and writes its scores to shared
// memory; (2) warp r reduces head r's block max, turns the scores into
// p = exp(s - m_c) in place and sums them; (3) the warps split the rows
// again for p @ v, and their partial sums are added in warp order before
// one thread per (head, dim) merges them into the running output, which
// lives in shared memory across blocks. Rows at or past `length` inside the
// last live block are not read: their masked score gives p = 0 exactly, so
// skipping them changes no value.
#include "paged_attn_common.cuh"

#include <math.h>

namespace {

constexpr int NW = 8;  // warps per CTA

template <int E, int RC>
__global__ void __launch_bounds__(NW * 32) paged_attn_stock_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, const int* __restrict__ lengths,
    const int* __restrict__ table, int nh, int nkv, int hd, int P, int ps,
    int pps, int ppcb, float softcap, int acc_bf16,
    __nv_bfloat16* __restrict__ out) {
  constexpr int U = E >= 8 ? 2 : 4;
  extern __shared__ float smem[];
  const int rep = nh / nkv;
  const int nchunks = (rep + RC - 1) / RC;
  const int chunk = blockIdx.x % nchunks;
  const int bg = blockIdx.x / nchunks;
  const int b = bg / nkv, g = bg % nkv;
  const int r0 = chunk * RC, nr = min(RC, rep - r0);
  const int h0 = g * rep + r0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bk = ppcb * ps;

  int* tb = reinterpret_cast<int*>(smem);        // [pps], padded to 4 ints
  float* sc = smem + ((pps + 3) & ~3);           // [RC][bk] scores, then p
  float* part = sc + (size_t)RC * bk;            // [NW][RC][hd] p @ v parts
  float* o = part + (size_t)NW * RC * hd;        // [RC][hd] running output
  float* stat = o + (size_t)RC * hd;             // m, l, m_c, l_c: [4][RC]
  for (int i = threadIdx.x; i < pps; i += blockDim.x)
    tb[i] = table[(size_t)b * pps + i];
  for (int i = threadIdx.x; i < RC * hd; i += blockDim.x) o[i] = 0.0f;
  if (threadIdx.x < RC) {
    stat[threadIdx.x] = -INFINITY;
    stat[RC + threadIdx.x] = 0.0f;
  }
  __syncthreads();

  float qr[RC][E];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const __nv_bfloat16* qh = q + ((size_t)b * nh + h0 + r) * hd;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < nr && d < hd) ? __bfloat162float(qh[d]) : 0.0f;
    }
  }
  const int length = lengths[b];
  // blocks past the slot's pps pages do not exist (the stock kernel's grid)
  const int nblk = length > 0 ? min((length + bk - 1) / bk, pps / ppcb) : 0;
  for (int blk = 0; blk < nblk; ++blk) {
    const int t_base = blk * bk;
    const int n = min(bk, length - t_base);  // live rows of this block
    // (1) scores
    for (int j0 = warp * U; j0 < n; j0 += NW * U) {
      float kf[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = j0 + u < n;
        const size_t row =
            ok ? paged::pool_row(tb, t_base + j0 + u, g, P, ps) : 0;
        paged::load_row<E>(kp, row, hd, lane, ok, kf[u]);
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part_s = 0.0f;
#pragma unroll
          for (int i = 0; i < E; ++i)
            part_s = fmaf(qr[r][i], kf[u][i], part_s);
          float s = paged::warp_sum(part_s);
          if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
          if (lane == 0 && j0 + u < n) sc[(size_t)r * bk + j0 + u] = s;
        }
      }
    }
    __syncthreads();
    // (2) per head: block max, p = exp(s - m_c) in place, l_c
    for (int r = warp; r < nr; r += NW) {
      float* sr = sc + (size_t)r * bk;
      float mc = -INFINITY;
      for (int j = lane; j < n; j += 32) mc = fmaxf(mc, sr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      float lc = 0.0f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sr[j] - mc);
        sr[j] = p;
        lc += p;
      }
      lc = paged::warp_sum(lc);
      if (lane == 0) {
        stat[2 * RC + r] = mc;
        stat[3 * RC + r] = lc;
      }
    }
    __syncthreads();
    // (3) p @ v, split over the warps' rows
    float oc[RC][E];
#pragma unroll
    for (int r = 0; r < RC; ++r)
#pragma unroll
      for (int i = 0; i < E; ++i) oc[r][i] = 0.0f;
    for (int j0 = warp * U; j0 < n; j0 += NW * U) {
      float vf[U][E];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool ok = j0 + u < n;
        const size_t row =
            ok ? paged::pool_row(tb, t_base + j0 + u, g, P, ps) : 0;
        paged::load_row<E>(vp, row, hd, lane, ok, vf[u]);
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r >= nr) break;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = j0 + u < n ? sc[(size_t)r * bk + j0 + u] : 0.0f;
#pragma unroll
          for (int i = 0; i < E; ++i) oc[r][i] = fmaf(p, vf[u][i], oc[r][i]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r >= nr) break;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int d = lane + 32 * i;
        if (d < hd) part[((size_t)warp * RC + r) * hd + d] = oc[r][i];
      }
    }
    __syncthreads();
    // merge into the running output (one thread per (head, dim))
    for (int idx = threadIdx.x; idx < nr * hd; idx += blockDim.x) {
      const int r = idx / hd, d = idx % hd;
      float pv = 0.0f;
      for (int w = 0; w < NW; ++w) pv += part[((size_t)w * RC + r) * hd + d];
      const float m = stat[r], l = stat[RC + r];
      const float mc = stat[2 * RC + r], lc = stat[3 * RC + r];
      const float m_next = fmaxf(m, mc);
      const float alpha = expf(m - m_next);  // 0 on the first block
      const float beta = expf(mc - m_next);
      const float l_next = alpha * l + beta * lc;
      float v = (l * alpha * o[r * hd + d] + beta * pv) / l_next;
      if (acc_bf16) v = __bfloat162float(__float2bfloat16(v));
      o[r * hd + d] = v;
    }
    __syncthreads();
    if (threadIdx.x < nr) {  // after every thread has read the old m, l
      const int r = threadIdx.x;
      const float m = stat[r], mc = stat[2 * RC + r];
      const float m_next = fmaxf(m, mc);
      stat[RC + r] = expf(m - m_next) * stat[RC + r]
                     + expf(mc - m_next) * stat[3 * RC + r];
      stat[r] = m_next;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < nr * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    out[((size_t)b * nh + h0 + r) * hd + d] = __float2bfloat16(o[r * hd + d]);
  }
}

template <int E, int RC>
cudaError_t launch_t(int grid, size_t smem, cudaStream_t st,
                     const __nv_bfloat16* q, const __nv_bfloat16* kp,
                     const __nv_bfloat16* vp, const int* lengths,
                     const int* table, int nh, int nkv, int hd, int P, int ps,
                     int pps, int ppcb, float softcap, int acc_bf16,
                     __nv_bfloat16* out) {
  auto kernel = paged_attn_stock_kernel<E, RC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NW * 32, smem, st>>>(q, kp, vp, lengths, table, nh, nkv, hd,
                                      P, ps, pps, ppcb, softcap, acc_bf16,
                                      out);
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_e(int rc, int grid, size_t smem, cudaStream_t st,
                     const __nv_bfloat16* q, const __nv_bfloat16* kp,
                     const __nv_bfloat16* vp, const int* lengths,
                     const int* table, int nh, int nkv, int hd, int P, int ps,
                     int pps, int ppcb, float softcap, int acc_bf16,
                     __nv_bfloat16* out) {
  switch (rc) {
    case 2:
      return launch_t<E, 2>(grid, smem, st, q, kp, vp, lengths, table, nh,
                            nkv, hd, P, ps, pps, ppcb, softcap, acc_bf16,
                            out);
    case 4:
      return launch_t<E, 4>(grid, smem, st, q, kp, vp, lengths, table, nh,
                            nkv, hd, P, ps, pps, ppcb, softcap, acc_bf16,
                            out);
    default:
      return launch_t<E, 8>(grid, smem, st, q, kp, vp, lengths, table, nh,
                            nkv, hd, P, ps, pps, ppcb, softcap, acc_bf16,
                            out);
  }
}

}  // namespace

// q bf16 [B, nh, hd] (pre-scaled); kp / vp bf16 [nkv, P, ps, hd]; lengths
// int32 [B]; table int32 [B, pps] of page ids in [0, P); pps a multiple of
// ppcb; softcap 0 = none; acc_bf16 rounds the running output to bf16 after
// each block. Out bf16 [B, nh, hd]. Dynamic shared memory, in floats:
// pps rounded up to 4, then RC * ppcb * ps + (NW + 1) * RC * hd + 4 * RC
// (RC = 2, 4 or 8 query heads a CTA; ops/paged_attn.py checks the total).
extern "C" int paged_attn_stock(const void* q, const void* kp,
                                const void* vp, const void* lengths,
                                const void* table, void* out, int B, int nh,
                                int nkv, int hd, int P, int ps, int pps,
                                int ppcb, int acc_bf16, float softcap,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = nh / nkv;
  const int rc = rep > 4 ? 8 : (rep > 2 ? 4 : 2);
  const int grid = B * nkv * ((rep + rc - 1) / rc);
  const size_t smem =
      sizeof(float) * (((pps + 3) & ~3) + (size_t)rc * ppcb * ps +
                       (size_t)(NW + 1) * rc * hd + 4 * rc);
  auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* kb = static_cast<const __nv_bfloat16*>(kp);
  auto* vb = static_cast<const __nv_bfloat16*>(vp);
  auto* ln = static_cast<const int*>(lengths);
  auto* tb = static_cast<const int*>(table);
  auto* o = static_cast<__nv_bfloat16*>(out);
  cudaError_t err;
  if (hd <= 64) {
    err = launch_e<2>(rc, grid, smem, st, qb, kb, vb, ln, tb, nh, nkv, hd, P,
                      ps, pps, ppcb, softcap, acc_bf16, o);
  } else if (hd <= 128) {
    err = launch_e<4>(rc, grid, smem, st, qb, kb, vb, ln, tb, nh, nkv, hd, P,
                      ps, pps, ppcb, softcap, acc_bf16, o);
  } else {
    err = launch_e<8>(rc, grid, smem, st, qb, kb, vb, ln, tb, nh, nkv, hd, P,
                      ps, pps, ppcb, softcap, acc_bf16, o);
  }
  return static_cast<int>(err);
}
