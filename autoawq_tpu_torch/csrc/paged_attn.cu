// K7: paged decode attention read in place through a page table. Per slot b
// and kv head g, for each query head of the group: scores q . k of the rows
// in pages table[b, :] times `scale`, times the int8 K scale of the row,
// optional softcap tanh(s / c) * c, optional ALiBi slope * (t - (vl - 1)),
// masked to t < vl (and t >= vl - window with a window); a softmax whose
// denominator sums the unscaled probabilities while the int8 V scale
// multiplies the probability only in the PV product. Output f32
// [B, nh * hd].
//
// Replaces autoawq_tpu/ops/paged_attn.py::_make_kernel (driver
// paged_decode_attention), the TPU's block-table paged attention.
//
// Bound on the H100: bytes. Each live row of K and V (and its int8 scales)
// is read once from device memory; ~4 flops per element per query head,
// far below the card's ~295 flops/byte.
//
// Design. The TPU kernel walks a (slot, kv head, page) grid in order and
// carries m / l / acc in VMEM scratch from page to page. The first port had
// one CTA walk a slot's whole sequence with 2-byte loads, a few rows at a
// time: at decode lengths that walk was latency-bound (a row's address
// waits on its page id, and the longest slot's CTA set the time while most
// SMs idled). Here the sequence is split across CTAs (flash-decoding):
// every (slot, kv head, up to 16 query heads, split) has its own CTA
// (paged_attn_common.cuh), so at decode lengths every live page is read at
// once. For bf16 and int8 pools the CTA copies its split's K and V rows
// with 16-byte cp.async in 64-row tiles (the next tile in flight while this
// one is used), computes q k^T and p v with mma.sync on the tensor cores
// (an f32 q and p split into bf16 hi + lo parts, so the products keep f32
// accuracy), folds the K scale into the score and the V scale into p; a
// split past vl, or wholly behind the window, reads nothing. The second
// kernel merges the splits' (m, l, acc) per (slot, query head) in split
// order. The page ids and vl come from device memory and the grid from
// shapes alone (no host sync; a captured step replays at any length). One
// call is two device kernels on the caller's stream, counted as one launch
// by the wrapper.
#include "paged_attn_common.cuh"

namespace {

// out[bh, :] = sum_s e_s acc_s / sum_s e_s l_s, e_s = exp(m_s - max m);
// dead splits (m = -inf) are skipped, and a slot with none live gives 0.
// The splits' (m, l) are staged in shared memory first, so no load waits
// on another.
__global__ void __launch_bounds__(128) combine_kernel(
    const float* __restrict__ part, int B, int nh, int hd, int nsplit,
    float* __restrict__ out) {
  extern __shared__ float ml[];  // [nsplit][2]
  const int bh = blockIdx.x;
  const float* acc = part + (size_t)bh * nsplit * hd;
  const float* mlg =
      part + (size_t)B * nh * nsplit * hd + (size_t)bh * nsplit * 2;
  for (int i = threadIdx.x; i < 2 * nsplit; i += blockDim.x) ml[i] = mlg[i];
  __syncthreads();
  float mm = -INFINITY;
  for (int s = 0; s < nsplit; ++s) mm = fmaxf(mm, ml[2 * s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float ls = 0.0f, o = 0.0f;
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const float ms = ml[2 * s];
      if (ms == -INFINITY) continue;
      const float e = expf(ms - mm);
      ls += e * ml[2 * s + 1];
      o += e * acc[(size_t)s * hd + d];
    }
    out[(size_t)bh * hd + d] = o / fmaxf(ls, 1e-30f);
  }
}

}  // namespace

// q f32 [B, nh, hd]; kp / vp [nkv, P, ps, hd], 16-byte aligned (page_kind
// 0 bf16, 1 f32, 2 int8 with ks / vs f32 [nkv, P, ps]); table int32
// [B, pps] of page ids in [0, P); lengths int32 [B] (valid rows); slopes
// f32 [nh] or null; part f32 scratch of B * nh * nsplit * (hd + 2); spp
// pages a split, nsplit = ceil(pps / spp); window 0 = none; softcap 0 =
// none. Out f32 [B, nh * hd].
extern "C" int paged_attn(const void* q, const void* kp, const void* vp,
                          const void* ks, const void* vs, const void* table,
                          const void* lengths, const void* slopes, void* part,
                          void* out, int B, int nh, int nkv, int hd, int P,
                          int ps, int pps, int spp, int nsplit, int window,
                          int page_kind, float scale, float softcap,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const paged::SplitArgs a = paged::split_args(
      q, kp, vp, ks, vs, table, lengths, slopes, part, B, nh, nkv, hd, P, ps,
      pps, spp, nsplit, window, scale, softcap);
  cudaError_t err;
  switch (page_kind) {
    case 0:
      err = paged::launch_split_for<float, __nv_bfloat16>(a, st);
      break;
    case 1:
      err = paged::launch_split_for<float, float>(a, st);
      break;
    default:
      err = paged::launch_split_for<float, int8_t>(a, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  combine_kernel<<<B * nh, 128, 2 * nsplit * sizeof(float), st>>>(
      static_cast<const float*>(part), B, nh, hd, nsplit,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
