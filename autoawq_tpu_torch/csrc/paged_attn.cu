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
// far below the card's ~295 flops/byte. At decode lengths the walk over a
// slot's rows is latency-bound (a row's address depends on its page id).
//
// Design. The TPU kernel walks a (slot, kv head, page) grid in order and
// carries m / l / acc in VMEM scratch from page to page; it streams every
// page of the table, masking rows at or past vl. Here one CTA serves one
// (slot, kv head, chunk of up to RC query heads): the query heads of the
// group share each K/V row a warp loads (no padding of the group to 8
// rows), and the CTA's NW warps walk interleaved runs of U rows of the live
// range [lo, vl) with an online softmax per head in registers, so NW * U
// rows are in flight. The slot's page-table row is staged in shared memory
// first, so a row's load waits on one memory access, not two. The warps'
// (m, l, acc) are merged in shared memory in a fixed order at the end. The
// page ids and vl come from device memory (no host sync; a captured step
// replays at any length). Pages at or past vl, or wholly behind the window,
// are not read at all.
#include "paged_attn_common.cuh"

#include <math.h>

namespace {

constexpr int NW = 8;  // warps per CTA

template <int E, int RC, typename PT>
__global__ void __launch_bounds__(NW * 32) paged_attn_kernel(
    const float* __restrict__ q, const PT* __restrict__ kp,
    const PT* __restrict__ vp, const float* __restrict__ ks,
    const float* __restrict__ vs, const int* __restrict__ table,
    const int* __restrict__ lengths, const float* __restrict__ slopes,
    int nh, int nkv, int hd, int P, int ps, int pps, int window, float scale,
    float softcap, float* __restrict__ out) {
  constexpr int U = E >= 8 ? 2 : 4;  // rows a warp loads before using them
  extern __shared__ float smem[];
  const int rep = nh / nkv;
  const int nchunks = (rep + RC - 1) / RC;
  const int chunk = blockIdx.x % nchunks;
  const int bg = blockIdx.x / nchunks;
  const int b = bg / nkv, g = bg % nkv;
  const int r0 = chunk * RC, nr = min(RC, rep - r0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int* tb = reinterpret_cast<int*>(smem);  // [pps], padded to 4 ints
  float* sm_m = smem + ((pps + 3) & ~3);   // [NW][RC]
  float* sm_l = sm_m + NW * RC;            // [NW][RC]
  float* sm_acc = sm_l + NW * RC;          // [NW][RC][hd]
  for (int i = threadIdx.x; i < pps; i += blockDim.x)
    tb[i] = table[(size_t)b * pps + i];
  __syncthreads();

  const int vl = lengths[b];
  const int lo = window > 0 ? max(0, vl - window) : 0;
  const int end = min(vl, pps * ps);  // the table holds pps pages
  const int h0 = g * rep + r0;        // first query head of this CTA
  float qr[RC][E], slope[RC], m[RC], l[RC], acc[RC][E];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const float* qh = q + ((size_t)b * nh + h0 + r) * hd;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      qr[r][i] = (r < nr && d < hd) ? qh[d] : 0.0f;
      acc[r][i] = 0.0f;
    }
    slope[r] = (slopes != nullptr && r < nr) ? slopes[h0 + r] : 0.0f;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }

  for (int t0 = lo + warp * U; t0 < end; t0 += NW * U) {
    float kf[U][E], vf[U][E], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = t0 + u < end;
      const size_t row = ok ? paged::pool_row(tb, t0 + u, g, P, ps) : 0;
      paged::load_row<E>(kp, row, hd, lane, ok, kf[u]);
      paged::load_row<E>(vp, row, hd, lane, ok, vf[u]);
      ksc[u] = (ks != nullptr && ok) ? ks[row] : 1.0f;
      vsc[u] = (vs != nullptr && ok) ? vs[row] : 1.0f;
    }
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r >= nr) break;
      float s[U];
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < E; ++i) part = fmaf(qr[r][i], kf[u][i], part);
        float x = (paged::warp_sum(part) * scale) * ksc[u];
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        if (slopes != nullptr)
          x += slope[r] * static_cast<float>(t0 + u - (vl - 1));
        s[u] = x;
        if (t0 + u < end) mx = fmaxf(mx, x);
      }
      const float corr = expf(m[r] - mx);  // 0 while m is -inf
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = t0 + u < end ? expf(s[u] - mx) : 0.0f;
        l[r] += p;
        const float pv = p * vsc[u];  // V scales fold into p, not into l
#pragma unroll
        for (int i = 0; i < E; ++i) acc[r][i] = fmaf(pv, vf[u][i], acc[r][i]);
      }
      m[r] = mx;
    }
  }

#pragma unroll
  for (int r = 0; r < RC; ++r) {
    if (r >= nr) break;
    if (lane == 0) {
      sm_m[warp * RC + r] = m[r];
      sm_l[warp * RC + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) sm_acc[((size_t)warp * RC + r) * hd + d] = acc[r][i];
    }
  }
  __syncthreads();
  // merge the warps' partial softmaxes in warp order; a warp that saw no
  // row holds m = -inf and weighs 0
  for (int idx = threadIdx.x; idx < nr * hd; idx += blockDim.x) {
    const int r = idx / hd, d = idx % hd;
    float mx = -INFINITY;
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, sm_m[w * RC + r]);
    float lsum = 0.0f, a = 0.0f;
    if (mx > -INFINITY) {
      for (int w = 0; w < NW; ++w) {
        const float c = expf(sm_m[w * RC + r] - mx);
        lsum += c * sm_l[w * RC + r];
        a += c * sm_acc[((size_t)w * RC + r) * hd + d];
      }
    }
    out[((size_t)b * nh + h0 + r) * hd + d] = a / fmaxf(lsum, 1e-30f);
  }
}

template <int E, int RC, typename PT>
cudaError_t launch_t(int grid, size_t smem, cudaStream_t st, const float* q,
                     const void* kp, const void* vp, const float* ks,
                     const float* vs, const int* table, const int* lengths,
                     const float* slopes, int nh, int nkv, int hd, int P,
                     int ps, int pps, int window, float scale, float softcap,
                     float* out) {
  auto kernel = paged_attn_kernel<E, RC, PT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NW * 32, smem, st>>>(
      q, static_cast<const PT*>(kp), static_cast<const PT*>(vp), ks, vs,
      table, lengths, slopes, nh, nkv, hd, P, ps, pps, window, scale, softcap,
      out);
  return cudaGetLastError();
}

template <int E, int RC>
cudaError_t launch_rc(int page_kind, int grid, size_t smem, cudaStream_t st,
                      const float* q, const void* kp, const void* vp,
                      const float* ks, const float* vs, const int* table,
                      const int* lengths, const float* slopes, int nh,
                      int nkv, int hd, int P, int ps, int pps, int window,
                      float scale, float softcap, float* out) {
  switch (page_kind) {
    case 0:
      return launch_t<E, RC, __nv_bfloat16>(
          grid, smem, st, q, kp, vp, ks, vs, table, lengths, slopes, nh, nkv,
          hd, P, ps, pps, window, scale, softcap, out);
    case 1:
      return launch_t<E, RC, float>(grid, smem, st, q, kp, vp, ks, vs, table,
                                    lengths, slopes, nh, nkv, hd, P, ps, pps,
                                    window, scale, softcap, out);
    default:
      return launch_t<E, RC, int8_t>(grid, smem, st, q, kp, vp, ks, vs,
                                     table, lengths, slopes, nh, nkv, hd, P,
                                     ps, pps, window, scale, softcap, out);
  }
}

template <int E>
cudaError_t launch_e(int rc, int page_kind, int grid, size_t smem,
                     cudaStream_t st, const float* q, const void* kp,
                     const void* vp, const float* ks, const float* vs,
                     const int* table, const int* lengths,
                     const float* slopes, int nh, int nkv, int hd, int P,
                     int ps, int pps, int window, float scale, float softcap,
                     float* out) {
  switch (rc) {
    case 2:
      return launch_rc<E, 2>(page_kind, grid, smem, st, q, kp, vp, ks, vs,
                             table, lengths, slopes, nh, nkv, hd, P, ps, pps,
                             window, scale, softcap, out);
    case 4:
      return launch_rc<E, 4>(page_kind, grid, smem, st, q, kp, vp, ks, vs,
                             table, lengths, slopes, nh, nkv, hd, P, ps, pps,
                             window, scale, softcap, out);
    default:
      return launch_rc<E, 8>(page_kind, grid, smem, st, q, kp, vp, ks, vs,
                             table, lengths, slopes, nh, nkv, hd, P, ps, pps,
                             window, scale, softcap, out);
  }
}

}  // namespace

// q f32 [B, nh, hd]; kp / vp [nkv, P, ps, hd] (page_kind 0 bf16, 1 f32,
// 2 int8 with ks / vs f32 [nkv, P, ps]); table int32 [B, pps] of page ids
// in [0, P); lengths int32 [B] (valid rows); slopes f32 [nh] or null;
// window 0 = none; softcap 0 = none. Out f32 [B, nh * hd].
extern "C" int paged_attn(const void* q, const void* kp, const void* vp,
                          const void* ks, const void* vs, const void* table,
                          const void* lengths, const void* slopes, void* out,
                          int B, int nh, int nkv, int hd, int P, int ps,
                          int pps, int window, int page_kind, float scale,
                          float softcap, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rep = nh / nkv;
  const int rc = rep > 4 ? 8 : (rep > 2 ? 4 : 2);
  const int grid = B * nkv * ((rep + rc - 1) / rc);
  const size_t smem = sizeof(float) * (((pps + 3) & ~3) + 2 * NW * rc +
                                       (size_t)NW * rc * hd);
  auto* qf = static_cast<const float*>(q);
  auto* ksf = static_cast<const float*>(ks);
  auto* vsf = static_cast<const float*>(vs);
  auto* tb = static_cast<const int*>(table);
  auto* ln = static_cast<const int*>(lengths);
  auto* sl = static_cast<const float*>(slopes);
  auto* o = static_cast<float*>(out);
  cudaError_t err;
  if (hd <= 64) {
    err = launch_e<2>(rc, page_kind, grid, smem, st, qf, kp, vp, ksf, vsf, tb,
                      ln, sl, nh, nkv, hd, P, ps, pps, window, scale, softcap,
                      o);
  } else if (hd <= 128) {
    err = launch_e<4>(rc, page_kind, grid, smem, st, qf, kp, vp, ksf, vsf, tb,
                      ln, sl, nh, nkv, hd, P, ps, pps, window, scale, softcap,
                      o);
  } else {
    err = launch_e<8>(rc, page_kind, grid, smem, st, qf, kp, vp, ksf, vsf, tb,
                      ln, sl, nh, nkv, hd, P, ps, pps, window, scale, softcap,
                      o);
  }
  return static_cast<int>(err);
}
