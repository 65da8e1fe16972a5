// K5: one decode attention step for B <= 8 rows: int4 qkv GEMV (+ bias) ->
// neox RoPE on q and k -> softmax over the cached rows plus the current
// token -> int4 o GEMV. bf16 cache, or int8 with per-(row, head, token)
// absmax scales folded into the scores (K) and the probabilities (V), and
// an optional sliding window.
//
// Replaces autoawq_tpu/ops/fused_attn_step.py::_kernel (called from
// fused_attention_step), which the TPU runs for batched (B >= 8) and
// long-context (B * T >= 2048, or an int8 cache of T >= 2048) decode.
//
// Bound on the H100: bytes. The qkv and o weights (int4, read once) and the
// cache rows below the valid length (and their scales) are streamed once;
// the arithmetic is ~2 flops per weight nibble per row and ~4 per cached
// element per query head, far below the card's ~295 flops/byte.
//
// Design. The TPU kernel keeps the whole cache in VMEM and runs its phases
// one after another on one core; Hopper's shared memory cannot hold a cache
// slab, and a phase needs the whole result of the one before it. So one
// wrapper call is six CUDA launches on one stream:
//   1. the split-K GEMV partials of K1 (w4a16_common.cuh) for qkv, in f32;
//   2. qkv_finish: sums the partials and adds the bias in f32, applies RoPE
//      in f32 (the TPU kernel never rounds q/k/v before RoPE), and writes
//      k_new / v_new (bf16 for a bf16 cache, f32 for an int8 one, so the
//      caller quantizes the real rows);
//   3. attn_split: flash-decoding. One warp per (row, kv head, chunk of up
//      to 8 query heads, KV split) walks its slice of the valid rows (the
//      valid length is read from device memory, so a captured step replays
//      at any position), keeping an online softmax per query head: the kv
//      head's rows are read once for all its query heads;
//   4. attn_combine: per (row, query head), merges the splits in a fixed
//      order with the current token's diagonal term, and rounds the
//      attention output to bf16 (as the TPU kernel casts og_scr to x's
//      type before the o product);
//   5-6. K1's split-K GEMV and its reduction for the o projection, to bf16.
// A split whose rows are all masked keeps m = -inf and l = 0 and gets zero
// weight in the combine, so vl = 0 gives exactly the diagonal term.
#include "w4a16_common.cuh"

#include <math.h>

namespace {

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (nh + 2 * nkv, B), block hd / 2: thread j owns dims j and j + hd/2
// of one head of one row.
__global__ void qkv_finish(const float* __restrict__ ws, int splits, int B,
                           int N, const float* __restrict__ bias,
                           const float* __restrict__ cos_t,
                           const float* __restrict__ sin_t, int cs_stride,
                           int nh, int nkv, int hd, float* __restrict__ qkvf,
                           void* __restrict__ k_new, void* __restrict__ v_new,
                           int kv_f32) {
  const int head = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  const int half = hd / 2;
  if (j >= half) return;
  const int c0 = head * hd + j, c1 = c0 + half;
  float v0 = 0.0f, v1 = 0.0f;
  for (int s = 0; s < splits; ++s) {
    const float* row = ws + ((size_t)s * B + b) * N;
    v0 += row[c0];
    v1 += row[c1];
  }
  if (bias != nullptr) {
    v0 += bias[c0];
    v1 += bias[c1];
  }
  if (head < nh + nkv) {  // q and k heads rotate; v heads do not
    const float c = cos_t[b * cs_stride + j], sn = sin_t[b * cs_stride + j];
    const float r0 = v0 * c - v1 * sn;
    const float r1 = v1 * c + v0 * sn;
    v0 = r0;
    v1 = r1;
  }
  float* dst = qkvf + ((size_t)b * (nh + 2 * nkv) + head) * hd;
  dst[j] = v0;
  dst[j + half] = v1;
  if (head >= nh) {
    const int g = head - nh;
    void* out = g < nkv ? k_new : v_new;
    const size_t o = ((size_t)b * nkv + (g % nkv)) * hd;
    if (kv_f32) {
      float* p = static_cast<float*>(out) + o;
      p[j] = v0;
      p[j + half] = v1;
    } else {
      __nv_bfloat16* p = static_cast<__nv_bfloat16*>(out) + o;
      p[j] = __float2bfloat16(v0);
      p[j + half] = __float2bfloat16(v1);
    }
  }
}

// One warp per block. E: head dims per lane (lane owns d = lane + 32 i, so
// a row is read with coalesced loads; dims >= hd are masked). RC: query
// heads of one kv head held per warp. U rows are loaded before they are
// used, to keep several loads in flight.
template <int E, int RC, typename CT>
__global__ void __launch_bounds__(32)
attn_split(const float* __restrict__ qkvf, const CT* __restrict__ kc,
           const CT* __restrict__ vc, const float* __restrict__ ks,
           const float* __restrict__ vs, const int* __restrict__ vl_ptr,
           int nh, int nkv, int hd, int T, int window, float scale,
           float* __restrict__ part_m, float* __restrict__ part_l,
           float* __restrict__ part_acc) {
  constexpr int U = E >= 8 ? 2 : 4;
  const int rep = nh / nkv;
  const int nchunks = (rep + RC - 1) / RC;
  const int chunk = blockIdx.x % nchunks;
  const int bg = blockIdx.x / nchunks;  // b * nkv + g
  const int b = bg / nkv, g = bg % nkv;
  const int split = blockIdx.y, nsplit = gridDim.y;
  const int lane = threadIdx.x;
  const int r0 = chunk * RC;
  const int nr = min(RC, rep - r0);
  // rows idx < vl, and idx > vl - window when a window is set
  const int vl = min(*vl_ptr, T);
  const int lo = window > 0 ? max(0, vl - window + 1) : 0;
  const int n = max(0, vl - lo);
  const int per = (n + nsplit - 1) / nsplit;
  const int t0 = lo + split * per;
  const int t1 = min(vl, t0 + per);
  const int nt = nh + 2 * nkv;

  float q[RC][E];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      q[r][i] = (r < nr && d < hd)
                    ? qkvf[((size_t)b * nt + g * rep + r0 + r) * hd + d]
                    : 0.0f;
    }
  }
  float m[RC], l[RC], acc[RC][E];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < E; ++i) acc[r][i] = 0.0f;
  }
  const size_t base = (size_t)bg * T;
  for (int t = t0; t < t1; t += U) {
    float kf[U][E], vf[U][E], ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = t + u < t1;
      const size_t row = (base + t + u) * hd;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int d = lane + 32 * i;
        kf[u][i] = (ok && d < hd) ? to_f(kc[row + d]) : 0.0f;
        vf[u][i] = (ok && d < hd) ? to_f(vc[row + d]) : 0.0f;
      }
      ksc[u] = (ks != nullptr && ok) ? ks[base + t + u] : 1.0f;
      vsc[u] = (vs != nullptr && ok) ? vs[base + t + u] : 1.0f;
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
        for (int i = 0; i < E; ++i) part = fmaf(q[r][i], kf[u][i], part);
        s[u] = (warp_sum(part) * scale) * ksc[u];
        if (t + u < t1) mx = fmaxf(mx, s[u]);
      }
      const float corr = expf(m[r] - mx);  // 0 while m[r] is -inf
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < E; ++i) acc[r][i] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = t + u < t1 ? expf(s[u] - mx) : 0.0f;
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
    const size_t idx =
        ((size_t)b * nh + g * rep + r0 + r) * nsplit + split;
    if (lane == 0) {
      part_m[idx] = m[r];
      part_l[idx] = l[r];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int d = lane + 32 * i;
      if (d < hd) part_acc[idx * hd + d] = acc[r][i];
    }
  }
}

// grid (nh, B), block hd rounded up to whole warps: thread d owns output
// dim d of one query head of one row.
__global__ void attn_combine(const float* __restrict__ qkvf,
                             const float* __restrict__ part_m,
                             const float* __restrict__ part_l,
                             const float* __restrict__ part_acc, int nsplit,
                             int nh, int nkv, int hd, float scale,
                             __nv_bfloat16* __restrict__ og) {
  __shared__ float red[32];
  const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
  const int rep = nh / nkv, g = h / rep, nt = nh + 2 * nkv;
  const float* qrow = qkvf + ((size_t)b * nt + h) * hd;
  const float* krow = qkvf + ((size_t)b * nt + nh + g) * hd;
  const float* vrow = qkvf + ((size_t)b * nt + nh + nkv + g) * hd;
  // the current token's score, q . k_new (the f32 row, not a cache row)
  float v = warp_sum(d < hd ? qrow[d] * krow[d] : 0.0f);
  if ((d & 31) == 0) red[d >> 5] = v;
  __syncthreads();
  if (d < 32) {
    v = warp_sum(d < (int)(blockDim.x >> 5) ? red[d] : 0.0f);
    if (d == 0) red[0] = v;
  }
  __syncthreads();
  const float diag = red[0] * scale;
  if (d >= hd) return;
  const size_t base = ((size_t)b * nh + h) * nsplit;
  float mx = diag;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[base + s]);
  const float pd = expf(diag - mx);
  float l = pd, acc = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float w = expf(part_m[base + s] - mx);  // 0 for an empty split
    l += w * part_l[base + s];
    acc += w * part_acc[(base + s) * hd + d];
  }
  acc += pd * vrow[d];
  og[(size_t)b * nh * hd + (size_t)h * hd + d] = __float2bfloat16(acc / l);
}

template <int E, int RC>
cudaError_t launch_split(bool int8_cache, dim3 grid, cudaStream_t st,
                         const float* qkvf, const void* kc, const void* vc,
                         const float* ks, const float* vs, const int* vl,
                         int nh, int nkv, int hd, int T, int window,
                         float scale, float* pm, float* pl, float* pacc) {
  if (int8_cache) {
    attn_split<E, RC, int8_t><<<grid, 32, 0, st>>>(
        qkvf, static_cast<const int8_t*>(kc), static_cast<const int8_t*>(vc),
        ks, vs, vl, nh, nkv, hd, T, window, scale, pm, pl, pacc);
  } else {
    attn_split<E, RC, __nv_bfloat16><<<grid, 32, 0, st>>>(
        qkvf, static_cast<const __nv_bfloat16*>(kc),
        static_cast<const __nv_bfloat16*>(vc), ks, vs, vl, nh, nkv, hd, T,
        window, scale, pm, pl, pacc);
  }
  return cudaGetLastError();
}

template <int E>
cudaError_t launch_split_rc(int rc, bool int8_cache, dim3 grid,
                            cudaStream_t st, const float* qkvf,
                            const void* kc, const void* vc, const float* ks,
                            const float* vs, const int* vl, int nh, int nkv,
                            int hd, int T, int window, float scale, float* pm,
                            float* pl, float* pacc) {
  switch (rc) {
    case 8:
      return launch_split<E, 8>(int8_cache, grid, st, qkvf, kc, vc, ks, vs,
                                vl, nh, nkv, hd, T, window, scale, pm, pl,
                                pacc);
    case 4:
      return launch_split<E, 4>(int8_cache, grid, st, qkvf, kc, vc, ks, vs,
                                vl, nh, nkv, hd, T, window, scale, pm, pl,
                                pacc);
    case 2:
      return launch_split<E, 2>(int8_cache, grid, st, qkvf, kc, vc, ks, vs,
                                vl, nh, nkv, hd, T, window, scale, pm, pl,
                                pacc);
    default:
      return launch_split<E, 1>(int8_cache, grid, st, qkvf, kc, vc, ks, vs,
                                vl, nh, nkv, hd, T, window, scale, pm, pl,
                                pacc);
  }
}

}  // namespace

// x bf16 [B, H]; qkv and o in the port's int4 layout (w4a16_common.cuh),
// bias_q f32 [>= (nh + 2 nkv) hd] or null; kc/vc [B, nkv, T, hd] bf16 or
// int8 with ks/vs f32 [B, nkv, T]; cos/sin f32 [B or 1, hd/2] (cs_stride 0
// broadcasts one row); vl int32 [1] on the device. Outputs: y bf16 [B, No]
// (no o bias), k_new / v_new [B, nkv, hd] (f32 when int8_cache, else bf16).
// Scratch: og bf16 [B, nh hd]; ws_q f32 [splits_q, B, Nq]; qkvf f32
// [B, nh + 2 nkv, hd]; part_m / part_l f32 [B, nh, kv_splits]; part_acc f32
// [B, nh, kv_splits, hd]; ws_o f32 [splits_o, B, No] when splits_o > 1.
extern "C" int fused_attn_step(
    const void* x, const void* qw_q, const void* sc_q, const void* qz_q,
    const void* bias_q, const void* qw_o, const void* sc_o, const void* qz_o,
    const void* kc, const void* vc, const void* ks, const void* vs,
    const void* cos_t, const void* sin_t, const void* vl, void* y,
    void* k_new, void* v_new, void* og, void* ws_q, void* qkvf, void* part_m,
    void* part_l, void* part_acc, void* ws_o, int B, int H, int Nq, int No,
    int nh, int nkv, int hd, int T, int gs_q, int gs_o, int splits_q,
    int splits_o, int kv_splits, int window, int cs_stride, int int8_cache,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsq = static_cast<float*>(ws_q);
  float* qf = static_cast<float*>(qkvf);
  cudaError_t err = awq::launch_gemv_partial(x, qw_q, sc_q, qz_q, nullptr,
                                             wsq, B, H, Nq, gs_q, splits_q,
                                             st);
  if (err != cudaSuccess) return static_cast<int>(err);
  qkv_finish<<<dim3(nh + 2 * nkv, B), hd / 2, 0, st>>>(
      wsq, splits_q, B, Nq, static_cast<const float*>(bias_q),
      static_cast<const float*>(cos_t), static_cast<const float*>(sin_t),
      cs_stride, nh, nkv, hd, qf, k_new, v_new, int8_cache);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int rep = nh / nkv;
  const int rc = rep > 4 ? 8 : (rep > 2 ? 4 : rep);
  const dim3 grid(B * nkv * ((rep + rc - 1) / rc), kv_splits);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pacc = static_cast<float*>(part_acc);
  auto* ksf = static_cast<const float*>(ks);
  auto* vsf = static_cast<const float*>(vs);
  auto* vli = static_cast<const int*>(vl);
  const bool i8 = int8_cache != 0;
  if (hd <= 64) {
    err = launch_split_rc<2>(rc, i8, grid, st, qf, kc, vc, ksf, vsf, vli, nh,
                             nkv, hd, T, window, scale, pm, pl, pacc);
  } else if (hd <= 128) {
    err = launch_split_rc<4>(rc, i8, grid, st, qf, kc, vc, ksf, vsf, vli, nh,
                             nkv, hd, T, window, scale, pm, pl, pacc);
  } else {
    err = launch_split_rc<8>(rc, i8, grid, st, qf, kc, vc, ksf, vsf, vli, nh,
                             nkv, hd, T, window, scale, pm, pl, pacc);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  attn_combine<<<dim3(nh, B), ((hd + 31) / 32) * 32, 0, st>>>(
      qf, pm, pl, pacc, kv_splits, nh, nkv, hd, scale,
      static_cast<__nv_bfloat16*>(og));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(awq::launch_gemv(og, qw_o, sc_o, qz_o, y, ws_o, B,
                                           nh * hd, No, gs_o, splits_o, st));
}
