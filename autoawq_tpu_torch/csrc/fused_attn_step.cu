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
// wrapper call is four CUDA launches on one stream:
//   1. qkv on the tensor-core GEMV core (w4a16_gemv.cuh) with a pair map:
//      a CTA's columns are rotary pairs, dims j and j + hd/2 of one head (q,
//      k and v heads alike), so after its reduction the tile epilogue
//      (Rope) adds the bias in f32, rotates q and k in f32 (the TPU kernel
//      never rounds q/k/v before RoPE), and writes the f32 rows qkvf
//      [B, nh + 2 nkv, hd] and k_new / v_new (bf16 for a bf16 cache, f32
//      for an int8 one, so the caller quantizes the real rows). Every head
//      dim fits: a head's pairs may spread over CTAs, and no finish pass
//      is needed. The first CTA also stores a host-given valid length to
//      device memory for the launches after it;
//   2. K7's tensor-core split kernel (paged_attn_common.cuh, addressed by
//      DenseAddr): the cache is read as pages of ps rows, splits of spp
//      pages (ops/paged_attn.split_plan); the valid length is read from
//      device memory, so a captured step replays at any position;
//   3. attn_combine: per (row, query head), merges the splits in a fixed
//      order with the current token's diagonal term (from the f32 k and v
//      rows), and rounds the attention output to bf16 (as the TPU kernel
//      casts og_scr to x's type before the o product);
//   4. the o projection, K1's job on the core, to bf16.
// A split whose rows are all masked holds m = -inf and weighs 0 in the
// combine, so vl = 0 gives exactly the diagonal term.
#include "paged_attn_common.cuh"
#include "w4a16_gemv.cuh"

#include <math.h>

namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct RopeArgs {
  const void* bias;  // [>= Nq] bf16 (bias_bf16) or f32, or null
  const float* cos;  // [B or 1, hd/2] (cs_stride 0 broadcasts one row)
  const float* sin;
  float* qkvf;       // [B, nh + 2 nkv, hd]
  void* k_new;       // [B, nkv, hd]
  void* v_new;
  int* vl_dev;       // the valid length the later launches read
  int vl_val;        // >= 0: store it at vl_dev; < 0: vl_dev holds it
  int bias_bf16, cs_stride, kv_f32, nh, nkv, hd;
};

// qkv's tile epilogue: pair p0 + c of the CTA's rows holds dims j and
// j + hd/2 of head p / (hd/2) in columns c and c + half.
struct Rope {
  static constexpr bool TILE = true;
  RopeArgs a;
  int p0, half, m0;
  __device__ __forceinline__ float bias(int col) const {
    if (a.bias == nullptr) return 0.0f;
    return a.bias_bf16
               ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[col])
               : static_cast<const float*>(a.bias)[col];
  }
  __device__ __forceinline__ void finish(const float* red, int rows, int e0,
                                         int step) const {
    const int hh = a.hd / 2, heads = a.nh + 2 * a.nkv;
    for (int q = e0; q < rows * half; q += step) {
      const int r = q / half, c = q % half, p = p0 + c;
      if (p >= heads * hh) continue;
      const int head = p / hh, j = p % hh, b = m0 + r;
      const int col = head * a.hd + j;
      float v0 = red[r * 2 * half + c] + bias(col);
      float v1 = red[r * 2 * half + half + c] + bias(col + hh);
      if (head < a.nh + a.nkv) {  // q and k heads rotate; v heads do not
        const float cs = a.cos[b * a.cs_stride + j];
        const float sn = a.sin[b * a.cs_stride + j];
        const float r0 = v0 * cs - v1 * sn;
        const float r1 = v1 * cs + v0 * sn;
        v0 = r0;
        v1 = r1;
      }
      float* dst = a.qkvf + ((size_t)b * heads + head) * a.hd;
      dst[j] = v0;
      dst[j + hh] = v1;
      if (head >= a.nh) {
        const int g = head - a.nh;
        void* out = g < a.nkv ? a.k_new : a.v_new;
        const size_t o = ((size_t)b * a.nkv + g % a.nkv) * a.hd;
        if (a.kv_f32) {
          float* pf = static_cast<float*>(out) + o;
          pf[j] = v0;
          pf[j + hh] = v1;
        } else {
          __nv_bfloat16* pb = static_cast<__nv_bfloat16*>(out) + o;
          pb[j] = __float2bfloat16(v0);
          pb[j + hh] = __float2bfloat16(v1);
        }
      }
    }
    if (a.vl_val >= 0 && p0 == 0 && m0 == 0 && e0 == 0) *a.vl_dev = a.vl_val;
  }
};

struct RopeOut {
  static constexpr bool TRIGGER = false;
  RopeArgs a;
  __device__ Rope at(int p0, int half, int m0) const {
    return {a, p0, half, m0};
  }
};

// The o projection: K1's job, under a name of its own in profiles.
struct OJob : awq::gv::DenseJob {};

// grid (nh, B), block hd rounded up to whole warps: thread d owns output
// dim d of one query head of one row. part: the split kernel's partials,
// acc [B, nh, nsplit, hd] then (m, l) [B, nh, nsplit, 2].
__global__ void attn_combine(const float* __restrict__ qkvf,
                             const float* __restrict__ part, int B,
                             int nsplit, int nh, int nkv, int hd, float scale,
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
  const float* ml = part + (size_t)B * nh * nsplit * hd;
  float mx = diag;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, ml[2 * (base + s)]);
  const float pd = expf(diag - mx);
  float l = pd, acc = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const float ms = ml[2 * (base + s)];
    if (ms == -INFINITY) continue;  // a dead split: its acc is unwritten
    const float w = expf(ms - mx);
    l += w * ml[2 * (base + s) + 1];
    acc += w * part[(base + s) * hd + d];
  }
  acc += pd * vrow[d];
  og[(size_t)b * nh * hd + (size_t)h * hd + d] = __float2bfloat16(acc / l);
}

}  // namespace

// x bf16 [B, H]; qkv and o in the port's int4 layout (w4a16_gemv.cuh),
// bias [>= (nh + 2 nkv) hd] (bf16 when bias_bf16, else f32) or null;
// kc/vc [B, nkv, T, hd] bf16 or int8 with ks/vs f32 [B, nkv, T], 16-byte
// aligned; cos/sin f32 [B or 1, hd/2] (cs_stride 0 broadcasts one row); vl
// a device int32 holding the valid length, or to receive vl_val >= 0.
// Outputs: y bf16 [B, No] (no o bias), k_new / v_new [B, nkv, hd] (f32
// when int8_cache, else bf16). Scratch: og bf16 [B, nh hd]; qkvf f32
// [B, nh + 2 nkv, hd]; part f32 [B * nh * nsplit * (hd + 2)]. nt, cs_q,
// cs_o from ops/gemm.gemv_plan; ps, spp, nsplit from
// ops/fused_attn_step.kv_plan.
extern "C" int fused_attn_step(
    const void* x, const void* qw_q, const void* sc_q, const void* qz_q,
    const void* bias, const void* qw_o, const void* sc_o, const void* qz_o,
    const void* kc, const void* vc, const void* ks, const void* vs,
    const void* cos_t, const void* sin_t, void* vl, void* y, void* k_new,
    void* v_new, void* og, void* qkvf, void* part, int B, int H, int Nq,
    int No, int nh, int nkv, int hd, int T, int gs_q, int gs_o, int nt,
    int cs_q, int cs_o, int ps, int spp, int nsplit, int window,
    int cs_stride, int int8_cache, int bias_bf16, int vl_val, float scale,
    void* stream) {
  using namespace awq::gv;
  if (B < 1 || B > 8 || hd % 8 != 0 || hd > 256 || nkv < 1 || nh % nkv != 0 ||
      Nq % 4 != 0 || No % 4 != 0 || gs_q % 32 != 0 || gs_o % 32 != 0 ||
      H % gs_q != 0 || (nh * hd) % gs_o != 0 || Nq < (nh + 2 * nkv) * hd ||
      ps < 1 || spp < 1 || nsplit < 1 || !plan_ok(nt, 1, cs_q, false) ||
      !plan_ok(nt, 1, cs_o, false))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int hh = hd / 2;
  auto* qw = static_cast<const int32_t*>(qw_q);
  auto* sc = static_cast<const float*>(sc_q);
  auto* qz = static_cast<const int32_t*>(qz_q);
  auto* qf = static_cast<float*>(qkvf);
  const RopeArgs ra{bias, static_cast<const float*>(cos_t),
                    static_cast<const float*>(sin_t), qf, k_new, v_new,
                    static_cast<int*>(vl), vl_val, bias_bf16, cs_stride,
                    int8_cache, nh, nkv, hd};
  const PairJob<RopeOut> qkv{
      static_cast<const __nv_bfloat16*>(x),
      B, H, gs_q, Nq, cs_q,
      Pairs{{qw, qw + hh}, {sc, sc + hh},
            {qz, qz == nullptr ? nullptr : qz + hh},
            (nh + 2 * nkv) * hh, hh, hd, 0, 0},
      RopeOut{ra}};
  cudaError_t err = launch_plan<false>(qkv, nt, 1, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  const paged::SplitArgs a = paged::split_args(
      qf, kc, vc, ks, vs, nullptr, vl, nullptr, part, B, nh, nkv, hd, T, ps,
      (T + ps - 1) / ps, spp, nsplit, window, scale, 0.0f);
  err = int8_cache
            ? paged::launch_split_for<float, int8_t, paged::DenseAddr>(a, st)
            : paged::launch_split_for<float, __nv_bfloat16, paged::DenseAddr>(
                  a, st);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto* ogb = static_cast<__nv_bfloat16*>(og);
  attn_combine<<<dim3(nh, B), ((hd + 31) / 32) * 32, 0, st>>>(
      qf, static_cast<const float*>(part), B, nsplit, nh, nkv, hd, scale,
      ogb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const OJob o{{ogb, static_cast<const int32_t*>(qw_o),
                static_cast<const float*>(sc_o),
                static_cast<const int32_t*>(qz_o),
                static_cast<__nv_bfloat16*>(y), B, nh * hd, No, gs_o, cs_o}};
  return static_cast<int>(launch_plan<false>(o, nt, 1, st));
}
