// K4: causal prefill attention, out = softmax(q k^T * scale + causal) v,
// GQA by index. q [B, S, nh, hd], k/v [B, S, nkv, hd] bf16 (the token
// stride may exceed heads * hd, so slices of a fused qkv output need no
// copy); out [B, S, nh * hd] bf16, the convention of _flash_prefill.
//
// Replaces jax's stock TPU flash_attention as reached from
// autoawq_tpu/nn/modules.py::_flash_prefill (prefill with s >= 128).
//
// Bound on the H100: operations from S of about 512 (4 * S^2 / 2 * hd
// flops per head against 2 * S * hd * 4 bytes), bytes below.
//
// Design: flash attention on the tensor cores (the structure of
// FlashAttention-3 without its warp specialisation or ping-pong). One
// warpgroup (128 threads) per block owns 64 query rows of one head; the
// blocks of the longest causal rows are issued first (the q tile runs in
// reverse order of blockIdx.z, the grid's slowest axis). The block walks
// 64-key tiles of its kv head (h / (nh / nkv), no repeat materialized) up
// to the diagonal through a 2-stage cp.async ring, so tile j + 1's copy
// overlaps tile j's products. Per tile: S = Q K^T with wgmma m64n64k16 (Q
// and K from shared memory, 128-byte swizzle, f32 accumulators in
// registers); the causal mask only on the diagonal tile; the online
// softmax in registers with exp2 and the scale folded in; P rounded to
// bf16 (as the twin rounds its probabilities) and fed from registers as
// the A operand of O += P V (wgmma m64n{hd}k16, V read MN-major from the
// same swizzled tile layout as K). Instances: hd 64, 128 and 256 (Q plus
// two stages of K and V: 40, 80 and 160 KB of dynamic shared memory). The
// wrapper zero-pads any other head dim up to the next instance (exact, as
// _flash_prefill pads to a multiple of 64).
//
// Given an `lse` pointer, the kernel also writes each row's f32
// log-sum-exp of scale * q.k over its causal keys, [B, nh, S] (natural
// log), which the backward (csrc/prefill_attention_bwd.cu, K10 and K11)
// reads to recompute P; `out` is computed the same way with or without it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;   // query rows per block (one warpgroup)
constexpr int BKV = 64;  // keys per tile

template <int HD>
struct Smem {
  static constexpr int Q = BQ * HD * 2;
  static constexpr int KV = BKV * HD * 2;  // one K or V tile
  static constexpr int BYTES = Q + 4 * KV + 1024;
};

// PV's wgmma at the head dim's width.
template <int HD>
__device__ __forceinline__ void pv_wgmma(float (&o)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db);
template <>
__device__ __forceinline__ void pv_wgmma<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  hop::wgmma_rs_n64_mn(o, a, db);
}
template <>
__device__ __forceinline__ void pv_wgmma<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  hop::wgmma_rs_n128_mn(o, a, db);
}
template <>
__device__ __forceinline__ void pv_wgmma<256>(float (&o)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  hop::wgmma_rs_n256_mn(o, a, db);
}

// Copy `rows` token rows of hd values (row r at src + r * tok; rows past
// `valid` are zero-filled) into a 128-byte-swizzled tile.
template <int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long tok, int valid, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / 128; ++i) {
    const int idx = tid + 128 * i;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < valid;
    hop::cp_async16(dst + hop::swz(r, 8 * c, ROWS),
                    ok ? src + r * tok + 8 * c : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(128)
prefill_attn_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ lse, int S, int NH, int NKV,
                    long long q_tok, long long k_tok, long long v_tok,
                    float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (hop::smem_addr(smem_raw) + 1023) & ~static_cast<uint32_t>(1023);
  using SM = Smem<HD>;
  const uint32_t q_sa = base;
  const uint32_t kv_sa = base + SM::Q;  // stage st: K, then V

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
  const int kvh = h / (NH / NKV);
  const int q0 = qt * BQ;

  const __nv_bfloat16* kb = k + (long long)b * S * k_tok + kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * S * v_tok + kvh * HD;
  load_rows<HD, BQ>(q_sa, q + ((long long)b * S + q0) * q_tok + h * HD,
                    q_tok, S - q0, tid);
  load_rows<HD, BKV>(kv_sa, kb, k_tok, S, tid);
  load_rows<HD, BKV>(kv_sa + SM::KV, vb, v_tok, S, tid);
  hop::cp_async_commit();

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_run[2] = {0.0f, 0.0f};  // this thread's share of the row sums
  const int row0 = q0 + warp * 16 + (lane >> 2);  // and row0 + 8

  const int n_tiles = qt + 1;  // key tiles up to the diagonal
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t k_sa = kv_sa + (j & 1) * 2 * SM::KV;
    const uint32_t v_sa = k_sa + SM::KV;
    hop::cp_async_wait<0>();
    hop::fence_proxy_async();
    __syncthreads();  // tile j landed; every thread is done with tile j - 1
    if (j + 1 < n_tiles) {
      const uint32_t nk = kv_sa + ((j + 1) & 1) * 2 * SM::KV;
      const int k1 = (j + 1) * BKV;
      load_rows<HD, BKV>(nk, kb + k1 * k_tok, k_tok, S - k1, tid);
      load_rows<HD, BKV>(nk + SM::KV, vb + k1 * v_tok, v_tok, S - k1, tid);
    }
    hop::cp_async_commit();

    float s[32];
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 64 * 128 + (kk & 3) * 32;
      hop::wgmma_ss_n64(s, hop::desc_sw128(q_sa + off, 16, 1024),
                        hop::desc_sw128(k_sa + off, 16, 1024), kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    if (j == qt) {  // the diagonal tile: keys past the row (or past S)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = j * BKV + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
        const int row = row0 + ((i >> 1) & 1) * 8;
        if (key > row) s[i] = -CUDART_INF_F;
      }
    }
    // online softmax; rows row0 (i % 4 < 2) and row0 + 8 (i % 4 >= 2), each
    // shared by the 4 threads of a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m_run[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        mx = fmaxf(mx, s[4 * c + 2 * r] * scale_log2);
        mx = fmaxf(mx, s[4 * c + 2 * r + 1] * scale_log2);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = exp2f(m_run[r] - mx);
      m_run[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * r + e;
          s[i] = exp2f(fmaf(s[i], scale_log2, -mx));
          sum += s[i];
        }
      }
      l_run[r] = l_run[r] * corr[r] + sum;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= corr[(i >> 1) & 1];

    // P as wgmma's A fragments: key block kc (16 keys) = column blocks
    // 2kc, 2kc + 1 of the S accumulator
    uint32_t pa[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      pa[kc][0] = hop::pack_bf16(s[8 * kc + 0], s[8 * kc + 1]);
      pa[kc][1] = hop::pack_bf16(s[8 * kc + 2], s[8 * kc + 3]);
      pa[kc][2] = hop::pack_bf16(s[8 * kc + 4], s[8 * kc + 5]);
      pa[kc][3] = hop::pack_bf16(s[8 * kc + 6], s[8 * kc + 7]);
    }
    hop::fence_regs(o);
    hop::wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
      pv_wgmma<HD>(o, pa[kc],
                   hop::desc_sw128(v_sa + kc * 2048, BKV * 128, 1024));
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = 1.0f / l;
    const int row = row0 + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && row < S)  // m_run is log2
      lse[((long long)b * NH + h) * S + row] =
          (m_run[r] + log2f(l)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= S) continue;
    __nv_bfloat16* op = out + (((long long)b * S + row) * NH + h) * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) {
      const int col = 8 * c + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(
          o[4 * c + 2 * r] * inv[r], o[4 * c + 2 * r + 1] * inv[r]);
    }
  }
}

template <int HD>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, float* lse, int B,
           int S, int NH, int NKV, long long q_tok, long long k_tok,
           long long v_tok, float scale_log2, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        prefill_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<HD>::BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  dim3 grid(NH, B, (S + BQ - 1) / BQ);
  prefill_attn_kernel<HD><<<grid, 128, Smem<HD>::BYTES, st>>>(
      q, k, v, out, lse, S, NH, NKV, q_tok, k_tok, v_tok, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int prefill_attention(const void* q, const void* k, const void* v,
                                 void* out, void* lse, int B, int S, int NH,
                                 int NKV, int HD, long long q_tok,
                                 long long k_tok, long long v_tok,
                                 float scale, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;  // exp -> exp2
  auto* qb = static_cast<const __nv_bfloat16*>(q);
  auto* kb = static_cast<const __nv_bfloat16*>(k);
  auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* lb = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64)
    return launch<64>(qb, kb, vb, ob, lb, B, S, NH, NKV, q_tok, k_tok, v_tok,
                      scale_log2, st);
  if (HD == 128)
    return launch<128>(qb, kb, vb, ob, lb, B, S, NH, NKV, q_tok, k_tok, v_tok,
                       scale_log2, st);
  if (HD == 256)
    return launch<256>(qb, kb, vb, ob, lb, B, S, NH, NKV, q_tok, k_tok, v_tok,
                       scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
