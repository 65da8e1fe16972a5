// K10 and K11: the backward of causal prefill attention (K4), given the
// forward's output O, its f32 row log-sum-exp LSE [B, nh, S] (natural log of
// the sum over keys of exp(scale * q.k), written by K4 on request) and
// D = rowsum(dO * O) [B, nh, S] (a torch op, as jax computes `di` with jnp
// outside its kernels).
//
//   P  = exp(scale * Q K^T - LSE)          (recomputed, causal)
//   dV = P^T dO                            (K10)
//   dS = P * (dO V^T - D)
//   dK = scale * dS^T Q                    (K10, summed over the GQA group)
//   dQ = scale * dS K                      (K11)
//
// Replace jax's stock TPU kernels _flash_attention_bwd_dkv (K10) and
// _flash_attention_bwd_dq (K11) in jax/experimental/pallas/ops/tpu/
// flash_attention.py, which _flash_attention.defvjp ties to the forward the
// JAX package differentiates whenever it trains through _flash_prefill
// (autoawq_tpu/nn/modules.py:338-360, taken at :723-730).
//
// q [B, S, nh, hd], k/v [B, S, nkv, hd] bf16 with a token stride (slices of
// a fused qkv output need no copy); dO [B, S, nh, hd] bf16 dense; dq
// [B, S, nh, hd], dk/dv [B, S, nkv, hd] bf16 dense. Head dims 64, 128 and
// 256 (the wrapper zero-pads others, as the forward does).
//
// Bound on the H100: operations. K10 does four matmuls over the causal
// half of each (query, key) square (S^T = K Q^T, dV += P^T dO,
// dP^T = V dO^T, dK += dS^T Q), K11 three (S, dP, dQ); at S = 512 and hd
// 128 that is 4 * 2 * S^2/2 * hd flops per head against 2 * S * hd * 2
// bytes per tensor, far above the card's ~295 flops a byte.
//
// Design (FlashAttention-2's backward on mma.sync m16n8k16, bf16 operands
// through ldmatrix from 128-byte-row-swizzled shared tiles, f32
// accumulators in registers; cp.async double buffering, no wgmma or TMA):
// * K10: one CTA per (batch, kv head, 64-key tile) keeps its K and V tiles
//   in shared memory and walks every query head of the GQA group and every
//   64-row query tile at or after its key tile (causal), two stages of (Q,
//   dO, LSE, D) in flight. Warp w owns 16 keys; P^T and dS^T stay in the
//   registers their product left them in and feed dV and dK as A operands.
//   Summing the group inside the CTA needs no atomics: it is the VJP of the
//   jnp.repeat the JAX package applies before the stock kernel. At hd 256
//   the CTA has 8 warps, two per 16 keys, each accumulating half the head
//   dims (so dK and dV fit the registers); both recompute P^T and dP^T.
// * K11: one CTA per (batch, head, 64-row query tile) keeps Q, dO, LSE and D
//   and walks the key tiles at or before its own, two stages of (K, V) in
//   flight; warp w owns 16 query rows.
// Both round P (or P^T) and dS to bf16 for the tensor cores, as K4 rounds
// P; sums stay f32. Blocks with the most causal work are issued first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BR = 64;  // rows of every tile (queries or keys)
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of bf16 element (row, col) in a tile of rows of HD * 2 bytes
// whose 16-byte chunks are swizzled (chunk c of row r at c ^ (r % 8)), so
// the eight rows ldmatrix reads for one chunk fall in eight bank groups.
template <int HD>
__device__ __forceinline__ uint32_t sw(int row, int col) {
  return row * (HD * 2) + ((((col >> 3) ^ (row & 7))) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// C[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 4-byte asynchronous copy global -> shared; pred false writes zeros.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

// Copy 64 token rows of HD values (row r at src + r * tok; rows at or past
// `valid` zero-filled) into a swizzled tile, NT threads.
template <int HD, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long tok, int valid, int tid) {
  constexpr int CPR = HD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < BR * CPR / NT; ++i) {
    const int idx = tid + NT * i;
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < valid;
    hop::cp_async16(dst + sw<HD>(r, 8 * c), ok ? src + r * tok + 8 * c : src,
                    ok);
  }
}

// 64 f32 values (rows at or past `valid` zero-filled).
template <int NT>
__device__ __forceinline__ void load_row(uint32_t dst, const float* src,
                                         int valid, int tid) {
  for (int r = tid; r < BR; r += NT) {
    const bool ok = r < valid;
    cp_async4(dst + 4 * r, ok ? src + r : src, ok);
  }
}

// A 16 x 64 product over the head dim, X Y^T, for this warp's 16 rows of
// tile X (rows x0..x0+15) against all 64 rows of tile Y: acc[8][4] holds
// n8 tile t (Y rows 8t..8t+7) in mma's accumulator layout.
template <int HD>
__device__ __forceinline__ void rows_by_tile(float (&acc)[8][4], uint32_t xs,
                                             int x0, uint32_t ys, int lane) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, xs + sw<HD>(x0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                        kk * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t b[4];
      ldsm(b, ys + sw<HD>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                          kk * 16 + ((lane >> 3) & 1) * 8));
      mma(acc[2 * np], a, b[0], b[1]);
      mma(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc[DH / 8][4] += A[16 x 64] Z[64 x DH] where A's k16 chunk c is the bf16
// fragment set frag[c] (columns 16c..16c+15 of a 16 x 64 accumulator) and Z
// is columns d0..d0+DH-1 of a swizzled tile read transposed.
template <int HD, int DH>
__device__ __forceinline__ void frag_by_tile(float (&acc)[DH / 8][4],
                                             const uint32_t (&frag)[4][4],
                                             uint32_t zs, int d0, int lane) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int n = 0; n < DH / 16; ++n) {
      uint32_t b[4];
      ldsm_t(b, zs + sw<HD>(16 * c + (lane & 7) + ((lane >> 3) & 1) * 8,
                            d0 + n * 16 + (lane >> 4) * 8));
      mma(acc[2 * n], frag[c], b[0], b[1]);
      mma(acc[2 * n + 1], frag[c], b[2], b[3]);
    }
}

// The bf16 A fragments of a 16 x 64 f32 accumulator (k16 chunk c = n8
// tiles 2c and 2c + 1).
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4],
                                         const float (&x)[8][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c][0] = hop::pack_bf16(x[2 * c][0], x[2 * c][1]);
    f[c][1] = hop::pack_bf16(x[2 * c][2], x[2 * c][3]);
    f[c][2] = hop::pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]);
    f[c][3] = hop::pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3]);
  }
}

// Write a 16 x DH accumulator (times `mul`) as bf16 rows r0 and r0 + 8 of
// a dense [rows, stride] output, columns d0.., rows at or past `valid`
// skipped.
template <int DH>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long tok,
                                           int r0, int valid, int d0,
                                           const float (&acc)[DH / 8][4],
                                           float mul, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= valid) continue;
    __nv_bfloat16* op = out + r * tok + d0 + 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * t) = __floats2bfloat162_rn(
          acc[t][2 * h] * mul, acc[t][2 * h + 1] * mul);
  }
}

template <int HD>
struct DkvCfg {
  static constexpr int SPLIT = HD > 128 ? 2 : 1;  // warps per 16 keys
  static constexpr int NT = 128 * SPLIT;
  static constexpr int DH = HD / SPLIT;  // head dims a warp accumulates
  static constexpr int TILE = BR * HD * 2;
  // K, V, then two stages of (Q, dO, LSE, D)
  static constexpr int BYTES = 2 * TILE + 2 * (2 * TILE + 2 * BR * 4) + 128;
};

template <int HD>
__global__ void __launch_bounds__(DkvCfg<HD>::NT)
dkv_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v,
           const __nv_bfloat16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int S, int NH, int NKV, long long q_tok, long long k_tok,
           long long v_tok, float scale, float scale_log2) {
  using C = DkvCfg<HD>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = hop::smem_addr(smem);
  const uint32_t k_sa = base, v_sa = base + C::TILE;
  const uint32_t ring = base + 2 * C::TILE;
  constexpr int STAGE = 2 * C::TILE + 2 * BR * 4;
  const float* rowv = reinterpret_cast<const float*>(smem);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wk = warp & 3;                  // this warp's 16 keys
  const int d0 = (warp >> 2) * C::DH;       // and its head dims
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;                // key tile: early ones work most
  const int k0 = kt * BR;
  const int rep = NH / NKV;
  const int nq = (S + BR - 1) / BR;
  const int per_head = nq - kt;  // query tiles at or after the key tile
  const int n_it = rep * per_head;

  const long long dtok = (long long)NH * HD;  // dO's token stride
  auto fetch = [&](int it, int st) {
    const int h = kvh * rep + it / per_head;
    const int q0 = (kt + it % per_head) * BR;
    const uint32_t s0 = ring + st * STAGE;
    load_tile<HD, C::NT>(s0, q + ((long long)b * S + q0) * q_tok + h * HD,
                         q_tok, S - q0, tid);
    load_tile<HD, C::NT>(s0 + C::TILE,
                         dout + ((long long)b * S + q0) * dtok + h * HD, dtok,
                         S - q0, tid);
    const long long r0 = ((long long)b * NH + h) * S + q0;
    load_row<C::NT>(s0 + 2 * C::TILE, lse + r0, S - q0, tid);
    load_row<C::NT>(s0 + 2 * C::TILE + BR * 4, delta + r0, S - q0, tid);
  };

  load_tile<HD, C::NT>(k_sa, k + ((long long)b * S + k0) * k_tok + kvh * HD,
                       k_tok, S - k0, tid);
  load_tile<HD, C::NT>(v_sa, v + ((long long)b * S + k0) * v_tok + kvh * HD,
                       v_tok, S - k0, tid);
  fetch(0, 0);
  hop::cp_async_commit();

  float dkacc[C::DH / 8][4], dvacc[C::DH / 8][4];
#pragma unroll
  for (int t = 0; t < C::DH / 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) dkacc[t][c] = dvacc[t][c] = 0.0f;
  const int key_lo = k0 + 16 * wk + (lane >> 2);  // and key_lo + 8

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    hop::cp_async_wait<0>();
    __syncthreads();  // stage st landed; every thread is done with st ^ 1
    if (it + 1 < n_it) fetch(it + 1, st ^ 1);
    hop::cp_async_commit();

    const uint32_t qs = ring + st * STAGE, dos = qs + C::TILE;
    const int rw = (ring - base + st * STAGE + 2 * C::TILE) / 4;
    const float* lse_s = rowv + rw;
    const float* d_s = rowv + rw + BR;
    const int q0 = (kt + it % per_head) * BR;

    // P^T = exp(scale * K Q^T - LSE): 16 keys x 64 queries
    float p[8][4];
    rows_by_tile<HD>(p, k_sa, 16 * wk, qs, lane);
    const bool diag = q0 == k0;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qc = 8 * t + 2 * (lane & 3) + (c & 1);
        const int key = key_lo + 8 * (c >> 1);
        const bool dead = q0 + qc >= S || (diag && key > q0 + qc);
        p[t][c] = dead ? 0.0f
                       : exp2f(fmaf(p[t][c], scale_log2, -lse_s[qc] * LOG2E));
      }
    uint32_t fr[4][4];
    to_frags(fr, p);
    frag_by_tile<HD, C::DH>(dvacc, fr, dos, d0, lane);  // dV += P^T dO

    // dS^T = P^T * (V dO^T - D)
    float ds[8][4];
    rows_by_tile<HD>(ds, v_sa, 16 * wk, dos, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[t][c] = p[t][c] * (ds[t][c] - d_s[8 * t + 2 * (lane & 3) + (c & 1)]);
    to_frags(fr, ds);
    frag_by_tile<HD, C::DH>(dkacc, fr, qs, d0, lane);  // dK += dS^T Q
  }

  const long long kv_tok = (long long)NKV * HD;
  const long long out0 = ((long long)b * S + k0) * kv_tok + kvh * HD;
  store_rows<C::DH>(dk + out0, kv_tok, 16 * wk + (lane >> 2), S - k0, d0,
                    dkacc, scale, lane);
  store_rows<C::DH>(dv + out0, kv_tok, 16 * wk + (lane >> 2), S - k0, d0,
                    dvacc, 1.0f, lane);
}

template <int HD>
struct DqCfg {
  static constexpr int TILE = BR * HD * 2;
  // Q, dO, then two stages of (K, V)
  static constexpr int BYTES = 2 * TILE + 2 * 2 * TILE + 128;
};

template <int HD>
__global__ void __launch_bounds__(128)
dq_kernel(const __nv_bfloat16* __restrict__ q,
          const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v,
          const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int S, int NH, int NKV,
          long long q_tok, long long k_tok, long long v_tok, float scale,
          float scale_log2) {
  using C = DqCfg<HD>;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = hop::smem_addr(smem);
  const uint32_t q_sa = base, do_sa = base + C::TILE;
  const uint32_t ring = base + 2 * C::TILE;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;  // longest rows first
  const int q0 = qt * BR;
  const int kvh = h / (NH / NKV);
  const long long dtok = (long long)NH * HD;

  const __nv_bfloat16* kb = k + (long long)b * S * k_tok + kvh * HD;
  const __nv_bfloat16* vb = v + (long long)b * S * v_tok + kvh * HD;
  load_tile<HD, 128>(q_sa, q + ((long long)b * S + q0) * q_tok + h * HD,
                     q_tok, S - q0, tid);
  load_tile<HD, 128>(do_sa, dout + ((long long)b * S + q0) * dtok + h * HD,
                     dtok, S - q0, tid);
  load_tile<HD, 128>(ring, kb, k_tok, S, tid);
  load_tile<HD, 128>(ring + C::TILE, vb, v_tok, S, tid);
  hop::cp_async_commit();

  // this thread's two rows: their LSE (as log2) and D
  const int r_lo = 16 * warp + (lane >> 2);
  float lse2[2], dr[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r_lo + 8 * hh;
    const long long i = ((long long)b * NH + h) * S + row;
    lse2[hh] = row < S ? lse[i] * LOG2E : 0.0f;
    dr[hh] = row < S ? delta[i] : 0.0f;
  }

  float acc[HD / 8][4];
#pragma unroll
  for (int t = 0; t < HD / 8; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.0f;

  const int n_tiles = qt + 1;  // key tiles up to the diagonal
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t ks = ring + (j & 1) * 2 * C::TILE, vs = ks + C::TILE;
    hop::cp_async_wait<0>();
    __syncthreads();  // tile j landed; every thread is done with tile j - 1
    if (j + 1 < n_tiles) {
      const uint32_t nk = ring + ((j + 1) & 1) * 2 * C::TILE;
      const int k1 = (j + 1) * BR;
      load_tile<HD, 128>(nk, kb + k1 * k_tok, k_tok, S - k1, tid);
      load_tile<HD, 128>(nk + C::TILE, vb + k1 * v_tok, v_tok, S - k1, tid);
    }
    hop::cp_async_commit();

    // P = exp(scale * Q K^T - LSE): 16 rows x 64 keys
    float p[8][4];
    rows_by_tile<HD>(p, q_sa, 16 * warp, ks, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = j * BR + 8 * t + 2 * (lane & 3) + (c & 1);
        const int row = q0 + r_lo + 8 * (c >> 1);
        p[t][c] = (j == qt && key > row)
                      ? 0.0f
                      : exp2f(fmaf(p[t][c], scale_log2, -lse2[c >> 1]));
      }
    // dS = P * (dO V^T - D)
    float ds[8][4];
    rows_by_tile<HD>(ds, do_sa, 16 * warp, vs, lane);
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ds[t][c] = p[t][c] * (ds[t][c] - dr[c >> 1]);
    uint32_t fr[4][4];
    to_frags(fr, ds);
    frag_by_tile<HD, HD>(acc, fr, ks, 0, lane);  // dQ += dS K
  }

  store_rows<HD>(dq + ((long long)b * S + q0) * dtok + h * HD, dtok, r_lo,
                 S - q0, 0, acc, scale, lane);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, NH, NKV;
  long long q_tok, k_tok, v_tok;
  float scale;
};

template <int HD>
int launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv,
               cudaStream_t st) {
  static bool done = false;
  using C = DkvCfg<HD>;
  cudaError_t err = allow_smem(dkv_kernel<HD>, C::BYTES, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.NKV, a.B, (a.S + BR - 1) / BR);
  dkv_kernel<HD><<<grid, C::NT, C::BYTES, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dk, dv, a.S, a.NH, a.NKV,
      a.q_tok, a.k_tok, a.v_tok, a.scale, a.scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const Args& a, __nv_bfloat16* dq, cudaStream_t st) {
  static bool done = false;
  using C = DqCfg<HD>;
  cudaError_t err = allow_smem(dq_kernel<HD>, C::BYTES, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.NH, a.B, (a.S + BR - 1) / BR);
  dq_kernel<HD><<<grid, 128, C::BYTES, st>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, dq, a.S, a.NH, a.NKV, a.q_tok,
      a.k_tok, a.v_tok, a.scale, a.scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int S, int NH,
               int NKV, long long q_tok, long long k_tok, long long v_tok,
               float scale) {
  return Args{static_cast<const __nv_bfloat16*>(q),
              static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v),
              static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta),
              B, S, NH, NKV, q_tok, k_tok, v_tok, scale};
}

}  // namespace

// K10: dK, dV [B, S, nkv, hd] bf16.
extern "C" int prefill_attention_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int B, int S, int NH,
                                     int NKV, int HD, long long q_tok,
                                     long long k_tok, long long v_tok,
                                     float scale, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, NH, NKV, q_tok,
                           k_tok, v_tok, scale);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64) return launch_dkv<64>(a, dkb, dvb, st);
  if (HD == 128) return launch_dkv<128>(a, dkb, dvb, st);
  if (HD == 256) return launch_dkv<256>(a, dkb, dvb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11: dQ [B, S, nh, hd] bf16.
extern "C" int prefill_attention_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int B, int S, int NH, int NKV,
                                    int HD, long long q_tok, long long k_tok,
                                    long long v_tok, float scale,
                                    void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, NH, NKV, q_tok,
                           k_tok, v_tok, scale);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64) return launch_dq<64>(a, dqb, st);
  if (HD == 128) return launch_dq<128>(a, dqb, st);
  if (HD == 256) return launch_dq<256>(a, dqb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
