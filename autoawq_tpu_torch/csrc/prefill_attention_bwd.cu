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
// a fused qkv output need no copy; base and token stride 16-byte aligned,
// as TMA needs); dO [B, S, nh, hd] bf16 dense; dq [B, S, nh, hd], dk/dv
// [B, S, nkv, hd] bf16 dense, each element written once, no atomics (two
// calls give equal bits). Head dims 64, 128 and 256 (the wrapper zero-pads
// others, as the forward does).
//
// Bound on the H100: operations. K10 does four matmuls over the causal
// half of each (query, key) square (S^T = K Q^T, dV += P^T dO,
// dP^T = V dO^T, dK += dS^T Q), K11 three (S, dP, dQ): at traffic W's step
// (B=4, S=512, 32/8 heads, hd 128) 17.4 and 13.0 us of tensor-core time
// against ~59 MB of inputs and outputs (17.7 us at 3.35 TB/s) for K11.
//
// Design (FlashAttention-3's backward structure on Hopper, sm_90a): every
// product on wgmma (bf16 operands from 128-byte-swizzled shared tiles, or
// K11's dS from registers; f32 accumulators in registers); every streamed
// tile by TMA through 4-D tensor maps over (hd, heads, S, B) with the
// token stride, so rows past S arrive as zeros; one producer warp keeps a
// ring of stages full on mbarriers while two consumer warpgroups compute
// (288 threads, at most 224 registers each); and a causal schedule in
// which every CTA (K10) or work item (K11) does the same work.
// * K10: a CTA per (kv head, batch, key-tile pair): key tile p, then its
//   mirror nq - 1 - p, so each CTA walks rep * (nq + 1) (head, query tile)
//   steps (the longest CTA of the old grid walked twice the mean). For
//   each key tile the producer loads K and V once and streams (Q, dO, the
//   rows' LSE and D) for every query head of the GQA group and every
//   query tile at or after the key tile through a 4-stage ring (2 at hd
//   256). The keys are wgmma's M rows, and the two warpgroups split
//   each step's four products between them (FlashAttention-3's exchange):
//   warpgroup 0 computes S^T = K Q^T, writes bf16 P^T to shared memory
//   and accumulates dV += P^T dO; warpgroup 1 computes dP^T = V dO^T,
//   reads P^T, writes bf16 dS^T and accumulates dK += dS^T Q. S^T and
//   dP^T are SS m64n64k16 over the head dim (K or V as A, Q or dO as B,
//   both K-major); dV and dK are SS m64n{hd}k16 with the bf16 tile as A
//   and dO or Q read MN-major. Each thread holds one accumulator (hd / 2
//   f32) and one 64 x 64 product: the measured choice over keeping dK and
//   dV in every thread and splitting the steps (which needs 128 f32 of
//   accumulators at hd 128, spilled, and had ptxas serialize the
//   wgmmas), with no reduction at the end of a key tile and no product
//   computed twice at hd 256. Summing the GQA group inside the CTA needs
//   no atomics: it is the VJP of the jnp.repeat the JAX package applies
//   before the stock kernel. At W's shape the TMA stream alone takes ~55%
//   of K10's time; the rest is the step's chain (S^T, P^T, the hand-over,
//   dS^T). Its parallelism is nkv * B * nq / 2 CTAs, so a small group
//   count (TinyLlama's 4 kv heads at B = 2) leaves SMs idle.
// * K11: work items of (head, batch, query-tile pair): a 128-row query
//   tile and its mirror (64 rows at hd 256), which levels the causal work
//   as in K10, walked by one persistent CTA per SM. Two consumer
//   warpgroups take 64 rows each, so every K / V tile streamed feeds 128
//   rows (one warpgroup at hd 256, where 128 rows of Q and dO leave no
//   room for the ring). Q, dO and the rows' LSE and D are loaded once a
//   pass, into two buffers, the next pass's a pass ahead (one buffer at
//   hd 256); (K, V) tiles up to the diagonal stream
//   through a 3-stage ring (4 at hd 64, 2 at hd 256). S and dP are SS
//   m64n64k16, dS in bf16 registers is the A operand of dQ += dS K
//   (m64n{hd}k16, K read MN-major). Measured at W's shape, the TMA stream
//   alone (no products; build with -DBWD_STREAM_ONLY) takes ~3/4 of the
//   kernel's time: K11 is bound by moving K and V to the SMs more than by
//   its products. K and V, which the other items re-read, are loaded
//   with an L2 evict-last hint and Q and dO with evict-first (K10: the
//   reverse).
// P^T (or P) and dS are rounded to bf16 for the tensor cores, as K4
// rounds P (dS^T from the bf16 P^T in K10); sums stay f32. In K10 each
// warpgroup's last product of a step runs while it waits for the next
// step's first; in both the two warpgroups fill each other's gaps. (K11
// does not pipeline its own steps: S and dP kept in flight across the
// loop's back edge behind the dQ product, waited for by a partial wgmma
// wait, made ptxas serialize every wgmma (C7515), as does a wgmma issued
// under a branch (C7520); both measured slower.)
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr int BR = 64;  // rows of every tile (queries or keys)
constexpr float LOG2E = 1.4426950408889634f;
// Two consumer warpgroups and one producer warp: 288 threads, so every
// thread may hold 224 registers (65,536 / 288, rounded down to 8) without
// setmaxnreg, which ptxas does not count on when it allocates.
constexpr int THREADS = 256 + 32;

// mbarrier wait for the phase of the given parity that traps after ~10 s
// of spinning, so a fault in the ring's protocol ends the launch with an
// error instead of holding the card.
__device__ __forceinline__ void wait_bar(uint32_t bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

// 2^x for the softmax's exponentials: the instruction exp2f ends in,
// without its denormal handling (P below 2^-126 flushes to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Descriptor of k16 step kk over rows row0.. of a K-major swizzled tile of
// `rows` rows (column blocks of 64 head dims, rows * 128 bytes apart).
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row0,
                                           int kk) {
  return hop::desc_sw128(
      tile + (kk >> 2) * rows * 128 + row0 * 128 + (kk & 3) * 32, 16, 1024);
}

// acc[64 x 64] = X Y^T over the head dim: 64 rows of X from row x0 of an
// x_rows tile, against the 64 rows of tile Y.
template <int HD>
__device__ __forceinline__ void ss_product(float (&acc)[32], uint32_t x,
                                           int x_rows, int x0, uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hop::wgmma_ss_n64(acc, kmajor(x, x_rows, x0, kk), kmajor(y, BR, 0, kk),
                      kk > 0);
}

// acc[64 x N] += A Z: A's k16 chunk c is frag[c]; Z is a 64-row swizzled
// tile read MN-major, columns d0..d0+N-1 (d0 a multiple of 64).
template <int N>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2],
                                           const uint32_t (&frag)[4][4],
                                           uint32_t z, int d0) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint64_t db =
        hop::desc_sw128(z + (d0 / 64) * BR * 128 + c * 2048, BR * 128, 1024);
    if constexpr (N == 64) hop::wgmma_rs_n64_mn(acc, frag[c], db);
    if constexpr (N == 128) hop::wgmma_rs_n128_mn(acc, frag[c], db);
    if constexpr (N == 256) hop::wgmma_rs_n256_mn(acc, frag[c], db);
  }
}

// The bf16 A fragments of a 64 x 64 f32 accumulator (k16 chunk c = its
// column blocks 2c and 2c + 1).
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4],
                                         const float (&x)[32]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    f[c][0] = hop::pack_bf16(x[8 * c + 0], x[8 * c + 1]);
    f[c][1] = hop::pack_bf16(x[8 * c + 2], x[8 * c + 3]);
    f[c][2] = hop::pack_bf16(x[8 * c + 4], x[8 * c + 5]);
    f[c][3] = hop::pack_bf16(x[8 * c + 6], x[8 * c + 7]);
  }
}

__device__ __forceinline__ void fence_frags(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f[c][i])::"memory");
}

// Write a 64 x N accumulator (times `mul`) as bf16 to rows 0..63 of a
// dense output with `tok` elements a row, columns d0.., rows at or past
// `valid` skipped.
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* out, long long tok,
                                          int valid, int d0,
                                          const float (&acc)[N / 2],
                                          float mul, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * warp + (lane >> 2) + 8 * r;
    if (row >= valid) continue;
    __nv_bfloat16* op = out + row * tok + d0 + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * mul, acc[4 * j + 2 * r + 1] * mul);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.0f;
}

// TMA: rows r0.. of head `head`, batch b of a [B, S, heads, HD] tensor
// (map m, boxes of [rows, 64]) into a swizzled tile of `rows` rows, with
// an L2 hint: `keep` for a tile other CTAs will read again (evict last),
// else evict first.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          int rows, int head, int r0, int b,
                                          uint32_t bar, bool keep) {
  uint64_t pol;
  if (keep)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
                 : "=l"(pol));
  else
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                 : "=l"(pol));
#pragma unroll
  for (int cb = 0; cb < HD / 64; ++cb)
    hop::tma_load_4d(dst + cb * rows * 128, m, 64 * cb, head, r0, b, bar,
                     pol);
}

// The producer warp's part of a rows stage: `n` rows from r0 of the [B,
// nh, S] LSE and D into f32 arrays at shared address `out` and `out + 4n`
// (zeros past `valid`) by 4-byte cp.async; each lane's arrival on `bar`
// fires when its copies have landed, so the warp never waits on them.
__device__ __forceinline__ void load_rows(uint32_t out, const float* lse,
                                          const float* delta, long long r0,
                                          int n, int valid, int lane,
                                          uint32_t bar) {
  for (int r = lane; r < n; r += 32) {
    const bool ok = r < valid;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     out + 4 * r),
                 "l"(ok ? lse + r0 + r : lse), "r"(ok ? 4 : 0)
                 : "memory");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     out + 4 * (n + r)),
                 "l"(ok ? delta + r0 + r : delta), "r"(ok ? 4 : 0)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}

// ------------------------------------------------------------------ K10

template <int HD>
struct Dkv {
  static constexpr int STAGES = HD > 128 ? 2 : 4;
  static constexpr int TILE = BR * HD * 2;
  static constexpr int STAGE = 2 * TILE + 1024;  // Q, dO, LSE, D
  static constexpr int RING = 2 * TILE;          // after K and V
  static constexpr int XP = RING + STAGES * STAGE;  // bf16 P^T, 2 buffers
  static constexpr int XDS = XP + 2 * BR * BR * 2;  // bf16 dS^T
  static constexpr int BARS = XDS + BR * BR * 2;
  static constexpr int BYTES = BARS + 128;  // and the barriers
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

// dX[64 x HD] += A B: A a bf16 64 x 64 tile (keys x queries) in shared
// memory, swizzled K-major; B the stage's 64-query Q or dO tile read
// MN-major (head dims contiguous).
template <int HD>
__device__ __forceinline__ void xs_product(float (&acc)[HD / 2], uint32_t a,
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = kmajor(a, BR, 0, kk);
    const uint64_t db = hop::desc_sw128(b + kk * 2048, BR * 128, 1024);
    if constexpr (HD == 64) hop::wgmma_ss_n64_bmn(acc, da, db, 1);
    if constexpr (HD == 128) hop::wgmma_ss_n128_bmn(acc, da, db, 1);
    if constexpr (HD == 256) hop::wgmma_ss_n256_bmn(acc, da, db, 1);
  }
}

// Where this thread's accumulator pair (j, r) of a 64 x 64 product sits in
// a swizzled bf16 tile: row 16w + l/4 + 8r, columns 8j + 2(l%4) + {0, 1}.
__device__ __forceinline__ uint32_t pair_at(int warp, int lane, int j,
                                            int r) {
  return hop::swz(16 * warp + (lane >> 2) + 8 * r, 8 * j + 2 * (lane & 3),
                  BR);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkv_kernel(const __grid_constant__ CUtensorMap mq,
           const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv,
           const __grid_constant__ CUtensorMap mdo,
           const float* __restrict__ lse, const float* __restrict__ delta,
           __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
           int S, int NH, int NKV, float scale, float scale_log2) {
  using C = Dkv<HD>;
  extern __shared__ __align__(1024) uint8_t sm[];
  if (hop::smem_addr(sm) & 1023) __trap();  // the swizzle needs 1024 B
  const uint32_t base = hop::smem_addr(sm);
  const uint32_t k_sa = base, v_sa = base + C::TILE, ring = base + C::RING;
  const uint32_t full = base + C::BARS, empty = full + 8 * C::STAGES;
  const uint32_t kv_full = empty + 8 * C::STAGES, kv_empty = kv_full + 8;

  const int tid = threadIdx.x, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int rep = NH / NKV;
  const int nq = (S + BR - 1) / BR;  // query tiles = key tiles
  const int n_pass = p == nq - 1 - p ? 1 : 2;  // key tile p, then its mirror

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(full + 8 * s, 1 + 32);  // the TMA arrival, 32 lanes'
      hop::mbar_init(empty + 8 * s, 2);      // both warpgroups
    }
    hop::mbar_init(kv_full, 1);
    hop::mbar_init(kv_empty, 2);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp
    int g = 0;  // steps issued so far (the ring's position)
    for (int t = 0; t < n_pass; ++t) {
      const int kt = t == 0 ? p : nq - 1 - p;
      if (t > 0) wait_bar(kv_empty, 0);
      if (lane == 0) {
        hop::mbar_arrive_expect_tx(kv_full, 2 * C::TILE);
        load_tile<HD>(k_sa, &mk, BR, kvh, kt * BR, b, kv_full, false);
        load_tile<HD>(v_sa, &mv, BR, kvh, kt * BR, b, kv_full, false);
      }
      const int per_head = nq - kt;
      for (int i = 0; i < rep * per_head; ++i, ++g) {
        const int s = g % C::STAGES;
        if (g >= C::STAGES)
          wait_bar(empty + 8 * s, (g / C::STAGES - 1) & 1);
        const int h = kvh * rep + i / per_head;
        const int q0 = (kt + i % per_head) * BR;
        const uint32_t st = ring + s * C::STAGE;
        if (lane == 0) {
          hop::mbar_arrive_expect_tx(full + 8 * s, 2 * C::TILE);
          load_tile<HD>(st, &mq, BR, h, q0, b, full + 8 * s, true);
          load_tile<HD>(st + C::TILE, &mdo, BR, h, q0, b, full + 8 * s,
                        true);
        }
        load_rows(st + 2 * C::TILE, lse, delta,
                  ((long long)b * NH + h) * S + q0, BR, S - q0, lane,
                  full + 8 * s);
      }
    }
    return;
  }

  // Warpgroup 0: S^T = K Q^T, P^T (bf16, to shared memory), dV += P^T dO.
  // Warpgroup 1: dP^T = V dO^T, dS^T = P^T * (dP^T - D) (bf16, to shared
  // memory), dK += dS^T Q. Barrier 1 (both) hands P^T over each step;
  // barrier 2 (warpgroup 1) publishes dS^T to its own wgmma. Each
  // warpgroup's last product of a step is waited for at its next step's
  // first wait, so it overlaps the other warpgroup's work.
  const int wg = tid >> 7, t128 = tid & 127, warp = t128 >> 5;
  const long long kv_tok = (long long)NKV * HD;
  const uint32_t xds = base + C::XDS;
  int g0 = 0;  // ring position of the pass's first step
  for (int t = 0; t < n_pass; ++t) {
    const int kt = t == 0 ? p : nq - 1 - p;
    const int k0 = kt * BR, per_head = nq - kt, n_it = rep * per_head;
    const int key = k0 + 16 * warp + (lane >> 2);  // and key + 8
    float acc[HD / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
    zero(acc);
    wait_bar(kv_full, t & 1);
    for (int i = 0; i < n_it; ++i) {
      const int g = g0 + i, s = g % C::STAGES;
      const uint32_t qs = ring + s * C::STAGE, dos = qs + C::TILE;
      const float* rows =
          reinterpret_cast<const float*>(sm + (qs - base) + 2 * C::TILE);
      const uint32_t xp = base + C::XP + (g & 1) * BR * BR * 2;
      const int q0 = (kt + i % per_head) * BR;
      float sd[32];
      wait_bar(full + 8 * s, g / C::STAGES & 1);
#ifdef BWD_STREAM_ONLY
      if (t128 == 0) hop::mbar_arrive(empty + 8 * s);
      continue;
#endif
      hop::wgmma_fence();
      ss_product<HD>(sd, wg == 0 ? k_sa : v_sa, BR, 0, wg == 0 ? qs : dos);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();  // this product and the step before's
      hop::fence_regs(sd);
      hop::fence_regs(acc);
      if (i > 0 && t128 == 0)
        hop::mbar_arrive(empty + 8 * ((g - 1) % C::STAGES));
      if (wg == 0) {
        // P^T = exp2(S^T * scale * log2 e - LSE * log2 e), causal; query
        // 8j + 2(l%4) + e of the tile at sd[4j + 2r + e], key + 8r
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int qc = 8 * j + 2 * (lane & 3);
          float2 l2 = *reinterpret_cast<const float2*>(rows + qc);
          l2.x *= LOG2E;
          l2.y *= LOG2E;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float pv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int q = q0 + qc + e;
              const bool dead = q >= S || key + 8 * r > q;
              pv[e] = dead ? 0.0f
                           : ex2(fmaf(sd[4 * j + 2 * r + e], scale_log2,
                                        e ? -l2.y : -l2.x));
            }
            *reinterpret_cast<uint32_t*>(sm + (xp - base) +
                                         pair_at(warp, lane, j, r)) =
                hop::pack_bf16(pv[0], pv[1]);
          }
        }
        hop::fence_proxy_async();
      }
      hop::named_sync(1, 256);  // P^T ready
      if (wg == 1) {
        // dS^T = P^T * (dP^T - D), P^T as warpgroup 0 rounded it
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 dd = *reinterpret_cast<const float2*>(
              rows + BR + 8 * j + 2 * (lane & 3));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const uint32_t at = pair_at(warp, lane, j, r);
            const float2 pt = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(sm + (xp - base) +
                                                         at));
            *reinterpret_cast<uint32_t*>(sm + C::XDS + at) = hop::pack_bf16(
                pt.x * (sd[4 * j + 2 * r] - dd.x),
                pt.y * (sd[4 * j + 2 * r + 1] - dd.y));
          }
        }
        hop::fence_proxy_async();
        hop::named_sync(2, 128);  // dS^T written by all four warps
      }
      // dV += P^T dO (warpgroup 0), dK += dS^T Q (warpgroup 1); no wgmma
      // under a branch, which would make ptxas serialize them
      hop::wgmma_fence();
      xs_product<HD>(acc, wg == 0 ? xp : xds, wg == 0 ? dos : qs);
      hop::wgmma_commit();
    }
    hop::wgmma_wait<0>();
    hop::fence_regs(acc);
#ifndef BWD_STREAM_ONLY
    if (n_it > 0 && t128 == 0)
      hop::mbar_arrive(empty + 8 * ((g0 + n_it - 1) % C::STAGES));
#endif
    g0 += n_it;
    __nv_bfloat16* out =
        (wg == 0 ? dv : dk) + ((long long)b * S + k0) * kv_tok + kvh * HD;
    store_acc<HD>(out, kv_tok, S - k0, 0, acc, wg == 0 ? 1.0f : scale, warp,
                  lane);
    if (t128 == 0) hop::mbar_arrive(kv_empty);  // K and V free
  }
}

// ------------------------------------------------------------------ K11

template <int HD>
struct Dq {
  static constexpr int NWG = HD > 128 ? 1 : 2;  // consumer warpgroups
  static constexpr int QR = BR * NWG;           // query rows a pass
  static constexpr int THREADS = 128 * NWG + 32;  // and the producer warp
  static constexpr int QBUF = HD > 128 ? 1 : 2;   // Q / dO buffers
  static constexpr int STAGES = HD == 64 ? 4 : HD == 128 ? 3 : 2;
  static constexpr int TILE = BR * HD * 2;  // one K or V tile
  static constexpr int QT = QR * HD * 2;    // Q or dO
  static constexpr int ROWS = QBUF * 2 * QT;  // LSE, D of each buffer
  static constexpr int RING = ROWS + QBUF * 1024;
  static constexpr int BARS = RING + STAGES * 2 * TILE;
  static constexpr int BYTES = BARS + 128;  // and the barriers
  static_assert(BYTES <= 232448, "over the 227 KB a block may use");
};

// A persistent CTA per SM walks work items (head, batch, query-tile pair)
// blockIdx.x, + gridDim.x, ...; each item is one or two passes (tile p,
// then its mirror), and the producer loads pass n + 1's Q and dO into the
// other buffer while the consumers work on pass n.
template <int HD>
__global__ void __launch_bounds__(Dq<HD>::THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap mdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int B, int S, int NH, int NKV,
          float scale, float scale_log2) {
  using C = Dq<HD>;
  extern __shared__ __align__(1024) uint8_t sm[];
  if (hop::smem_addr(sm) & 1023) __trap();  // the swizzle needs 1024 B
  const uint32_t base = hop::smem_addr(sm);
  const uint32_t ring = base + C::RING;
  const uint32_t full = base + C::BARS, empty = full + 8 * C::STAGES;
  const uint32_t q_full = empty + 8 * C::STAGES;
  const uint32_t q_empty = q_full + 8 * C::QBUF;
  // pass n's buffer: Q, dO, then its rows
  auto q_at = [&](int n) { return base + n % C::QBUF * 2 * C::QT; };
  auto rows_at = [&](int n) { return C::ROWS + n % C::QBUF * 1024; };

  const int tid = threadIdx.x, lane = tid & 31;
  const int rep = NH / NKV;
  const int nk = (S + BR - 1) / BR;
  const int np = (S + C::QR - 1) / C::QR;  // query tiles of QR rows
  const int pairs = (np + 1) / 2, n_work = NH * B * pairs;
  auto tiles_of = [&](int q0) { return min((q0 + C::QR) / BR, nk); };

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      hop::mbar_init(full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, C::NWG);
    }
    for (int q = 0; q < C::QBUF; ++q) {
      hop::mbar_init(q_full + 8 * q, 1 + 32);  // the TMA arrival, 32 lanes'
      hop::mbar_init(q_empty + 8 * q, C::NWG);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 128 * C::NWG) {  // the producer warp
    // pass n's Q, dO and rows into buffer n % QBUF; with two buffers pass
    // n + 1's are issued right after pass n's first key tile, a pass ahead
    auto load_q = [&](int w, int t, int n) {
      const int p = w % pairs, h = w / pairs % NH, b = w / pairs / NH;
      const int q0 = (t == 0 ? p : np - 1 - p) * C::QR;
      const uint32_t qf = q_full + 8 * (n % C::QBUF);
      if (n >= C::QBUF)
        wait_bar(q_empty + 8 * (n % C::QBUF), (n / C::QBUF - 1) & 1);
      if (lane == 0) {
        hop::mbar_arrive_expect_tx(qf, 2 * C::QT);
        load_tile<HD>(q_at(n), &mq, C::QR, h, q0, b, qf, false);
        load_tile<HD>(q_at(n) + C::QT, &mdo, C::QR, h, q0, b, qf, false);
      }
      load_rows(base + rows_at(n), lse, delta,
                ((long long)b * NH + h) * S + q0, C::QR, S - q0, lane, qf);
    };
    int g = 0, n = 0;  // key tiles and passes issued so far
    if (blockIdx.x < n_work) load_q(blockIdx.x, 0, 0);
    for (int w = blockIdx.x, t = 0; w < n_work; ++n) {
      const int p = w % pairs, h = w / pairs % NH, b = w / pairs / NH;
      const int kvh = h / rep;
      const int q0 = (t == 0 ? p : np - 1 - p) * C::QR;
      int wn = w, tn = t;  // the next pass
      if (t == 0 && p != np - 1 - p) {
        tn = 1;
      } else {
        wn += gridDim.x;
        tn = 0;
      }
      for (int j = 0; j < tiles_of(q0); ++j, ++g) {
        const int s = g % C::STAGES;
        if (g >= C::STAGES)
          wait_bar(empty + 8 * s, (g / C::STAGES - 1) & 1);
        if (lane == 0) {
          const uint32_t ks = ring + s * 2 * C::TILE;
          hop::mbar_arrive_expect_tx(full + 8 * s, 2 * C::TILE);
          load_tile<HD>(ks, &mk, BR, kvh, j * BR, b, full + 8 * s, true);
          load_tile<HD>(ks + C::TILE, &mv, BR, kvh, j * BR, b,
                        full + 8 * s, true);
        }
        if (C::QBUF > 1 && j == 0 && wn < n_work) load_q(wn, tn, n + 1);
      }
      // one buffer: the next pass's Q waits for this pass to end
      if (C::QBUF == 1 && wn < n_work) load_q(wn, tn, n + 1);
      w = wn;
      t = tn;
    }
    return;
  }

  const int wg = tid >> 7, t128 = tid & 127, warp = t128 >> 5;
  const long long dtok = (long long)NH * HD;
  int g0 = 0, n = 0;
  for (int w = blockIdx.x; w < n_work; w += gridDim.x) {
    const int p = w % pairs, h = w / pairs % NH, b = w / pairs / NH;
    for (int t = 0; t < (p == np - 1 - p ? 1 : 2); ++t, ++n) {
      const int q0 = (t == 0 ? p : np - 1 - p) * C::QR;
      const int qw = q0 + 64 * wg;  // this warpgroup's first row
      const int r_lo = 64 * wg + 16 * warp + (lane >> 2);  // and r_lo + 8
      const bool live = qw < S;
      const int diag = qw / BR, n_tiles = tiles_of(q0);
      const uint32_t q_sa = q_at(n), do_sa = q_sa + C::QT;
      const float* rows = reinterpret_cast<const float*>(sm + rows_at(n));
      wait_bar(q_full + 8 * (n % C::QBUF), n / C::QBUF & 1);
      float lse2[2], dr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = rows[r_lo + 8 * r] * LOG2E;
        dr[r] = rows[C::QR + r_lo + 8 * r];
      }
      float acc[HD / 2];
      zero(acc);
      for (int j = 0; j < n_tiles; ++j) {
        const int g = g0 + j, s = g % C::STAGES;
        const uint32_t ks = ring + s * 2 * C::TILE, vs = ks + C::TILE;
        wait_bar(full + 8 * s, g / C::STAGES & 1);
#ifdef BWD_STREAM_ONLY
        if (false) {
#else
        if (live && j <= diag) {
#endif
          // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each
          float sc[32], dp[32];
          hop::wgmma_fence();
          ss_product<HD>(sc, q_sa, C::QR, 64 * wg, ks);
          hop::wgmma_commit();
          ss_product<HD>(dp, do_sa, C::QR, 64 * wg, vs);
          hop::wgmma_commit();
          hop::wgmma_wait<1>();
          hop::fence_regs(sc);
          // key 8c + 2(l%4) + e of the tile at sc[4c + 2r + e], row + 8r
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = (i >> 1) & 1;
            const int key = j * BR + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
            sc[i] = (j == diag && key > q0 + r_lo + 8 * r)
                        ? 0.0f
                        : ex2(fmaf(sc[i], scale_log2, -lse2[r]));
          }
          hop::wgmma_wait<0>();
          hop::fence_regs(dp);
#pragma unroll
          for (int i = 0; i < 32; ++i)  // dS = P * (dP - D)
            dp[i] = sc[i] * (dp[i] - dr[(i >> 1) & 1]);
          uint32_t fr[4][4];
          to_frags(fr, dp);
          hop::fence_regs(acc);
          hop::wgmma_fence();
          rs_product<HD>(acc, fr, ks, 0);  // dQ += dS K
          hop::wgmma_commit();
          hop::wgmma_wait<0>();
          fence_frags(fr);
          hop::fence_regs(acc);
        }
        if (t128 == 0) hop::mbar_arrive(empty + 8 * s);
      }
      g0 += n_tiles;
      if (t128 == 0) hop::mbar_arrive(q_empty + 8 * (n % C::QBUF));
      if (live)
        store_acc<HD>(dq + ((long long)b * S + qw) * dtok + h * HD, dtok,
                      S - qw, 0, acc, scale, warp, lane);
    }
  }
}

// ----------------------------------------------------------------- host

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done = true;
  return err;
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, S, NH, NKV, HD;
  long long q_tok, k_tok, v_tok;
  float scale;
};

// A 4-D map over a [B, S, heads, HD] bf16 tensor with `tok` elements
// between tokens (dims hd, heads, S, B): boxes of [rows, 64 head dims] of
// one head, 128-byte swizzle, rows past S read as zeros.
bool map_heads(CUtensorMap* m, const void* base, const Args& a, int heads,
               long long tok, int rows) {
  auto fn = hop::tensor_map_encoder();
  if (fn == nullptr) return false;
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(a.HD),
                        static_cast<cuuint64_t>(heads),
                        static_cast<cuuint64_t>(a.S),
                        static_cast<cuuint64_t>(a.B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(a.HD) * 2,
                           static_cast<cuuint64_t>(tok) * 2,
                           static_cast<cuuint64_t>(tok) * 2 * a.S};
  cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  cuuint32_t steps[4] = {1, 1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four maps of a call: q and dO in boxes of q_rows rows, k and v of 64.
bool maps(const Args& a, int q_rows, CUtensorMap* mq, CUtensorMap* mk,
          CUtensorMap* mv, CUtensorMap* mdo) {
  return map_heads(mq, a.q, a, a.NH, a.q_tok, q_rows) &&
         map_heads(mk, a.k, a, a.NKV, a.k_tok, BR) &&
         map_heads(mv, a.v, a, a.NKV, a.v_tok, BR) &&
         map_heads(mdo, a.dout, a, a.NH, (long long)a.NH * a.HD, q_rows);
}

template <int HD>
int launch_dkv(const Args& a, __nv_bfloat16* dk, __nv_bfloat16* dv,
               cudaStream_t st) {
  static bool done = false;
  using C = Dkv<HD>;
  cudaError_t err = allow_smem(dkv_kernel<HD>, C::BYTES, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv, mdo;
  if (!maps(a, BR, &mq, &mk, &mv, &mdo))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nq = (a.S + BR - 1) / BR;
  dim3 grid(a.NKV, a.B, (nq + 1) / 2);  // key tile p and its mirror
  dkv_kernel<HD><<<grid, THREADS, C::BYTES, st>>>(
      mq, mk, mv, mdo, a.lse, a.delta, dk, dv, a.S, a.NH, a.NKV, a.scale,
      a.scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_dq(const Args& a, __nv_bfloat16* dq, cudaStream_t st) {
  static bool done = false;
  using C = Dq<HD>;
  cudaError_t err = allow_smem(dq_kernel<HD>, C::BYTES, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv, mdo;
  if (!maps(a, C::QR, &mq, &mk, &mv, &mdo))
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int np = (a.S + C::QR - 1) / C::QR;
  const int work = a.NH * a.B * ((np + 1) / 2);  // query tile p and mirror
  dq_kernel<HD><<<work < sms ? work : sms, C::THREADS, C::BYTES, st>>>(
      mq, mk, mv, mdo, a.lse, a.delta, dq, a.B, a.S, a.NH, a.NKV, a.scale,
      a.scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, int B, int S, int NH,
               int NKV, int HD, long long q_tok, long long k_tok,
               long long v_tok, float scale) {
  return Args{q, k, v, dout, static_cast<const float*>(lse),
              static_cast<const float*>(delta), B, S, NH, NKV, HD, q_tok,
              k_tok, v_tok, scale};
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
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, NH, NKV, HD,
                           q_tok, k_tok, v_tok, scale);
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
  const Args a = make_args(q, k, v, dout, lse, delta, B, S, NH, NKV, HD,
                           q_tok, k_tok, v_tok, scale);
  auto* dqb = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (HD == 64) return launch_dq<64>(a, dqb, st);
  if (HD == 128) return launch_dq<128>(a, dqb, st);
  if (HD == 256) return launch_dq<256>(a, dqb, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
