// The pipelined tensor-core body of K2 (w4a16_gemm.cu), sm_90a.
//
// The block computes a 128-column by TOK-row tile (TOK = 256 or 128) of
// y = x @ dequant(W) as its transpose, y^T = dequant(W)^T x^T, so that the
// dequantized weights are wgmma's A operand, which may come from
// registers: they never touch shared memory. Two consumer warpgroups own
// 64 weight columns each (232 registers a thread, taken from the producer
// with setmaxnreg); one thread of a producer warpgroup fills a ring of
// STAGES = 4 shared-memory stages with TMA, K walked BK = 64 deep: per
// stage the x tile [TOK, 64] (bf16, 128-byte swizzle: wgmma's K-major B
// layout; rows past M and columns past K arrive as zeros), the packed
// weight tile [8, 128] (int32, a quarter of the bytes of bf16) and the
// scale and zero-point rows of the (at most two) quantization groups the
// stage touches, all completing on the stage's "full" mbarrier. The producer
// refills a stage once both warpgroups have arrived on its "empty"
// mbarrier.
//
// Per K step a consumer thread loads the packed words of its two weight
// columns from shared memory and dequantizes exactly the 32 values its A
// fragments hold ((q - z) * s in f32, then rounded to bf16, as the plain
// twin does): nibbles become floats by a byte permute under the exponent
// bits (2^23 + q, minus 2^23 + z: q - z exactly). Then 4 wgmma
// m64nTOKk16 (A from registers, f32 accumulators). Each dequantized value
// serves TOK rows of x. The fragments are double-buffered in registers:
// step t + 1 is dequantized while step t's wgmmas run. The warpgroups
// never wait for each other.
//
// The A fragment of m64k16 (that of mma.m16n8k16 per warp): thread
// (warp w, lane l) holds rows 16w + l/4 and +8 (here: weight columns) at
// k = 2(l%4) + {0, 1} and + 8; the pair at k, k + 1 is nibbles 2(l%4) and
// 2(l%4) + 1 of one packed word.
//
// Ragged edges: TMA zero-fills rows past M, columns past N and K past K
// (K is a multiple of the group size, so packed rows past K fall in
// groups past G, whose scales arrive as zeros); stores are masked. Group
// sizes are multiples of 32, so each 32-row half of a step lies in one
// group: g = (k0 + 32 h) / gs for half h. TMA needs 16-byte rows: N % 4
// == 0 (the wrapper pads other widths).
#pragma once

#include <cuda.h>

#include "w4a16_common.cuh"
#include "wgmma.cuh"

namespace awq {
namespace wg {

constexpr int BN = 128;  // weight columns a block (64 a warpgroup)
constexpr int BK = 64;
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int RASTER_M = 16;  // token tiles a group of blocks walks N with

template <int TOK>
struct Layout {
  static constexpr int X = TOK * BK * 2;        // x tile, swizzled
  static constexpr int W = (BK / 8) * BN * 4;   // packed weight tile
  static constexpr int S = 2 * BN * 4;          // two scale rows
  static constexpr int Z = 2 * BN * 4;          // two zero-point word rows
  static constexpr int STAGE = X + W + S + Z;
  static constexpr int BARS = STAGES * STAGE;   // mbarriers
  static constexpr int SMEM = BARS + 2 * STAGES * 8 + 1024;
  static_assert(STAGE % 1024 == 0, "stages must keep 1024-byte atoms");
};

struct Params {
  __nv_bfloat16* out;
  int M, K, N, gs;
  int zeros;  // qzeros given (else the zero point is 8)
};

// The producer: fill stage t % STAGES with K step t's tiles for every t,
// each once the consumers have released the stage's previous step.
template <int TOK>
__device__ __forceinline__ void produce(const Params& p, const CUtensorMap* tx,
                                        const CUtensorMap* tw,
                                        const CUtensorMap* ts,
                                        const CUtensorMap* tz, uint32_t base,
                                        uint32_t full, uint32_t empty, int m0,
                                        int n0, int T) {
  using L = Layout<TOK>;
  const uint32_t bytes = L::X + L::W + L::S + (p.zeros ? L::Z : 0);
  for (int t = 0; t < T; ++t) {
    const int s = t % STAGES;
    if (t >= STAGES) hop::mbar_wait(empty + 8 * s, (t / STAGES - 1) & 1);
    const uint32_t st = base + s * L::STAGE;
    const uint32_t bar = full + 8 * s;
    const int k0 = t * BK, g0 = k0 / p.gs;
    hop::mbar_arrive_expect_tx(bar, bytes);
    hop::tma_load_2d(st, tx, k0, m0, bar);
    hop::tma_load_2d(st + L::X, tw, n0, k0 / 8, bar);
    hop::tma_load_2d(st + L::X + L::W, ts, n0, g0, bar);
    if (p.zeros)
      hop::tma_load_2d(st + L::X + L::W + L::S, tz, n0, g0 >> 3, bar);
  }
}

// The thread's A fragments of K step t (stage at generic pointer `st`):
// a[s] for k16 block s, from packed rows 2s (k 16s..) and 2s + 1 (k 16s +
// 8..) of weight columns c and c + 8 (c relative to the block's n0).
template <int TOK>
__device__ __forceinline__ void dequant_frags(const Params& p,
                                              const uint8_t* st, int t, int c,
                                              uint32_t sel,
                                              uint32_t (&a)[4][4]) {
  using L = Layout<TOK>;
  const int32_t* w_sm = reinterpret_cast<const int32_t*>(st + L::X);
  const float* s_sm = reinterpret_cast<const float*>(st + L::X + L::W);
  const int32_t* z_sm =
      reinterpret_cast<const int32_t*>(st + L::X + L::W + L::S);
  const int k0 = t * BK, g0 = k0 / p.gs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // k16 blocks 2h, 2h + 1: one group
    const int g = (k0 + 32 * h) / p.gs;
    const int js = g - g0, jz = (g >> 3) - (g0 >> 3);
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // columns c and c + 8
      const int n = c + 8 * e;
      const float s = s_sm[js * BN + n];
      // 2^23 + z, exact
      const float big_z =
          8388608.0f +
          (p.zeros ? nibble(static_cast<uint32_t>(z_sm[jz * BN + n]), g & 7)
                   : 8.0f);
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // packed rows 4h .. 4h + 3
        const int r = 4 * h + q;
        const uint32_t w = static_cast<uint32_t>(w_sm[r * BN + n]);
        const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
        const float v0 =
            (__uint_as_float(__byte_perm(lo, 0x4B000000u, sel)) - big_z) * s;
        const float v1 =
            (__uint_as_float(__byte_perm(hi, 0x4B000000u, sel)) - big_z) * s;
        // row r: k16 block r / 2, registers {0, 1} (r even) or {2, 3}
        a[r >> 1][2 * (r & 1) + e] = hop::pack_bf16(v0, v1);
      }
    }
  }
}

// Keep fragment registers alive and in place until the wgmmas reading
// them have completed.
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int TOK>
__device__ __forceinline__ void wgmma_step(float (&acc)[TOK / 2],
                                           const uint32_t (&a)[4][4],
                                           uint32_t x_sa) {
#pragma unroll
  for (int s = 0; s < BK / 16; ++s) {
    const uint64_t db = hop::desc_sw128(x_sa + 32 * s, 16, 1024);
    if constexpr (TOK == 128) hop::wgmma_rs_n128_k(acc, a[s], db);
    if constexpr (TOK == 256) hop::wgmma_rs_n256_k(acc, a[s], db);
  }
}

// The block's tile: blocks are numbered so that a group of RASTER_M token
// tiles walks the column tiles together (their x rows stay in L2 while
// each weight tile is read once per group).
template <int TOK>
__device__ __forceinline__ void tile_of(int bid, int M, int N, int& m0,
                                        int& n0) {
  const int num_m = (M + TOK - 1) / TOK, num_n = (N + BN - 1) / BN;
  const int per_group = RASTER_M * num_n;
  const int first_m = (bid / per_group) * RASTER_M;
  const int gm = min(num_m - first_m, RASTER_M);
  const int in_group = bid % per_group;
  m0 = (first_m + in_group % gm) * TOK;
  n0 = (in_group / gm) * BN;
}

// The consumers (threads 0-255): A fragments dequantized in registers,
// double-buffered across K steps, wgmmas against the stage's x tile, and
// the tile's transpose stored to y.
template <int TOK>
__device__ __forceinline__ void consume(const Params& p, uint8_t* base,
                                        uint32_t full, uint32_t empty, int m0,
                                        int n0, int T) {
  using L = Layout<TOK>;
  const int tid = threadIdx.x;
  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const bool leader = (tid & 127) == 0;
  const int c = 64 * wgi + 16 * warp + (lane >> 2);  // and c + 8
  const uint32_t sel = 0x7650u + (lane & 3);  // byte l%4 under 0x4B
  auto stage = [&](int t) { return base + (t % STAGES) * L::STAGE; };
  auto wait_full = [&](int t) {
    hop::mbar_wait(full + 8 * (t % STAGES), (t / STAGES) & 1);
  };

  float acc[TOK / 2];
#pragma unroll
  for (int i = 0; i < TOK / 2; ++i) acc[i] = 0.0f;
  hop::fence_regs(acc);
  uint32_t a0[4][4], a1[4][4];  // fragments of even and odd steps
  wait_full(0);
  dequant_frags<TOK>(p, stage(0), 0, c, sel, a0);

  // (acc is not touched between the wgmmas: an instruction writing it
  // while one is in flight would make ptxas serialize them)
  for (int t = 0; t < T; t += 2) {
    hop::wgmma_fence();
    wgmma_step<TOK>(acc, a0, hop::smem_addr(stage(t)));
    hop::wgmma_commit();
    if (t + 1 < T) {
      wait_full(t + 1);
      dequant_frags<TOK>(p, stage(t + 1), t + 1, c, sel, a1);
    }
    hop::wgmma_wait<0>();
    fence_frags(a0);
    if (leader) hop::mbar_arrive(empty + 8 * (t % STAGES));
    if (t + 1 >= T) break;

    hop::wgmma_fence();
    wgmma_step<TOK>(acc, a1, hop::smem_addr(stage(t + 1)));
    hop::wgmma_commit();
    if (t + 2 < T) {
      wait_full(t + 2);
      dequant_frags<TOK>(p, stage(t + 2), t + 2, c, sel, a0);
    }
    hop::wgmma_wait<0>();
    fence_frags(a1);
    if (leader) hop::mbar_arrive(empty + 8 * ((t + 1) % STAGES));
  }
  hop::fence_regs(acc);

  // acc holds y^T: row (weight column) c or c + 8, column (token)
  // 8j + 2(l%4) + {0, 1}
#pragma unroll
  for (int j = 0; j < TOK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + c + 8 * (i >> 1);
      const int m = m0 + 8 * j + 2 * (lane & 3) + (i & 1);
      if (m < p.M && n < p.N)
        p.out[(size_t)m * p.N + n] = __float2bfloat16(acc[4 * j + i]);
    }
  }
}

template <int TOK>
__device__ __forceinline__ void gemm_block(const Params& p,
                                           const CUtensorMap* tx,
                                           const CUtensorMap* tw,
                                           const CUtensorMap* ts,
                                           const CUtensorMap* tz,
                                           uint8_t* smem) {
  using L = Layout<TOK>;
  const int tid = threadIdx.x;
  int m0, n0;
  tile_of<TOK>(blockIdx.x, p.M, p.N, m0, n0);

  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~uintptr_t(1023));
  const uint32_t base_sa = hop::smem_addr(base);
  const uint32_t full = base_sa + L::BARS;   // STAGES mbarriers
  const uint32_t empty = full + 8 * STAGES;  // STAGES mbarriers
  const int T = (p.K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hop::mbar_init(full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, CONSUMERS / 128);  // one a warpgroup
    }
    hop::mbar_init_fence();
  }
  __syncthreads();
  // The roles never meet again, so each warpgroup takes its own register
  // budget (the launch gives all 384 threads 168): the producer hands its
  // share to the consumers' accumulators and fragments.
  if (tid >= CONSUMERS) {
    hop::regs_dec<40>();
    if (tid == CONSUMERS)
      produce<TOK>(p, tx, tw, ts, tz, base_sa, full, empty, m0, n0, T);
  } else {
    hop::regs_inc<232>();
    consume<TOK>(p, base, full, empty, m0, n0, T);
  }
}

}  // namespace wg
}  // namespace awq
