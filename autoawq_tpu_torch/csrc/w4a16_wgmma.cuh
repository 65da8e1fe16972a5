// The pipelined tensor-core body of K2 (w4a16_gemm.cu) and of K6's prefill
// instance (moe_gemm.cu), sm_90a.
//
// The block computes a 128-column by TOK-row tile (K2: TOK = 256 or 128;
// K6: 16, 32, 64 or 128, the smallest that holds a token block) of
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
// == 0 (the port's loaders pad other widths once).
//
// A Tile names the block's rows [m0, m_end) and columns n0.. and the first
// row of its weight matrix in the packed, scale and zero-point maps: 0 for
// K2; for K6 the block's expert e in maps over the stacked [E * K/8, N],
// [E * G, N] and [E * ceil(G/8), N] (a K-major box of 8 packed rows never
// leaves the expert, K/8 being a multiple of 8; the second scale or zero
// row of a box at an expert's end, or a step's half past K, may belong to
// expert e + 1, and only multiplies x columns past K, which TMA fills
// with zeros). Rows of x past m_end (another block's, in K6) are read but
// never stored.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include "wgmma.cuh"

namespace awq {

__device__ __forceinline__ float nibble(uint32_t w, int i) {
  return static_cast<float>((w >> (4 * i)) & 0xFu);
}

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

struct Tile {
  int m0, m_end, n0;
  int w_row0, s_row0, z_row0;  // first rows of the weight in the maps
};

// The producer: fill stage t % STAGES with K step t's tiles for every t,
// each once the consumers have released the stage's previous step.
template <int TOK>
__device__ __forceinline__ void produce(const Params& p, const CUtensorMap* tx,
                                        const CUtensorMap* tw,
                                        const CUtensorMap* ts,
                                        const CUtensorMap* tz, uint32_t base,
                                        uint32_t full, uint32_t empty,
                                        const Tile& tile, int T) {
  using L = Layout<TOK>;
  const uint32_t bytes = L::X + L::W + L::S + (p.zeros ? L::Z : 0);
  for (int t = 0; t < T; ++t) {
    const int s = t % STAGES;
    if (t >= STAGES) hop::mbar_wait(empty + 8 * s, (t / STAGES - 1) & 1);
    const uint32_t st = base + s * L::STAGE;
    const uint32_t bar = full + 8 * s;
    const int k0 = t * BK, g0 = k0 / p.gs;
    hop::mbar_arrive_expect_tx(bar, bytes);
    hop::tma_load_2d(st, tx, k0, tile.m0, bar);
    hop::tma_load_2d(st + L::X, tw, tile.n0, tile.w_row0 + k0 / 8, bar);
    hop::tma_load_2d(st + L::X + L::W, ts, tile.n0, tile.s_row0 + g0, bar);
    if (p.zeros)
      hop::tma_load_2d(st + L::X + L::W + L::S, tz, tile.n0,
                       tile.z_row0 + (g0 >> 3), bar);
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
    if constexpr (TOK == 16) hop::wgmma_rs_n16_k(acc, a[s], db);
    if constexpr (TOK == 32) hop::wgmma_rs_n32_k(acc, a[s], db);
    if constexpr (TOK == 64) hop::wgmma_rs_n64_k(acc, a[s], db);
    if constexpr (TOK == 128) hop::wgmma_rs_n128_k(acc, a[s], db);
    if constexpr (TOK == 256) hop::wgmma_rs_n256_k(acc, a[s], db);
  }
}

// The block's tile (row tile mi of num_m, column tile ni of num_n): blocks
// are numbered so that a group of RASTER_M row tiles walks the column
// tiles together (their x rows stay in L2 while each weight tile is read
// once per group; in K6 neighbouring token blocks mostly share an expert).
__device__ __forceinline__ void tile_of(int bid, int num_m, int num_n,
                                        int& mi, int& ni) {
  const int per_group = RASTER_M * num_n;
  const int first_m = (bid / per_group) * RASTER_M;
  const int gm = min(num_m - first_m, RASTER_M);
  const int in_group = bid % per_group;
  mi = first_m + in_group % gm;
  ni = in_group / gm;
}

// The consumers (threads 0-255): A fragments dequantized in registers,
// double-buffered across K steps, wgmmas against the stage's x tile, and
// the tile's transpose stored to y.
template <int TOK>
__device__ __forceinline__ void consume(const Params& p, uint8_t* base,
                                        uint32_t full, uint32_t empty,
                                        const Tile& tile, int T) {
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
      const int n = tile.n0 + c + 8 * (i >> 1);
      const int m = tile.m0 + 8 * j + 2 * (lane & 3) + (i & 1);
      if (m < tile.m_end && n < p.N)
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
                                           uint8_t* smem, const Tile& tile) {
  using L = Layout<TOK>;
  const int tid = threadIdx.x;

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
      produce<TOK>(p, tx, tw, ts, tz, base_sa, full, empty, tile, T);
  } else {
    hop::regs_inc<232>();
    consume<TOK>(p, base, full, empty, tile, T);
  }
}

// Host side: a 2-D tensor map over a row-major [rows, cols] array (cols
// innermost), boxes of [box_rows, box_cols]; out-of-bounds elements read
// as zeros.
inline bool map_2d(CUtensorMap* m, CUtensorMapDataType type, int elem_bytes,
                   const void* base, long long rows, int cols, int box_rows,
                   int box_cols, CUtensorMapSwizzle swizzle) {
  auto fn = hop::tensor_map_encoder();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                       static_cast<cuuint32_t>(box_rows)};
  cuuint32_t steps[2] = {1, 1};
  return fn(m, type, 2, const_cast<void*>(base), dims, strides, box, steps,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The four maps of a call: x [rows, K] in boxes of [TOK, BK] (128-byte
// swizzle), packed weights [w_rows, N], scales [s_rows, N] and zero
// points [z_rows, N] in boxes of [BK / 8, BN], [2, BN], [2, BN].
inline bool maps(int tok, const void* x, long long rows, int K,
                 const void* qw, long long w_rows, const void* sc,
                 long long s_rows, const void* qz, long long z_rows, int N,
                 CUtensorMap* tx, CUtensorMap* tw, CUtensorMap* ts,
                 CUtensorMap* tz) {
  bool ok = map_2d(tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, rows, K, tok,
                   BK, CU_TENSOR_MAP_SWIZZLE_128B) &&
            map_2d(tw, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qw, w_rows, N,
                   BK / 8, BN, CU_TENSOR_MAP_SWIZZLE_NONE) &&
            map_2d(ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sc, s_rows, N, 2,
                   BN, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (ok && qz != nullptr)
    ok = map_2d(tz, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, qz, z_rows, N, 2, BN,
                CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    *tz = *tw;  // unread
  return ok;
}

}  // namespace wg
}  // namespace awq
