// The tensor-core GEMV core of K1 (w4a16_gemv.cu), K6's decode instance
// (moe_gemm.cu), both passes of K3 and K8 (fused_mlp_common.cuh) and K5's
// qkv and o (fused_attn_step.cu), sm_90a. A column map places the CTA's
// columns (Dense: consecutive; Pairs: a first half and its partners, so
// an epilogue sees both members of a pair) and an epilogue of the
// caller's choosing takes the reduced f32 sums (StoreBf16, or a tile
// epilogue that reads the CTA's whole tile); Jobs bundle both per launch.
//
// Weight layout (core/packing.py): qweight int32 [K/8, N], nibble i of word
// (r, n) is element (8r + i, n); zero points int32 [ceil(G/8), N] packed
// the same way along G (null: symmetric, zero point 8); scales f32 [G, N].
// x and y are bf16, row-major.
//
// A CTA of 8 warps computes 32 CS weight columns of y = x @ dequant(W) for
// 32 RG rows of x (CS x RG = 1 x 1 below 17 rows, then 4 x 1, 1 x 2,
// 2 x 4, 1 x 8 up to 256 rows) as the transpose y^T = dequant(W)^T x^T,
// so that the weight is mma.sync.m16n8k16's A operand and the rows of x
// its n8 tiles: each weight word is read from memory once per call for
// all the CTA's rows. Warp (cs, rg, kh) owns 32 columns, 32 rows (at most
// 4 n8 tiles) and slice kh of the CTA's K range (8 / (CS RG) slices); a
// cluster of up to 8 CTAs splits K first. (Tried on the H100 and slower:
// staging CTA-wide tiles with a barrier a stage, and warps of 128 columns
// reading each other's pieces; PERF.md.)
//
// Loads: each lane copies its own 16-byte weight words (4 columns of one
// packed row) and x pieces with cp.async into its warp's ring of DEPTH
// stages in shared memory, DEPTH - 1 chunks ahead, and reads back only
// what it copied, so no barrier couples the warps while they stream. x
// goes through L1, which the CS warps of a row group share (they read the
// same pieces), so wider CTAs cut x's traffic from L2 as M grows.
//
// Operand order. The product is a sum over k, so the mma's k slots may
// take the k values in any order that A and B share. Lane (g = l/4, t =
// l%4) of a warp reads packed row 4c + t of chunk c for columns 4g .. 4g +
// 3 of its 32: per column the 8 nibbles of one word. A shift and a lop3
// under the bf16 exponent of 128 turn nibbles (i, i + 4) into the bf16
// pair 128 + q (exact), and one bf16x2 subtraction of 128 + z gives q - z
// exactly: pair P_i. mma j (of two k16 steps a chunk) takes P_2j in its k
// slots 2t, 2t + 1 and P_2j+1 in 2t + 8, 2t + 9; the lane's x fragment is
// the same 8 elements of its row, x[8t + 32c .. + 7], one 16-byte read
// permuted into the pairs (e_i, e_i+4). The A rows (weight columns) are
// permuted too: m16 tile s holds columns 4g + 2s (row g) and 4g + 2s + 1
// (row g + 8), so the lane's four columns feed two m16 tiles and its
// outputs are 4 neighbouring columns of 2 rows of x.
//
// Arithmetic: per quantization group the mma sums (q - z) x exactly
// rounded products in f32; at the group's end the lane adds s * sum into
// its f32 result (the TPU's per-group dot scaled once by s; its raw-nibble
// form subtracts z * sum(x) instead, which needs a sum of x per group:
// subtracting z from the nibbles costs one bf16x2 instruction a pair and
// no sum). So weights are never rounded to bf16 with their scale, unlike
// the plain twin. Group sizes are multiples of 32 (a chunk never
// straddles two groups).
//
// Reduction, in one launch and a fixed order: the warps write their f32
// results to shared memory and the CTA sums its K slices in order;
// with a cluster, every CTA keeps its sum in shared memory and rank r sums
// its share of the outputs over the cluster's ranks in rank order through
// distributed shared memory (cluster.sync before the reads and before any
// CTA exits). No atomics, no workspace, nothing left to reset.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace awq {
namespace gv {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = 8;
constexpr int DEPTH = 4;      // stages of a warp's copy ring

__device__ __forceinline__ uint32_t bf16x2_sub(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16x2 (128 + z, 128 + z) for the 4 zero-point nibbles of group g
__device__ __forceinline__ void zero_pairs(uint4 zw, int g, bool zeros,
                                           uint32_t (&zc)[4]) {
  const uint32_t w[4] = {zw.x, zw.y, zw.z, zw.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t z = zeros ? (w[j] >> (4 * (g & 7))) & 0xFu : 8u;
    zc[j] = 0x43004300u | z | (z << 16);
  }
}

// 16-byte asynchronous copy global -> shared through L1 (x: the warps of
// a row group that own other columns read the same pieces at about the
// same time, and L1 serves all but the first); pred false writes zeros.
__device__ __forceinline__ void cp_async16_ca(uint32_t dst, const void* src,
                                              bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// The CTA's shape: CS column slices of 32 by RG row groups of 32 by KH
// slices of its K range, one warp each (CS RG KH = 8).
template <int NT, int CS, int RG>
struct Shape {
  static constexpr int KH = WARPS / (CS * RG);
  static constexpr int COLS = 32 * CS;
  static constexpr int ROWS = 32 * RG;
  static constexpr int STAGE = (1 + NT) * 512;  // a warp's stage
  static constexpr int RING = WARPS * DEPTH * STAGE;
  static constexpr int RED = KH * ROWS * COLS * 4;  // f32 results
  static constexpr int SMEM = RING > RED ? RING : RED;
  static_assert(CS * RG * KH == WARPS, "8 warps");
};

// Where a lane's 4 weight columns live: the operand (packed words, scales
// and zero words, null: symmetric; row stride `ld` words), the first
// column's index n in it, and whether they exist (N % 4 == 0: all 4 or
// none).
struct Cols4 {
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
  int n;
  bool ok;
};

// Column maps: `at(c)` places the CTA's local columns c .. c + 3 (c a
// multiple of 4, c < Shape::COLS).
//
// Dense: local column c is column n0 + c of one operand of N columns (K1,
// K6, the down and o projections).
struct Dense {
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
  int N, n0;
  __device__ __forceinline__ Cols4 at(int c) const {
    return {qw, sc, qz, n0 + c, n0 + c < N};
  }
};

// Pairs: the CTA's first half of columns holds pairs p0 .. p0 + COLS/2 - 1
// of the first operand, its second half the partners of the same pairs in
// the second operand, so that after the reduction one CTA holds both
// values of each pair. Pair p lies at column (p / span) * stride + p %
// span of its operand (span = stride = the pair count for gate and up;
// span hd / 2, stride hd for the two halves of a head's rotary dims).
struct Pairs {
  const int32_t* qw[2];
  const float* sc[2];
  const int32_t* qz[2];
  int pairs, span, stride, p0, half;  // half: the CTA's COLS / 2
  __device__ __forceinline__ int col(int p) const {
    return (p / span) * stride + p % span;
  }
  __device__ __forceinline__ Cols4 at(int c) const {
    const bool w = c >= half;  // selects, not an indexed parameter array
    const int p = p0 + c - (w ? half : 0);
    const bool ok = p < pairs;
    return {w ? qw[1] : qw[0], w ? sc[1] : sc[0], w ? qz[1] : qz[0],
            ok ? col(p) : 0, ok};
  }
};

// Epilogues. An element epilogue (TILE false) takes each reduced f32 sum:
// `live(c)` says whether local column c is stored, `(r, c, v)` stores row
// r. A tile epilogue (TILE true) finds the reduced tile red[r][c] (rows x
// COLS f32, row stride COLS) in shared memory and `finish(red, rows, e0,
// step)` handles its column pairs (r, c) and (r, c + COLS/2), q = r COLS/2
// + c, for q = e0, e0 + step, ...
//
// StoreBf16: y[r][n0 + c] = bf16(v), row stride N (K1, K6, down, o).
struct StoreBf16 {
  static constexpr bool TILE = false;
  __nv_bfloat16* y;
  int N, n0;
  __device__ __forceinline__ bool live(int c) const { return n0 + c < N; }
  __device__ __forceinline__ void operator()(int r, int c, float v) const {
    y[(size_t)r * N + (n0 + c)] = __float2bfloat16(v);
  }
};

// Programmatic dependent launch: a grid launched with the programmatic
// stream serialization attribute may start before the grid it follows
// ends; griddep_wait() returns once that grid is complete and its writes
// are visible (at once without the attribute), and griddep_trigger() lets
// the next grid start before this one ends.
__device__ __forceinline__ void griddep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void griddep_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The CTA's columns (placed by `map`) for rows [0, rows) (rows <= 32 RG)
// of x (row stride K), K packed rows of row stride `ld` words, into `epi`,
// NT n8 tiles a warp. The cluster's csize CTAs split K, this one being
// `rank`; the KH warps of a (column slice, row group) split the CTA's
// share again. With WAIT, x is the previous grid's output (a dependent
// launch): the first weights are copied before griddep_wait(). With
// TRIGGER, the CTA lets the next grid start once its last weights are in
// (triggered at the CTA's start instead, K3's down pass ran 6 µs slower at
// Mistral's widths on the H100; PERF.md). smem: Shape<NT, CS,
// RG>::SMEM bytes, 16-byte aligned.
template <int NT, int CS, int RG, bool WAIT = false, bool TRIGGER = false,
          class Map, class Epi>
__device__ __forceinline__ void gemv_block(
    const __nv_bfloat16* __restrict__ x, int rows, const Map& map, int ld,
    const Epi& epi, int K, int gs, int rank, int csize, uint8_t* smem) {
  using L = Shape<NT, CS, RG>;
  constexpr int KH = L::KH;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cs = warp % CS, rg = (warp / CS) % RG, kh = warp / (CS * RG);
  const int r0 = 32 * rg;
  const int wrows = min(32, rows - r0);  // <= 0: an idle warp
  const Cols4 wc = map.at(32 * cs + 4 * gid);  // the lane's 4 columns
  const int32_t *qw = wc.qw, *qz = wc.qz;
  const float* sc = wc.sc;
  const int n = wc.n;
  const bool col_ok = wc.ok;
  const bool zeros = qz != nullptr;
  // the warp's chunks [c0, c1) of the K / 32: the cluster's split, then
  // the CTA's K slices
  const int chunks = K / 32;
  const int splits = csize * KH, part = rank * KH + kh;
  const int c0 = static_cast<int>((long long)part * chunks / splits);
  const int c1 = static_cast<int>((long long)(part + 1) * chunks / splits);

  float res[NT][2][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) res[i][t][e] = 0.0f;

  if (wrows > 0 && c0 < c1) {  // warp-uniform
    float acc[NT][2][4];
#pragma unroll
    for (int i = 0; i < NT; ++i)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.0f;
    const int32_t* wcol = qw + (size_t)tig * ld + (col_ok ? n : 0);
    uint8_t* ring = smem + warp * DEPTH * L::STAGE + 16 * lane;
    const uint32_t ring_sa = hop::smem_addr(ring);
    // chunk c's copies into stage c % DEPTH (zeros where a column or row
    // is out of range): the lane's weight words, then its x pieces
    auto issue_w = [&](int c) {
      const uint32_t st = ring_sa + (c % DEPTH) * L::STAGE;
      hop::cp_async16(st, wcol + (size_t)c * 4 * ld, col_ok);
    };
    auto issue_x = [&](int c) {
      const uint32_t st = ring_sa + (c % DEPTH) * L::STAGE;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (8 * nt < wrows) {
          const int row = r0 + 8 * nt + gid;
          const bool ok = row < rows;
          cp_async16_ca(st + 512 * (1 + nt),
                        x + (ok ? (size_t)row * K + 32 * c + 8 * tig : 0),
                        ok);
        }
      }
    };
    auto issue = [&](int c) {
      issue_w(c);
      issue_x(c);
    };
    if constexpr (WAIT) {
      // x is the grid before this one's output: the first chunks' weights
      // (which do not depend on it) are copied before waiting for that
      // grid, then their x pieces (chunk c0 + i's still completes with
      // commit group i, which now holds more weights than its own)
#pragma unroll
      for (int i = 0; i < DEPTH - 1; ++i)
        if (c0 + i < c1) issue_w(c0 + i);
      griddep_wait();
#pragma unroll
      for (int i = 0; i < DEPTH - 1; ++i) {
        if (c0 + i < c1) issue_x(c0 + i);
        hop::cp_async_commit();
      }
    } else {
#pragma unroll
      for (int i = 0; i < DEPTH - 1; ++i) {
        if (c0 + i < c1) issue(c0 + i);
        hop::cp_async_commit();
      }
    }
    // the group of chunk c0; the next group's scales and zero words are
    // loaded a group ahead
    int g = (32 * c0) / gs, pos = 32 * c0 - g * gs;
    const uint4 zero4 = make_uint4(0, 0, 0, 0);
    auto load_s = [&](int gg) {
      return col_ok ? __ldg(reinterpret_cast<const float4*>(
                          sc + (size_t)gg * ld + n))
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    auto load_z = [&](int gg) {
      return (col_ok && zeros) ? __ldg(reinterpret_cast<const uint4*>(
                                     qz + (size_t)(gg >> 3) * ld + n))
                               : zero4;
    };
    const int g_last = (32 * c1 - 1) / gs;
    float4 s4 = load_s(g);
    const uint4 zw = load_z(g);
    float4 s_next = s4;
    uint4 z_next = zw;
    if (g < g_last) {
      s_next = load_s(g + 1);
      z_next = load_z(g + 1);
    }
    uint32_t zc[4];
    zero_pairs(zw, g, zeros, zc);
    auto flush = [&]() {  // res += s * acc; acc = 0
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            res[i][t][e] =
                fmaf(sv[2 * t + (e >> 1)], acc[i][t][e], res[i][t][e]);
            acc[i][t][e] = 0.0f;
          }
    };

    for (int c = c0; c < c1; ++c) {
      if (c + DEPTH - 1 < c1) issue(c + DEPTH - 1);
      hop::cp_async_commit();
      hop::cp_async_wait<DEPTH - 1>();  // chunk c's copies have landed
      const uint8_t* st = ring + (c % DEPTH) * L::STAGE;
      const uint4 w = *reinterpret_cast<const uint4*>(st);
      // A: pairs P_i = nibbles (i, i + 4) of each column's word, q - z
      const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
      uint32_t p[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[j][q] = bf16x2_sub(
              ((wv[j] >> (4 * q)) & 0x000F000Fu) | 0x43004300u, zc[j]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        if (8 * nt < wrows) {  // warp-uniform
          const uint4 xv =
              *reinterpret_cast<const uint4*>(st + 512 * (1 + nt));
          // pairs (e_i, e_i+4) of the row's 8 elements
          const uint32_t b0 = __byte_perm(xv.x, xv.z, 0x5410);
          const uint32_t b1 = __byte_perm(xv.x, xv.z, 0x7632);
          const uint32_t b2 = __byte_perm(xv.y, xv.w, 0x5410);
          const uint32_t b3 = __byte_perm(xv.y, xv.w, 0x7632);
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            mma16816(acc[nt][t], p[2 * t][0], p[2 * t + 1][0], p[2 * t][1],
                     p[2 * t + 1][1], b0, b1);
            mma16816(acc[nt][t], p[2 * t][2], p[2 * t + 1][2], p[2 * t][3],
                     p[2 * t + 1][3], b2, b3);
          }
        }
      }
      pos += 32;
      if (pos == gs && c + 1 < c1) {  // the next chunk opens group g + 1
        flush();
        pos = 0;
        ++g;
        s4 = s_next;
        zero_pairs(z_next, g, zeros, zc);
        if (g < g_last) {
          s_next = load_s(g + 1);
          z_next = load_z(g + 1);
        }
      }
    }
    flush();
    hop::cp_async_wait<0>();
  }
  __syncthreads();  // every warp is done with its ring: reuse it
  if constexpr (TRIGGER) griddep_trigger();

  // warp (cs, rg, kh)'s results: rows r0 + 8nt + 2t and + 1, columns
  // 32 cs + 4g .. + 3, in red[kh][row][col]
  float* red = reinterpret_cast<float*>(smem);
  if (wrows > 0) {
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      float* row0 = red + ((kh * L::ROWS + r0 + 8 * i + 2 * tig) * L::COLS +
                           32 * cs + 4 * gid);
      *reinterpret_cast<float4*>(row0) =
          make_float4(res[i][0][0], res[i][0][2], res[i][1][0], res[i][1][2]);
      *reinterpret_cast<float4*>(row0 + L::COLS) =
          make_float4(res[i][0][1], res[i][0][3], res[i][1][1], res[i][1][3]);
    }
  }
  __syncthreads();

  // element e = row * COLS + col of the CTA's tile, summed over the K
  // slices in order (a tile epilogue finds the sums in red[e]: only this
  // thread reads or writes element e)
  const int total = rows * L::COLS;
  constexpr int SLICE = L::ROWS * L::COLS;
  constexpr int HALF = L::COLS / 2;
  if (csize == 1) {
    for (int e = tid; e < total; e += THREADS) {
      const int c = e % L::COLS;
      if constexpr (!Epi::TILE)
        if (!epi.live(c)) continue;
      float v = red[e];
#pragma unroll
      for (int h = 1; h < KH; ++h) v += red[h * SLICE + e];
      if constexpr (Epi::TILE)
        red[e] = v;
      else
        epi(e / L::COLS, c, v);
    }
    if constexpr (Epi::TILE) {
      __syncthreads();
      epi.finish(red, rows, tid, THREADS);
    }
    return;
  }
  if (KH > 1) {
    for (int e = tid; e < total; e += THREADS) {
      float v = red[e];
#pragma unroll
      for (int h = 1; h < KH; ++h) v += red[h * SLICE + e];
      red[e] = v;
    }
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  // rank r sums the elements e = r (mod csize); a tile epilogue's pair
  // (e, e + HALF) falls to one rank (csize divides HALF), and only rank r
  // reads any CTA's element e = r, so each rank overwrites its own
  for (int e = tid * csize + rank; e < total; e += THREADS * csize) {
    const int c = e % L::COLS;
    if constexpr (!Epi::TILE)
      if (!epi.live(c)) continue;
    float part_sum[8];
#pragma unroll
    for (int q = 0; q < 8; ++q)
      if (q < csize) part_sum[q] = *cluster.map_shared_rank(red + e, q);
    float v = part_sum[0];
#pragma unroll
    for (int q = 1; q < 8; ++q)
      if (q < csize) v += part_sum[q];
    if constexpr (Epi::TILE)
      red[e] = v;
    else
      epi(e / L::COLS, c, v);
  }
  cluster.sync();  // peers' shared memory stays until every read is done
  if constexpr (Epi::TILE) {
    static_assert(HALF % 8 == 0, "a cluster's ranks divide HALF");
    epi.finish(red, rows, tid * csize + rank, THREADS * csize);
  }
}

// The kernels and launchers have internal linkage: every library that
// includes this header keeps its own (template statics and kernel stubs of
// vague linkage would be merged across the loaded libraries, and one
// library's "shared memory limit raised" flag would skip another's).
namespace {

// A kernel of the core. `Job` holds x, M, K, gs, ld (the weights' row
// stride in words) and csize, and places CTAs: tiles(COLS) column tiles,
// map(tile, COLS) their columns, epi(tile, m0, COLS) their epilogue for
// rows m0 .. m0 + ROWS - 1. grid.x: column tiles x csize (clusters along
// x); grid.y: row chunks of 32 RG rows (one unless M > 32 RG).
template <int NT, int CS, int RG, int MIN_CTAS, class Job>
__global__ void __launch_bounds__(THREADS, MIN_CTAS) job_kernel(Job job) {
  using L = Shape<NT, CS, RG>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int rank = blockIdx.x % job.csize;
  const int tile = blockIdx.x / job.csize;
  const int m0 = blockIdx.y * L::ROWS;
  gemv_block<NT, CS, RG, Job::WAIT, Job::TRIGGER>(
      job.x + (size_t)m0 * job.K, min(L::ROWS, job.M - m0),
      job.map(tile, L::COLS), job.ld, job.epi(tile, m0, L::COLS), job.K,
      job.gs, rank, job.csize, smem);
}

}  // namespace

// y = x @ dequant(W), bf16 [M, N] (K1; the down and o passes of K3, K5, K8).
struct DenseJob {
  static constexpr bool TRIGGER = false;  // see griddep_trigger
  static constexpr bool WAIT = false;     // see griddep_wait
  const __nv_bfloat16* x;
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
  __nv_bfloat16* y;
  int M, K, ld, gs, csize;  // ld = N
  __host__ __device__ int tiles(int cols) const {
    return (ld + cols - 1) / cols;
  }
  __device__ Dense map(int tile, int cols) const {
    return {qw, sc, qz, ld, tile * cols};
  }
  __device__ StoreBf16 epi(int tile, int m0, int cols) const {
    return {y + (size_t)m0 * ld, ld, tile * cols};
  }
};

// A pair job: `cols` places pairs (its p0 and half are set per CTA) and
// `out.at(p0, half, m0)` gives the CTA's tile epilogue.
template <class Out>
struct PairJob {
  static constexpr bool TRIGGER = Out::TRIGGER;
  static constexpr bool WAIT = false;
  const __nv_bfloat16* x;
  int M, K, gs, ld, csize;
  Pairs cols;
  Out out;
  __host__ __device__ int tiles(int c) const {
    return (cols.pairs + c / 2 - 1) / (c / 2);
  }
  __device__ Pairs map(int tile, int c) const {
    Pairs m = cols;
    m.p0 = tile * (c / 2);
    m.half = c / 2;
    return m;
  }
  __device__ auto epi(int tile, int m0, int c) const {
    return out.at(tile * (c / 2), c / 2, m0);
  }
};

// Launch `kernel` (a __global__ taking `Args`) on a grid of `grid` CTAs of
// THREADS with `smem` bytes of dynamic shared memory (the caller has
// raised the kernel's limit), in clusters of csize CTAs along x; with
// `dependent`, as a programmatic dependent launch (griddep_wait).
template <typename Args>
inline cudaError_t launch_clustered(void (*kernel)(Args), dim3 grid,
                                    int csize, int smem, const Args& args,
                                    cudaStream_t stream,
                                    bool dependent = false) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (csize > 1) {  // no cluster for one CTA
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = csize;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (dependent) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args);
  const cudaError_t last = cudaGetLastError();  // and clear it
  return err != cudaSuccess ? err : last;
}

// Raise `kernel`'s dynamic shared memory limit to `smem` bytes, once.
template <typename Args>
inline cudaError_t allow_smem(void (*kernel)(Args), int smem, bool& done) {
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  done = err == cudaSuccess;
  return err;
}

namespace {

// A Job with WAIT launches as a programmatic dependent launch.
template <int NT, int CS, int RG, int MIN_CTAS, class Job>
cudaError_t launch_job(const Job& job, cudaStream_t st) {
  using L = Shape<NT, CS, RG>;
  static bool ready = false;
  auto* kernel = job_kernel<NT, CS, RG, MIN_CTAS, Job>;
  cudaError_t err = allow_smem(kernel, L::SMEM, ready);
  if (err != cudaSuccess) return err;
  const dim3 grid(job.tiles(L::COLS) * job.csize,
                  (job.M + L::ROWS - 1) / L::ROWS);
  return launch_clustered(kernel, grid, job.csize, L::SMEM, job, st,
                          Job::WAIT);
}

// Whether (nt, rg, csize) is a CTA shape of ops/gemm.gemv_plan: nt n8
// tiles a warp (1, 2 or 4: rows up to 8, 16, 32 a warp) and rg row groups
// of 32 (1, 2, 4 or 8; several only with nt = 4), csize CTAs a cluster (1,
// 2, 4 or 8) splitting K; with `row_groups` false, rg = 1 only (M <= 32).
inline bool plan_ok(int nt, int rg, int csize, bool row_groups) {
  const bool shape = (rg == 1 && (nt == 1 || nt == 2 || nt == 4)) ||
                     (row_groups && (rg == 2 || rg == 4 || rg == 8) &&
                      nt == 4);
  return shape && (csize == 1 || csize == 2 || csize == 4 || csize == 8);
}

// `job` on the CTA shape (nt, rg) (plan_ok): 32 columns for nt < 4, else
// 128 / 32 / 64 / 32 for rg = 1 / 2 / 4 / 8. ROW_GROUPS false builds the
// rg = 1 shapes only.
template <bool ROW_GROUPS, class Job>
cudaError_t launch_plan(const Job& job, int nt, int rg, cudaStream_t st) {
  if (rg == 1)
    return nt == 1   ? launch_job<1, 1, 1, 3>(job, st)
           : nt == 2 ? launch_job<2, 1, 1, 2>(job, st)
                     : launch_job<4, 4, 1, 2>(job, st);
  if constexpr (ROW_GROUPS)
    return rg == 2   ? launch_job<4, 1, 2, 2>(job, st)
           : rg == 4 ? launch_job<4, 2, 4, 2>(job, st)
                     : launch_job<4, 1, 8, 2>(job, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace gv
}  // namespace awq
