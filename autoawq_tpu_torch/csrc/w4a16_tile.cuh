// The tensor-core tile of the port's W4A16 GEMMs (sm_90a): K2
// (w4a16_gemm.cu) and the grouped GEMM K6 (moe_gemm.cu) for token blocks
// of 16 rows or more.
//
// One TM x 128 output tile of y = x @ dequant(W), TM = 32 * MI, per block
// of 8 warps (2 x 4), K walked 32 deep. Each step the block stages a
// [TM, 32] x tile in shared memory and dequantizes the matching [32, 128]
// weight tile ONCE into shared memory as bf16 ((q - z) * s in f32, then
// rounded, as the plain twin does), stored n-major so the B fragments of
// mma.sync.m16n8k16 are 32-bit shared loads. Each warp owns a (16 MI) x 32
// slice: MI x 4 mma tiles, f32 accumulators in registers. A 32-deep K step
// never straddles a quantization group because group sizes are multiples
// of 32. Rows past `rows` and columns past N are masked on load (zeros)
// and on store.
#pragma once

#include "w4a16_common.cuh"

namespace awq {

constexpr int TILE_N = 128;
constexpr int TILE_K = 32;
constexpr int TILE_PAD = 8;  // row padding (bf16) against bank conflicts

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x: the tile's first row (row stride K); out: the tile's first output row
// (row stride N); columns [n0, n0 + 128) of W [K/8, N]. 256 threads.
template <int MI>
__device__ __forceinline__ void gemm_tile(
    const __nv_bfloat16* __restrict__ x, int rows,
    const int32_t* __restrict__ qw, const float* __restrict__ sc,
    const int32_t* __restrict__ qz, __nv_bfloat16* __restrict__ out, int K,
    int N, int n0, int group_size) {
  constexpr int TM = 32 * MI;
  __shared__ __align__(16) __nv_bfloat16 As[TM][TILE_K + TILE_PAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[TILE_N][TILE_K + TILE_PAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // mma "groupID"
  const int tig = lane & 3;   // mma "thread in group"
  const int wm = (warp >> 2) * 16 * MI;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;        // warp's column offset

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  // x tile: TM rows x 32 bf16 in 16-byte chunks, four per row; a trip
  // count known at compile time keeps the loads unrolled and batched
  constexpr int X_CHUNKS = TM * 4;
  constexpr int X_ITERS = (X_CHUNKS + 255) / 256;
  for (int k0 = 0; k0 < K; k0 += TILE_K) {
#pragma unroll
    for (int it = 0; it < X_ITERS; ++it) {
      const int idx = tid + it * 256;
      if (X_CHUNKS % 256 == 0 || idx < X_CHUNKS) {
        const int row = idx >> 2;
        const int cq = (idx & 3) * 8;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row < rows)
          v = *reinterpret_cast<const uint4*>(x + (size_t)row * K + k0 + cq);
        *reinterpret_cast<uint4*>(&As[row][cq]) = v;
      }
    }
    // weight tile: 4 packed rows x 128 columns, two words per thread, each
    // dequantized to 8 bf16 (one 16-byte store of 8 consecutive K-rows)
    const int g = k0 / group_size;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * 256;
      const int wr = idx >> 7;
      const int col = idx & (TILE_N - 1);
      const int n = n0 + col;
      __align__(16) __nv_bfloat16 vals[8];
      if (n < N) {
        const uint32_t w =
            static_cast<uint32_t>(__ldg(qw + (size_t)(k0 / 8 + wr) * N + n));
        const float s = __ldg(sc + (size_t)g * N + n);
        const float z = zero_point(qz, g, n, N);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          vals[i] = __float2bfloat16((nibble(w, i) - z) * s);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16(0.0f);
      }
      *reinterpret_cast<uint4*>(&Bs[col][wr * 8]) =
          *reinterpret_cast<const uint4*>(vals);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < TILE_K; kk += 16) {
      uint32_t a[MI][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm + i * 16 + gid;
        const int c = kk + tig * 2;
        a[i][0] = ld_u32(&As[r][c]);
        a[i][1] = ld_u32(&As[r + 8][c]);
        a[i][2] = ld_u32(&As[r][c + 8]);
        a[i][3] = ld_u32(&As[r + 8][c + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = wn + j * 8 + gid;
        const int c = kk + tig * 2;
        b[j][0] = ld_u32(&Bs[nn][c]);
        b[j][1] = ld_u32(&Bs[nn][c + 8]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm + i * 16 + gid;
      const int c = n0 + wn + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= rows) continue;
        if (c < N) out[(size_t)rr * N + c] = __float2bfloat16(acc[i][j][2 * h]);
        if (c + 1 < N)
          out[(size_t)rr * N + c + 1] = __float2bfloat16(acc[i][j][2 * h + 1]);
      }
    }
  }
}

}  // namespace awq
