// K2: W4A16 GEMM for M >= 256 (prefill), y = x @ dequant(qweight).
//
// Replaces autoawq_tpu/ops/pallas_gemm.py::_kernel_ws (called from _ws_matmul),
// the TPU's weights-stationary mode for M >= WS_MIN_M.
//
// Bound on the H100: operations once M is in the hundreds (2*M*N*K flops on
// 0.5*N*K weight bytes passes the ~295 flops/byte balance point near
// M = 150); the tensor cores are the limit.
//
// Design (simple first; wgmma and TMA are later work): a 128x128 output
// tile per block of 8 warps, K walked 32 deep. Each step the block stages
// a [128, 32] x tile in shared memory and dequantizes the matching [32, 128]
// weight tile ONCE into shared memory as bf16 ((q - z) * s in f32, then
// rounded, as the plain twin does), stored n-major so the B fragments of
// mma.sync.m16n8k16 are 32-bit shared loads. Each warp owns a 64x32 slice:
// 4 x 4 mma tiles, f32 accumulators in registers. A 32-deep K step never
// straddles a quantization group because group sizes are multiples of 32.
// Ragged M and N are masked on load (zeros) and on store.
#include "w4a16_common.cuh"

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int PAD = 8;  // row padding (bf16) against shared-memory conflicts

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

__global__ void __launch_bounds__(256)
w4a16_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                  const int32_t* __restrict__ qw,
                  const float* __restrict__ sc,
                  const int32_t* __restrict__ qz,
                  __nv_bfloat16* __restrict__ out, int M, int K, int N,
                  int group_size) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][BK + PAD];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][BK + PAD];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // mma "groupID"
  const int tig = lane & 3;   // mma "thread in group"
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp >> 2) * 64;  // warp's row offset in the tile
  const int wn = (warp & 3) * 32;   // warp's column offset

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x tile: 128 rows x 32 bf16 = 512 16-byte chunks, two per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * 256;
      const int row = idx >> 2;
      const int cq = (idx & 3) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (m0 + row < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 +
                                            cq);
      *reinterpret_cast<uint4*>(&As[row][cq]) = v;
    }
    // weight tile: 4 packed rows x 128 columns, two words per thread, each
    // dequantized to 8 bf16 (one 16-byte store of 8 consecutive K-rows)
    const int g = k0 / group_size;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int idx = tid + it * 256;
      const int wr = idx >> 7;
      const int col = idx & (BN - 1);
      const int n = n0 + col;
      __align__(16) __nv_bfloat16 vals[8];
      if (n < N) {
        const uint32_t w =
            static_cast<uint32_t>(__ldg(qw + (size_t)(k0 / 8 + wr) * N + n));
        const float s = __ldg(sc + (size_t)g * N + n);
        const float z = awq::zero_point(qz, g, n, N);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          vals[i] = __float2bfloat16((awq::nibble(w, i) - z) * s);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) vals[i] = __float2bfloat16(0.0f);
      }
      *reinterpret_cast<uint4*>(&Bs[col][wr * 8]) =
          *reinterpret_cast<const uint4*>(vals);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[4][4];
      uint32_t b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm + i * 16 + gid;
      const int c = n0 + wn + j * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= M) continue;
        if (c < N) out[(size_t)rr * N + c] = __float2bfloat16(acc[i][j][2 * h]);
        if (c + 1 < N)
          out[(size_t)rr * N + c + 1] = __float2bfloat16(acc[i][j][2 * h + 1]);
      }
    }
  }
}

}  // namespace

extern "C" int w4a16_gemm(const void* x, const void* qw, const void* sc,
                          const void* qz, void* out, int M, int K, int N,
                          int group_size, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w4a16_gemm_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qw),
      static_cast<const float*>(sc), static_cast<const int32_t*>(qz),
      static_cast<__nv_bfloat16*>(out), M, K, N, group_size);
  return static_cast<int>(cudaGetLastError());
}
