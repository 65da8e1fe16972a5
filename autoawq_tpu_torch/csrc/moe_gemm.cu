// K6: grouped W4A16 GEMM over expert-stacked weights, for the routed MoE
// MLP. Token block b (bm rows of the expert-sorted activations xs) is
// multiplied by the weights of expert block_expert[b]:
//   out[b*bm : (b+1)*bm] = xs[b*bm : (b+1)*bm] @ dequant(W[block_expert[b]])
// with qweight int32 [E, K/8, N], scales f32 [E, G, N] and zeros int32
// [E, ceil(G/8), N] (null: symmetric), f32 accumulation, bf16 out.
//
// Replaces autoawq_tpu/ops/moe_gemm.py::_kernel (called from
// grouped_awq_matmul_pallas), which moe_mlp calls twice per MoE layer
// (gate_up, then down), in prefill and in decode.
//
// Bound on the H100: bytes at decode (each routed expert's int4 weights
// read once: two Mixtral experts are 2 x 61 MB for gate_up), operations in
// prefill (F's 8192 routed rows: 1.92 TFLOP for gate_up).
//
// Design. A block reads its own block_expert[b] from device memory (no
// scalar prefetch). moe_align sizes the table for the worst case,
// NB = ceil(T*k / bm) + E, and the TPU kernel streams expert E-1's weights
// once for every unused trailing block. Here the live-block count is a
// device int32 (`live`, from moe_align, no host sync): a block at or past
// it writes zeros to its rows (the function's value there: their rows are
// all sentinels, i.e. zero activations) and reads no weights.
// - bm <= 8 (every decode call, and short prompts): K1's per-column GEMV
//   (w4a16_common.cuh gemv_column) with the expert's offsets, one thread
//   per output column, split-K across grid.z with a deterministic
//   reduction pass, as K1.
// - bm >= 16: K2's tensor-core tile (w4a16_tile.cuh) with TM = 32, 64 or
//   128 rows, the smallest that holds bm; a token block of more rows than
//   TM runs as several tiles.
#include "w4a16_tile.cuh"

namespace {

__global__ void __launch_bounds__(128)
moe_gemv(const __nv_bfloat16* __restrict__ xs,
         const int32_t* __restrict__ block_expert,
         const int32_t* __restrict__ live, const int32_t* __restrict__ qw,
         const float* __restrict__ sc, const int32_t* __restrict__ qz,
         __nv_bfloat16* __restrict__ out, float* __restrict__ ws, int NB,
         int bm, int K, int N, int G, int group_size, int rows_per_split) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  if (n >= N) return;
  const size_t row0 = (size_t)b * bm;
  if (b >= *live) {
    if (split == 0)
      for (int m = 0; m < bm; ++m)
        out[(row0 + m) * N + n] = __float2bfloat16(0.0f);
    return;
  }
  const int e = block_expert[b];
  const int K8 = K / 8;
  const int r0 = split * rows_per_split;
  const int r1 = min(K8, r0 + rows_per_split);
  float acc[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) acc[m] = 0.0f;
  awq::gemv_column<8>(
      xs + row0 * K, bm, qw + (size_t)e * K8 * N, sc + (size_t)e * G * N,
      qz == nullptr ? nullptr : qz + (size_t)e * ((G + 7) / 8) * N, K, N, n,
      group_size, r0, r1, acc);
#pragma unroll
  for (int m = 0; m < 8; ++m) {
    if (m >= bm) break;
    if (ws == nullptr) {
      out[(row0 + m) * N + n] = __float2bfloat16(acc[m]);
    } else {
      ws[((size_t)split * NB * bm + row0 + m) * N + n] = acc[m];
    }
  }
}

// Sum of the split-K partials in a fixed order; dead blocks' rows were
// zeroed by split 0 of moe_gemv and are left alone.
__global__ void moe_reduce(const float* __restrict__ ws,
                           __nv_bfloat16* __restrict__ out,
                           const int32_t* __restrict__ live, int NB, int bm,
                           int N, int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t total = (size_t)NB * bm * N;
  if (i >= total) return;
  if ((int)(i / ((size_t)bm * N)) >= *live) return;
  float acc = 0.0f;
  for (int s = 0; s < splits; ++s) acc += ws[(size_t)s * total + i];
  out[i] = __float2bfloat16(acc);
}

template <int MI>
__global__ void __launch_bounds__(256)
moe_tile(const __nv_bfloat16* __restrict__ xs,
         const int32_t* __restrict__ block_expert,
         const int32_t* __restrict__ live, const int32_t* __restrict__ qw,
         const float* __restrict__ sc, const int32_t* __restrict__ qz,
         __nv_bfloat16* __restrict__ out, int NB, int bm, int K, int N, int G,
         int group_size) {
  constexpr int TM = 32 * MI;
  const int tiles = (bm + TM - 1) / TM;
  const int b = blockIdx.y / tiles;
  const int sub = blockIdx.y - b * tiles;
  const int rows = min(TM, bm - sub * TM);
  const size_t row0 = (size_t)b * bm + (size_t)sub * TM;
  const int n0 = blockIdx.x * awq::TILE_N;
  if (b >= *live) {
    for (int idx = threadIdx.x; idx < rows * awq::TILE_N; idx += 256) {
      const int n = n0 + (idx % awq::TILE_N);
      if (n < N)
        out[(row0 + idx / awq::TILE_N) * N + n] = __float2bfloat16(0.0f);
    }
    return;
  }
  const int e = block_expert[b];
  awq::gemm_tile<MI>(
      xs + row0 * K, rows, qw + (size_t)e * (K / 8) * N,
      sc + (size_t)e * G * N,
      qz == nullptr ? nullptr : qz + (size_t)e * ((G + 7) / 8) * N,
      out + row0 * N, K, N, n0, group_size);
}

template <int MI>
void launch_tile(dim3 grid, cudaStream_t st, const __nv_bfloat16* xs,
                 const int32_t* be, const int32_t* live, const int32_t* qw,
                 const float* sc, const int32_t* qz, __nv_bfloat16* out,
                 int NB, int bm, int K, int N, int G, int gs) {
  moe_tile<MI><<<grid, 256, 0, st>>>(xs, be, live, qw, sc, qz, out, NB, bm,
                                     K, N, G, gs);
}

}  // namespace

// xs: bf16 [NB * bm, K]; block_expert: int32 [NB]; live: int32 [1] on the
// device, the count of leading live blocks; out: bf16 [NB * bm, N]; ws: f32
// scratch [splits, NB * bm, N] (bm <= 8 with splits > 1 only).
extern "C" int moe_gemm(const void* xs, const void* block_expert,
                        const void* live, const void* qw, const void* sc,
                        const void* qz, void* out, void* ws, int NB, int bm,
                        int K, int N, int G, int group_size, int splits,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xb = static_cast<const __nv_bfloat16*>(xs);
  auto* be = static_cast<const int32_t*>(block_expert);
  auto* lv = static_cast<const int32_t*>(live);
  auto* qwb = static_cast<const int32_t*>(qw);
  auto* scb = static_cast<const float*>(sc);
  auto* qzb = static_cast<const int32_t*>(qz);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const int col_blocks = (N + awq::TILE_N - 1) / awq::TILE_N;
  if (bm <= 8) {
    const int K8 = K / 8;
    const int rows_per_split = (K8 + splits - 1) / splits;
    float* wsb = splits > 1 ? static_cast<float*>(ws) : nullptr;
    dim3 grid(col_blocks, NB, splits);
    moe_gemv<<<grid, 128, 0, st>>>(xb, be, lv, qwb, scb, qzb, ob, wsb, NB, bm,
                                   K, N, G, group_size, rows_per_split);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
    const size_t total = (size_t)NB * bm * N;
    moe_reduce<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
        wsb, ob, lv, NB, bm, N, splits);
    return static_cast<int>(cudaGetLastError());
  }
  const int tm = bm <= 32 ? 32 : (bm <= 64 ? 64 : 128);
  dim3 grid(col_blocks, NB * ((bm + tm - 1) / tm));
  switch (tm) {
    case 32:
      launch_tile<1>(grid, st, xb, be, lv, qwb, scb, qzb, ob, NB, bm, K, N,
                     G, group_size);
      break;
    case 64:
      launch_tile<2>(grid, st, xb, be, lv, qwb, scb, qzb, ob, NB, bm, K, N,
                     G, group_size);
      break;
    default:
      launch_tile<4>(grid, st, xb, be, lv, qwb, scb, qzb, ob, NB, bm, K, N,
                     G, group_size);
  }
  return static_cast<int>(cudaGetLastError());
}
