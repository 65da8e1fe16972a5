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
// all sentinels, i.e. zero activations) and reads no weights. One launch
// a call, in either instance:
// - bm <= 8 (every decode call, and short prompts): K1's tensor-core GEMV
//   core (w4a16_gemv.cuh) with the expert's offsets, 32 columns a CTA; a
//   token block of 8 rows is one n8 tile, so sentinel rows cost no
//   instructions. The grid holds only the blocks that can be live
//   (`max_live` <= NB, a bound from shapes: T*k entries fill at most T*k
//   blocks), the blocks of a column tile next to each other; the CTAs of
//   block b also zero blocks b + max_live, b + 2 max_live, ... (all
//   dead).
// - bm >= 16: K2's pipelined wgmma body (w4a16_wgmma.cuh) with the
//   expert's rows in maps over the stacked weights, TOK = 16, 32, 64 or
//   128 rows, the smallest that holds bm; rows of the instance past bm
//   (the next block's) are read but not stored. Blocks of one expert are
//   adjacent after moe_align, and groups of RASTER_M of them walk the
//   columns together, so an expert's weight tile is read about once.
#include "w4a16_gemv.cuh"
#include "w4a16_wgmma.cuh"

namespace {

struct GemvArgs {
  const __nv_bfloat16* xs;
  const int32_t* block_expert;
  const int32_t* live;
  const int32_t* qw;
  const float* sc;
  const int32_t* qz;
  __nv_bfloat16* out;
  int NB, bm, K, N, G, gs, csize, max_live;
};

// The decode instance's CTA: 32 columns of one token block (8 rows: one
// n8 tile), K split over its 8 warps.
using GemvShape = awq::gv::Shape<1, 1, 1>;

// CTA (rank, block b, column tile) of a grid of csize x max_live x column
// tiles along x: clusters are adjacent along x, and the live blocks of one
// column tile are neighbours (an expert's weight tile is still in L2 for
// its next block).
__global__ void __launch_bounds__(awq::gv::THREADS, 3)
moe_gemv(GemvArgs a) {
  constexpr int COLS = GemvShape::COLS;
  constexpr int THREADS = awq::gv::THREADS;
  extern __shared__ __align__(16) uint8_t ring[];
  const int rank = blockIdx.x % a.csize;
  const int rest = blockIdx.x / a.csize;
  const int b = rest % a.max_live;
  const int n0 = (rest / a.max_live) * COLS;
  const int live = *a.live;
  // blocks past the grid's are dead: zero them (rank 0 of a cluster)
  if (rank == 0) {
    for (int d = b + a.max_live; d < a.NB; d += a.max_live) {
      for (int i = threadIdx.x; i < a.bm * COLS; i += THREADS) {
        const int col = n0 + i % COLS;
        if (col < a.N)
          a.out[((size_t)d * a.bm + i / COLS) * a.N + col] =
              __float2bfloat16(0.0f);
      }
    }
  }
  __nv_bfloat16* y = a.out + (size_t)b * a.bm * a.N;
  if (b >= live) {  // the whole cluster shares b
    if (rank == 0)
      for (int i = threadIdx.x; i < a.bm * COLS; i += THREADS) {
        const int col = n0 + i % COLS;
        if (col < a.N)
          y[(size_t)(i / COLS) * a.N + col] = __float2bfloat16(0.0f);
      }
    return;
  }
  const int e = a.block_expert[b];
  const int K8 = a.K / 8;
  const awq::gv::Dense w{
      a.qw + (size_t)e * K8 * a.N, a.sc + (size_t)e * a.G * a.N,
      a.qz == nullptr ? nullptr : a.qz + (size_t)e * ((a.G + 7) / 8) * a.N,
      a.N, n0};
  awq::gv::gemv_block<1, 1, 1>(a.xs + (size_t)b * a.bm * a.K, a.bm, w, a.N,
                               awq::gv::StoreBf16{y, a.N, n0}, a.K, a.gs,
                               rank, a.csize, ring);
}

template <int TOK>
__global__ void __launch_bounds__(awq::wg::THREADS, 1)
moe_wgmma(awq::wg::Params p, const int32_t* __restrict__ block_expert,
          const int32_t* __restrict__ live, int NB, int bm, int G,
          const __grid_constant__ CUtensorMap tx,
          const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap ts,
          const __grid_constant__ CUtensorMap tz) {
  using namespace awq::wg;
  extern __shared__ uint8_t smem[];
  int b, ni;
  tile_of(blockIdx.x, NB, (p.N + BN - 1) / BN, b, ni);
  const int m0 = b * bm, n0 = ni * BN;
  if (b >= *live) {
    for (int i = threadIdx.x; i < bm * BN; i += THREADS) {
      const int n = n0 + i % BN;
      if (n < p.N)
        p.out[(size_t)(m0 + i / BN) * p.N + n] = __float2bfloat16(0.0f);
    }
    return;
  }
  const int e = block_expert[b];
  const Tile tile{m0, m0 + bm, n0, e * (p.K / 8), e * G, e * ((G + 7) / 8)};
  gemm_block<TOK>(p, &tx, &tw, &ts, &tz, smem, tile);
}

template <int TOK>
int launch_wgmma(const void* xs, const int32_t* be, const int32_t* live,
                 const void* qw, const void* sc, const void* qz,
                 const awq::wg::Params& p, int NB, int bm, int E, int G,
                 cudaStream_t stream) {
  using namespace awq::wg;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        moe_wgmma<TOK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Layout<TOK>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tx, tw, ts, tz;
  if (!maps(TOK, xs, p.M, p.K, qw, (long long)E * (p.K / 8), sc,
            (long long)E * G, qz, (long long)E * ((G + 7) / 8), p.N, &tx,
            &tw, &ts, &tz))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = NB * ((p.N + BN - 1) / BN);
  moe_wgmma<TOK><<<blocks, THREADS, Layout<TOK>::SMEM, stream>>>(
      p, be, live, NB, bm, G, tx, tw, ts, tz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs: bf16 [NB * bm, K]; block_expert: int32 [NB]; live: int32 [1] on the
// device, the count of leading live blocks; out: bf16 [NB * bm, N]. N % 4
// == 0, group sizes multiples of 32, 16-byte aligned operands (checked by
// the wrapper). tok: the instance (ops/moe_gemm.tile_rows): 0 for bm <= 8,
// with grid rows max_live (>= live) and clusters of csize CTAs (1, 2, 4 or
// 8) splitting K; else the wgmma tile's rows (16, 32, 64 or 128, >= bm).
extern "C" int moe_gemm(const void* xs, const void* block_expert,
                        const void* live, const void* qw, const void* sc,
                        const void* qz, void* out, int E, int NB, int bm,
                        int K, int N, int G, int group_size, int max_live,
                        int csize, int tok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* be = static_cast<const int32_t*>(block_expert);
  auto* lv = static_cast<const int32_t*>(live);
  if (N % 4 != 0 || group_size % 32 != 0 || bm < 1 ||
      (tok == 0) != (bm <= 8) || bm > (tok == 0 ? 8 : tok))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tok == 0) {
    if (max_live < 1 || max_live > NB ||
        (csize != 1 && csize != 2 && csize != 4 && csize != 8))
      return static_cast<int>(cudaErrorInvalidValue);
    GemvArgs a{static_cast<const __nv_bfloat16*>(xs), be, lv,
               static_cast<const int32_t*>(qw), static_cast<const float*>(sc),
               static_cast<const int32_t*>(qz),
               static_cast<__nv_bfloat16*>(out), NB, bm, K, N, G, group_size,
               csize, max_live};
    const dim3 grid(((N + GemvShape::COLS - 1) / GemvShape::COLS) *
                    max_live * csize);
    static bool ready = false;
    constexpr int smem = GemvShape::SMEM;
    cudaError_t err = awq::gv::allow_smem(moe_gemv, smem, ready);
    if (err == cudaSuccess)
      err = awq::gv::launch_clustered(moe_gemv, grid, csize, smem, a, st);
    return static_cast<int>(err);
  }
  awq::wg::Params p{static_cast<__nv_bfloat16*>(out), NB * bm, K, N,
                    group_size, qz != nullptr};
  auto* fn = tok == 16   ? launch_wgmma<16>
             : tok == 32 ? launch_wgmma<32>
             : tok == 64 ? launch_wgmma<64>
             : tok == 128 ? launch_wgmma<128>
                          : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fn(xs, be, lv, qw, sc, qz, p, NB, bm, E, G, st);
}
