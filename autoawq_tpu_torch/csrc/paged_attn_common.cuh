// Shared pieces of the paged decode attention kernels K7 (paged_attn.cu) and
// K9 (paged_attn_stock.cu), sm_90a: the split kernels both launch first.
// K5 (fused_attn_step.cu) launches the same split kernels over its
// contiguous cache, addressed by DenseAddr below.
//
// Page pools are [nkv, P, ps, hd] row-major (one page of one kv head is ps
// contiguous rows of hd elements); a slot's page-table row is
// table[b * pps + page]. The table's rows are cut into splits of spp pages
// (ops/paged_attn.split_plan: from pps, ps and K9's pages_per_compute_block
// alone, never from the lengths). One CTA serves one (slot, kv head, chunk
// of query heads, split) and writes that split's partial softmax per query
// head: m (the largest score of the split's live rows), l (the sum of
// exp(s - m)) and acc[hd] (the sum of exp(s - m) * vscale * v), in f32,
// unnormalised. A split with no live row reads nothing and writes m = -inf,
// l = 0 (acc untouched). A second kernel, in each entry point, merges the
// partials.
//
// Two split kernels compute the same partials. mma_split_kernel (below) is
// the main path's: bf16 and int8 pools with whole 16-byte row chunks, its
// tiles copied with cp.async and multiplied on the tensor cores.
// split_kernel, on the CUDA cores, serves the rest (f32 pools, head dims
// that are not a multiple of 8): NW warps are cut into groups of LPR
// lanes; a group owns one row at a time and lane `sub` of it owns dims
// [8 sub, 8 sub + 8), read as one 16-byte load for bf16 (two for f32).
// Each group issues the K and V loads of U consecutive rows before it uses
// any of them, keeps an online softmax per query head in registers, and
// groups are merged with shuffles, warps in shared memory, in a fixed
// order. On an H100 it streamed long bf16 tables at ~1.2 TB/s, bound by
// its FMAs and shuffles (two CTAs an SM at 228 registers, with no loads in
// flight while they compute), which is why bf16 and int8 pools take the
// tensor-core kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace paged {

constexpr int NW = 4;  // warps per split CTA

__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }

// Eight consecutive elements of a row, as raw 32-bit words.
template <typename PT>
struct Chunk {
  static constexpr int W = 2 * (int)sizeof(PT);
  uint32_t w[W];
};

template <typename PT>
__device__ __forceinline__ float elem(const Chunk<PT>& c, int i) {
  if constexpr (sizeof(PT) == 2) {
    return __uint_as_float(((c.w[i >> 1] >> (16 * (i & 1))) & 0xffffu) << 16);
  } else if constexpr (sizeof(PT) == 1) {
    return static_cast<float>(
        static_cast<int>(c.w[i >> 2] << (24 - 8 * (i & 3))) >> 24);
  } else {
    return __uint_as_float(c.w[i]);
  }
}

// Dims [d0, d0 + 8) of pool row `row` (zero past hd, or when !ok). `vec`:
// hd % 8 == 0 (on 16-byte aligned pools), so the chunk is one aligned
// vector load; otherwise element by element.
template <typename PT>
__device__ __forceinline__ Chunk<PT> load_chunk(const PT* __restrict__ pool,
                                                size_t row, int hd, int d0,
                                                bool ok, bool vec) {
  Chunk<PT> c;
#pragma unroll
  for (int j = 0; j < Chunk<PT>::W; ++j) c.w[j] = 0u;
  if (!ok || d0 >= hd) return c;
  const PT* src = pool + row * hd + d0;
  if (vec) {
    if constexpr (sizeof(PT) == 1) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(src));
      c.w[0] = u.x;
      c.w[1] = u.y;
    } else {
#pragma unroll
      for (int j = 0; j < Chunk<PT>::W / 4; ++j) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + j);
        c.w[4 * j] = u.x;
        c.w[4 * j + 1] = u.y;
        c.w[4 * j + 2] = u.z;
        c.w[4 * j + 3] = u.w;
      }
    }
    return c;
  }
  const int n = min(8, hd - d0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i >= n) break;
    if constexpr (sizeof(PT) == 2) {
      const uint32_t bits = reinterpret_cast<const unsigned short*>(src)[i];
      c.w[i >> 1] |= bits << (16 * (i & 1));
    } else if constexpr (sizeof(PT) == 1) {
      const uint32_t bits = reinterpret_cast<const unsigned char*>(src)[i];
      c.w[i >> 2] |= bits << (8 * (i & 3));
    } else {
      c.w[i] = reinterpret_cast<const uint32_t*>(src)[i];
    }
  }
  return c;
}

// The empty partial of a dead split (m = -inf, l = 0; acc untouched) for
// its nr query heads, the first at partial index part0.
__device__ __forceinline__ void write_empty(float* ml, size_t part0,
                                            int nsplit, int nr, int tid) {
  if (tid < nr) {
    ml[2 * (part0 + (size_t)tid * nsplit)] = -INFINITY;
    ml[2 * (part0 + (size_t)tid * nsplit) + 1] = 0.0f;
  }
}

struct SplitArgs {
  const void* q;        // [B, nh, hd], QT
  const void* kp;       // [nkv, P, ps, hd], PT
  const void* vp;
  const float* ks;      // [nkv, P, ps] int8 K / V scales, or null
  const float* vs;
  const int* table;     // [B, pps]
  const int* lengths;   // [B]
  const float* slopes;  // [nh] ALiBi slopes, or null
  float* part;          // acc [B, nh, nsplit, hd], then (m, l) [.., 2]
  int B, nh, nkv, hd, P, ps, pps, spp, nsplit, window, vec;
  int nst;  // tensor-core kernel: tiles in its cp.async ring (1 or 2)
  float scale, softcap;
};

// The split kernels' arguments from an entry point's (K9 passes null
// scales and slopes, window 0, scale 1). The wrappers refuse pools whose
// base is not 16-byte aligned, so every row takes vector loads when hd is
// a multiple of 8.
inline SplitArgs split_args(const void* q, const void* kp, const void* vp,
                            const void* ks, const void* vs, const void* table,
                            const void* lengths, const void* slopes,
                            void* part, int B, int nh, int nkv, int hd, int P,
                            int ps, int pps, int spp, int nsplit, int window,
                            float scale, float softcap) {
  SplitArgs a;
  a.q = q;
  a.kp = kp;
  a.vp = vp;
  a.ks = static_cast<const float*>(ks);
  a.vs = static_cast<const float*>(vs);
  a.table = static_cast<const int*>(table);
  a.lengths = static_cast<const int*>(lengths);
  a.slopes = static_cast<const float*>(slopes);
  a.part = static_cast<float*>(part);
  a.B = B;
  a.nh = nh;
  a.nkv = nkv;
  a.hd = hd;
  a.P = P;
  a.ps = ps;
  a.pps = pps;
  a.spp = spp;
  a.nsplit = nsplit;
  a.window = window;
  a.vec = hd % 8 == 0;
  a.nst = 1;
  a.scale = scale;
  a.softcap = softcap;
  return a;
}

// Where a split kernel finds its rows (the kernels' bodies are the same for
// both).
// PagedAddr (K7, K9): pools [nkv, P, ps, hd] read through the slot's page
// table row; a length per slot, counting the current token, and with a
// window the rows t >= vl - window; q [B, nh, hd].
struct PagedAddr {
  static constexpr bool TABLE = true;
  __device__ __forceinline__ static int length(const SplitArgs& a, int b) {
    return a.lengths[b];
  }
  __device__ __forceinline__ static int lo(const SplitArgs& a, int vl) {
    return a.window > 0 ? max(0, vl - a.window) : 0;
  }
  __device__ __forceinline__ static size_t q_row(const SplitArgs& a, int b,
                                                 int h) {
    return (size_t)b * a.nh + h;
  }
  __device__ __forceinline__ static size_t row(const SplitArgs& a,
                                               const int* tb, int pg0, int b,
                                               int g, int t) {
    return ((size_t)a.P * g + tb[t / a.ps - pg0]) * a.ps + t % a.ps;
  }
};

// DenseAddr (K5): a contiguous cache [B, nkv, T, hd] (T in a.P; a "page"
// is ps consecutive rows of one (row, kv head), no table) with scales
// [B, nkv, T]; one length for every row at lengths[0] (clamped to T),
// counting the cached rows only (the current token is K5's own diagonal
// term), so a window keeps the rows t > vl - window; q rows of K5's f32
// qkv [B, nh + 2 nkv, hd].
struct DenseAddr {
  static constexpr bool TABLE = false;
  __device__ __forceinline__ static int length(const SplitArgs& a, int) {
    return min(a.lengths[0], a.P);
  }
  __device__ __forceinline__ static int lo(const SplitArgs& a, int vl) {
    return a.window > 0 ? max(0, vl - a.window + 1) : 0;
  }
  __device__ __forceinline__ static size_t q_row(const SplitArgs& a, int b,
                                                 int h) {
    return (size_t)b * (a.nh + 2 * a.nkv) + h;
  }
  __device__ __forceinline__ static size_t row(const SplitArgs& a,
                                               const int*, int, int b, int g,
                                               int t) {
    return ((size_t)b * a.nkv + g) * a.P + t;
  }
};

// Per query head and split: scores (q . k) * scale * kscale, optional
// softcap tanh(s / c) * c, optional ALiBi slope * (t - (vl - 1)), over the
// live rows t of the split (t < vl, t < pps * ps, t >= vl - window with a
// window), as the partial (m, l, acc) described above.
template <typename QT, typename PT, int LPR, int RC, class Addr>
__global__ void __launch_bounds__(NW * 32) split_kernel(SplitArgs a) {
  // rows a group loads before using them: fewer when the registers are
  // short (f32 pools, 8 query heads a CTA, or 4 groups a warp)
  constexpr int U = (sizeof(PT) == 4 || RC == 8 || LPR == 8) ? 4 : 8;
  constexpr int GPW = 32 / LPR;  // groups a warp
  constexpr int NG = NW * GPW;   // groups a CTA
  constexpr int HDP = 8 * LPR;   // dims a group covers
  extern __shared__ float smem[];
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const PT* __restrict__ kp = static_cast<const PT*>(a.kp);
  const PT* __restrict__ vp = static_cast<const PT*>(a.vp);
  const int rep = a.nh / a.nkv;
  const int nchunks = (rep + RC - 1) / RC;
  int idx = blockIdx.x;
  const int s = idx % a.nsplit;
  idx /= a.nsplit;
  const int chunk = idx % nchunks;
  idx /= nchunks;
  const int g = idx % a.nkv, b = idx / a.nkv;
  const int r0 = chunk * RC, nr = min(RC, rep - r0), h0 = g * rep + r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = a.pps * a.ps;
  const int s0 = s * a.spp * a.ps, s1 = min(s0 + a.spp * a.ps, rows);
  const int pg0 = s * a.spp, npg = (s1 - s0 + a.ps - 1) / a.ps;

  // the split's page ids: their loads do not wait for the length (the
  // split's pages always lie in the table; rows past vl are never read)
  int* tb = reinterpret_cast<int*>(smem);
  if constexpr (Addr::TABLE)
    for (int i = tid; i < npg; i += NW * 32)
      tb[i] = a.table[(size_t)b * a.pps + pg0 + i];
  const int vl = Addr::length(a, b);
  const int lo = Addr::lo(a, vl);
  const int t_begin = max(s0, lo), t_end = min(s1, min(vl, rows));
  const size_t part0 = ((size_t)b * a.nh + h0) * a.nsplit + s;  // head r0
  float* ml = a.part + (size_t)a.B * a.nh * a.nsplit * a.hd;
  if (t_begin >= t_end) {  // a dead split: the empty partial, no row read
    write_empty(ml, part0, a.nsplit, nr, tid);
    return;
  }
  const int sub = lane % LPR, d0 = 8 * sub;
  float qr[RC][8], slope[RC], m[RC], l[RC], acc[RC][8];
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    const QT* qh = q + (Addr::q_row(a, b, h0) + r) * a.hd;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      qr[r][i] = (r < nr && d0 + i < a.hd) ? to_f(qh[d0 + i]) : 0.0f;
      acc[r][i] = 0.0f;
    }
    slope[r] = (a.slopes != nullptr && r < nr) ? a.slopes[h0 + r] : 0.0f;
    m[r] = -INFINITY;
    l[r] = 0.0f;
  }
  __syncthreads();  // tb

  // the trip count is the warp's (shuffles need every lane); a group past
  // the split's end masks all its rows
  for (int tw = t_begin + warp * GPW * U; tw < t_end; tw += NG * U) {
    const int t0 = tw + (lane / LPR) * U;  // this group's U rows
    Chunk<PT> kc[U], vc[U];
    float ksc[U], vsc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      const bool ok = t < t_end;
      const size_t row = ok ? Addr::row(a, tb, pg0, b, g, t) : 0;
      kc[u] = load_chunk<PT>(kp, row, a.hd, d0, ok, a.vec);
      vc[u] = load_chunk<PT>(vp, row, a.hd, d0, ok, a.vec);
      ksc[u] = (a.ks != nullptr && ok) ? a.ks[row] : 1.0f;
      vsc[u] = (a.vs != nullptr && ok) ? a.vs[row] : 1.0f;
    }
    float sc[RC][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) kf[i] = elem(kc[u], i);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) part = fmaf(qr[r][i], kf[i], part);
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, o);
        float x = (part * a.scale) * ksc[u];
        if (a.softcap > 0.0f) x = tanhf(x / a.softcap) * a.softcap;
        if (a.slopes != nullptr)
          x += slope[r] * static_cast<float>(t0 + u - (vl - 1));
        sc[r][u] = x;
      }
    }
    float mx[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      mx[r] = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (t0 + u < t_end) mx[r] = fmaxf(mx[r], sc[r][u]);
      // 0 while m is -inf; a group with no live row yet keeps its zeros
      const float corr = mx[r] == -INFINITY ? 0.0f : expf(m[r] - mx[r]);
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] *= corr;
      m[r] = mx[r];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) vf[i] = elem(vc[u], i);
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const float p = t0 + u < t_end ? expf(sc[r][u] - mx[r]) : 0.0f;
        l[r] += p;
        const float pv = p * vsc[u];  // V scales fold into p, not into l
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pv, vf[i], acc[r][i]);
      }
    }
  }

  // merge the groups of a warp (lane xor LPR, 2 LPR, ..); a group that saw
  // no row holds m = -inf and weighs 0
#pragma unroll
  for (int r = 0; r < RC; ++r) {
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float mm = fmaxf(m[r], mo);
      const float ca = mm == -INFINITY ? 0.0f : expf(m[r] - mm);
      const float cb = mm == -INFINITY ? 0.0f : expf(mo - mm);
      l[r] = ca * l[r] + cb * lo2;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], o);
        acc[r][i] = ca * acc[r][i] + cb * ao;
      }
      m[r] = mm;
    }
  }
  // then the warps, in warp order, in shared memory
  float* sm_m = smem + ((a.spp + 3) & ~3);  // [NW][RC]
  float* sm_l = sm_m + NW * RC;             // [NW][RC]
  float* sm_acc = sm_l + NW * RC;           // [NW][RC][HDP]
  if (lane < LPR) {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (lane == 0) {
        sm_m[warp * RC + r] = m[r];
        sm_l[warp * RC + r] = l[r];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        sm_acc[(warp * RC + r) * HDP + d0 + i] = acc[r][i];
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * a.hd; e += NW * 32) {
    const int r = e / a.hd, d = e % a.hd;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, sm_m[w * RC + r]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = sm_m[w * RC + r];
      if (mw == -INFINITY) continue;
      const float c = expf(mw - mm);
      ls += c * sm_l[w * RC + r];
      as += c * sm_acc[(w * RC + r) * HDP + d];
    }
    const size_t pi = part0 + (size_t)r * a.nsplit;
    a.part[pi * a.hd + d] = as;
    if (d == 0) {
      ml[2 * pi] = mm;
      ml[2 * pi + 1] = ls;
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core split kernel, for bf16 and int8 pools with whole 16-byte
// row chunks (the main path). Same partials as split_kernel. A CTA of 4
// warps serves up to 16 query heads (one m16 tile: the group padded with
// zero rows) and walks its split in tiles of 64 rows, copied with cp.async
// (16 bytes a thread; rows outside the live range and dims past hd are
// zero-filled) into a ring of 1 or 2 tiles, so tile j + 1 is in flight
// while tile j is used. Warp w owns rows [16 w, 16 w + 16) of a tile:
// S = Q K^T with mma.sync m16n8k16 (Q and K through ldmatrix), the online
// softmax on S's accumulators, then O += P V with P as the A operand in
// the registers S left it in and V through ldmatrix.trans. An int8 tile is
// widened to bf16 in shared memory first (exact); its K scale multiplies
// the score and its V scale p. The products stay f32-accurate: an f32 q is
// split into bf16 hi + lo parts and so is p (two mmas each; the tensor
// cores have ~100x the rate these bytes need), and bf16 or int8 K/V values
// are exact in bf16. The warps' (m, l, O) are merged in shared memory.

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// C[16 x 8] += A[16 x 16] B[16 x 8], bf16 in, f32 accumulators.
__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
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

// bf16 hi part of (x0, x1) packed, and the lo part (x - hi) beside it.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = hop::pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = hop::pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

constexpr int TR = 64;  // rows a tile of the tensor-core kernel

// Byte offset of bf16 element (row, col) in a tile of rows of CS bytes
// whose 16-byte chunks are swizzled (chunk c of row r at c ^ (r % 8)), so
// ldmatrix's eight rows of one chunk fall in eight bank groups.
template <int CS>
__device__ __forceinline__ int swz_tile(int row, int col) {
  return row * CS + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// Dynamic shared memory of mma_split_kernel, in bytes: page ids, the int8
// scales of the ring, then either Q (hi, lo), the ring and the widened
// int8 tile (during the walk) or the warps' (m, l, O) (after it).
inline size_t mma_smem(int spp, int hdp, int nst, bool i8, bool qlo) {
  const size_t cs = (size_t)hdp * 2, rsb = i8 ? hdp + 16 : cs;
  const size_t head =
      4 * (size_t)((spp + 3) & ~3) + (i8 ? 2 * nst * TR * 4 : 0);
  const size_t walk = (qlo ? 2 : 1) * 16 * cs + (size_t)nst * 2 * TR * rsb +
                      (i8 ? 2 * TR * cs : 0);
  const size_t merge = (size_t)NW * 16 * (hdp + 8) * 4 + 2 * NW * 16 * 4;
  return head + (walk > merge ? walk : merge);
}

template <typename QT, typename PT, int HDP, class Addr>
__global__ void __launch_bounds__(NW * 32) mma_split_kernel(SplitArgs a) {
  constexpr bool I8 = sizeof(PT) == 1;
  constexpr bool QLO = sizeof(QT) == 4;  // an f32 q: hi + lo bf16 parts
  constexpr int CS = HDP * 2;  // bf16 tile row stride, bytes (swizzled)
  constexpr int RSB = I8 ? HDP + 16 : CS;  // ring row stride, bytes
  constexpr int CPR = HDP * (int)sizeof(PT) / 16;  // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const QT* __restrict__ q = static_cast<const QT*>(a.q);
  const PT* __restrict__ kp = static_cast<const PT*>(a.kp);
  const PT* __restrict__ vp = static_cast<const PT*>(a.vp);
  const int rep = a.nh / a.nkv;
  const int nchunks = (rep + 15) / 16;
  int idx = blockIdx.x;
  const int s = idx % a.nsplit;
  idx /= a.nsplit;
  const int chunk = idx % nchunks;
  idx /= nchunks;
  const int g = idx % a.nkv, b = idx / a.nkv;
  const int r0 = chunk * 16, nr = min(16, rep - r0), h0 = g * rep + r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rows = a.pps * a.ps;
  const int s0 = s * a.spp * a.ps, s1 = min(s0 + a.spp * a.ps, rows);
  const int pg0 = s * a.spp, npg = (s1 - s0 + a.ps - 1) / a.ps;
  const int nst = a.nst;

  // every load that waits on nothing is issued first: the split's page
  // ids (they always lie in the table; rows past vl are never read), the
  // length and q (zero past nr heads and hd dims)
  constexpr int QE = 16 * HDP / (NW * 32);  // q elements a thread
  int* tb = reinterpret_cast<int*>(smem_raw);
  const int pid = Addr::TABLE && tid < npg
                      ? a.table[(size_t)b * a.pps + pg0 + tid]
                      : 0;
  const int vl = Addr::length(a, b);
  float qv[QE];
#pragma unroll
  for (int k = 0; k < QE; ++k) {
    const int e = tid + k * NW * 32, r = e / HDP, d = e % HDP;
    qv[k] = (r < nr && d < a.hd)
                ? to_f(q[(Addr::q_row(a, b, h0) + r) * a.hd + d])
                : 0.0f;
  }
  if constexpr (Addr::TABLE) {
    if (tid < npg) tb[tid] = pid;
    for (int i = tid + NW * 32; i < npg; i += NW * 32)
      tb[i] = a.table[(size_t)b * a.pps + pg0 + i];
  }
  const int lo = Addr::lo(a, vl);
  const int t_begin = max(s0, lo), t_end = min(s1, min(vl, rows));
  const size_t part0 = ((size_t)b * a.nh + h0) * a.nsplit + s;  // head r0
  float* ml = a.part + (size_t)a.B * a.nh * a.nsplit * a.hd;
  if (t_begin >= t_end) {  // a dead split: the empty partial, no row read
    write_empty(ml, part0, a.nsplit, nr, tid);
    return;
  }
  size_t off = 4 * (size_t)((a.spp + 3) & ~3);
  float* ksm = reinterpret_cast<float*>(smem_raw + off);  // [nst][TR]
  float* vsm = ksm + nst * TR;
  if (I8) off += 2 * nst * TR * 4;
  unsigned char* qs = smem_raw + off;            // [QLO + 1][16][CS]
  unsigned char* ring = qs + (QLO ? 2 : 1) * 16 * CS;  // [nst][K, V][TR][RSB]
  unsigned char* cvt = ring + nst * 2 * TR * RSB;      // int8: [K, V][TR][CS]

  // Q rows as bf16 hi (and lo)
#pragma unroll
  for (int k = 0; k < QE; ++k) {
    const int e = tid + k * NW * 32, r = e / HDP, d = e % HDP;
    const __nv_bfloat16 hi = __float2bfloat16(qv[k]);
    *reinterpret_cast<__nv_bfloat16*>(qs + swz_tile<CS>(r, d)) = hi;
    if (QLO)
      *reinterpret_cast<__nv_bfloat16*>(qs + swz_tile<CS>(16 + r, d)) =
          __float2bfloat16(qv[k] - __bfloat162float(hi));
  }
  __syncthreads();  // tb (the copies below read it)

  const int live = a.hd * (int)sizeof(PT) / 16;  // chunks of a row to copy
  const int tj0 = (t_begin - s0) / TR, tj1 = (t_end - 1 - s0) / TR;
  auto issue = [&](int j, int st) {
    const int tt0 = s0 + j * TR;
    for (int e = tid; e < TR * CPR; e += NW * 32) {
      const int i = e / CPR, c = e % CPR, t = tt0 + i;
      const bool in = t >= t_begin && t < t_end;
      const size_t row = in ? Addr::row(a, tb, pg0, b, g, t) : 0;
      const bool ok = in && c < live;
      const size_t src = row * a.hd + c * (16 / sizeof(PT));
      // a bf16 tile is used where it lands (swizzled); an int8 one is
      // widened into cvt first
      const int dst = I8 ? i * RSB + c * 16 : swz_tile<CS>(i, 8 * c);
      hop::cp_async16(hop::smem_addr(ring + (st * 2) * TR * RSB + dst),
                      ok ? kp + src : kp, ok);
      hop::cp_async16(hop::smem_addr(ring + (st * 2 + 1) * TR * RSB + dst),
                      ok ? vp + src : vp, ok);
      if (I8 && c == 0) {
        cp_async4(hop::smem_addr(ksm + st * TR + i), in ? a.ks + row : a.ks,
                  in);
        cp_async4(hop::smem_addr(vsm + st * TR + i), in ? a.vs + row : a.vs,
                  in);
      }
    }
  };

  float slope[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane / 4 + 8 * h;
    slope[h] = (a.slopes != nullptr && r < nr) ? a.slopes[h0 + r] : 0.0f;
  }
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float o[HDP / 8][4];
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.0f;
  const int nk = (a.hd + 15) / 16;  // 16-dim steps that hold real dims

  issue(tj0, 0);
  hop::cp_async_commit();
  for (int j = tj0; j <= tj1; ++j) {
    const int st = (j - tj0) % nst;
    if (nst == 2 && j < tj1) {
      issue(j + 1, st ^ 1);
      hop::cp_async_commit();
      hop::cp_async_wait<1>();
    } else {
      hop::cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kt = ring + (st * 2) * TR * RSB;
    const unsigned char* vt = ring + (st * 2 + 1) * TR * RSB;
    if constexpr (I8) {  // widen the int8 tile to bf16 (exact)
      for (int e = tid; e < 2 * TR * (HDP / 4); e += NW * 32) {
        const int mv = e / (TR * (HDP / 4)), rem = e % (TR * (HDP / 4));
        const int i = rem / (HDP / 4), c4 = rem % (HDP / 4);
        const uint32_t w = *reinterpret_cast<const uint32_t*>(
            ring + ((st * 2 + mv) * TR + i) * RSB + 4 * c4);
        float f[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          f[k] = static_cast<float>(static_cast<int>(w << (24 - 8 * k)) >> 24);
        uint2 out;
        out.x = hop::pack_bf16(f[0], f[1]);
        out.y = hop::pack_bf16(f[2], f[3]);
        *reinterpret_cast<uint2*>(cvt + mv * TR * CS +
                                  swz_tile<CS>(i, 4 * c4)) = out;
      }
      __syncthreads();
      kt = cvt;
      vt = cvt + TR * CS;
    }
    // S = Q K^T over this warp's 16 rows (two n8 tiles)
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[nt][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      if (kk >= nk) break;
      uint32_t qa[4], kb[4];
      const int qrow = (lane & 7) + ((lane >> 3) & 1) * 8;
      const int qcol = kk * 16 + (lane >> 4) * 8;
      ldsm_x4(qa, hop::smem_addr(qs + swz_tile<CS>(qrow, qcol)));
      ldsm_x4(kb, hop::smem_addr(
                      kt + swz_tile<CS>(16 * warp + (lane & 7) +
                                            ((lane >> 4) << 3),
                                        kk * 16 + ((lane >> 3) & 1) * 8)));
      mma16816(sc[0], qa, kb[0], kb[1]);
      mma16816(sc[1], qa, kb[2], kb[3]);
      if constexpr (QLO) {
        ldsm_x4(qa, hop::smem_addr(qs + swz_tile<CS>(16 + qrow, qcol)));
        mma16816(sc[0], qa, kb[0], kb[1]);
        mma16816(sc[1], qa, kb[2], kb[3]);
      }
    }
    // scores, the online softmax per head row (lane / 4 and lane / 4 + 8)
    const int tt0 = s0 + j * TR;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        const int ti = 16 * warp + 8 * nt + 2 * (lane & 3) + (c & 1);
        const int t = tt0 + ti;
        float x = sc[nt][c] * a.scale;
        if (I8) x *= ksm[st * TR + ti];
        if (a.softcap > 0.0f) x = tanhf(x / a.softcap) * a.softcap;
        if (a.slopes != nullptr)
          x += slope[h] * static_cast<float>(t - (vl - 1));
        x = (t >= t_begin && t < t_end) ? x : -INFINITY;
        sc[nt][c] = x;
        mx[h] = fmaxf(mx[h], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // 0 while m is -inf; a row with no live score yet keeps its zeros
      corr[h] = mx[h] == -INFINITY ? 1.0f : expf(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        p[c] = sc[nt][c] == -INFINITY ? 0.0f : expf(sc[nt][c] - mx[h]);
        l[h] += p[c];  // the unscaled probabilities
        if (I8)  // the V scale folds into p, not into l
          p[c] *= vsm[st * TR + 16 * warp + 8 * nt + 2 * (lane & 3) + (c & 1)];
      }
      split_bf16(p[0], p[1], pa[2 * nt], pl[2 * nt]);
      split_bf16(p[2], p[3], pa[2 * nt + 1], pl[2 * nt + 1]);
    }
#pragma unroll
    for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) o[n][c] *= corr[c >> 1];
    // O += P V over this warp's rows, 16 dims a step
#pragma unroll
    for (int n = 0; n < HDP / 16; ++n) {
      if (n >= nk) break;
      uint32_t vb[4];
      ldsm_x4_t(vb, hop::smem_addr(
                        vt + swz_tile<CS>(16 * warp + (lane & 7) +
                                              ((lane >> 3) & 1) * 8,
                                          n * 16 + (lane >> 4) * 8)));
      mma16816(o[2 * n], pa, vb[0], vb[1]);
      mma16816(o[2 * n + 1], pa, vb[2], vb[3]);
      mma16816(o[2 * n], pl, vb[0], vb[1]);
      mma16816(o[2 * n + 1], pl, vb[2], vb[3]);
    }
    __syncthreads();  // the stage is free for the copy of tile j + 2
  }

  // the warps' (m, l, O), merged in warp order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  constexpr int MS = HDP + 8;  // row stride: 2-way bank conflicts at most
  float* mo = reinterpret_cast<float*>(qs);  // [NW][16][MS]
  float* mm_s = mo + NW * 16 * MS;            // [NW][16]
  float* ll_s = mm_s + NW * 16;               // [NW][16]
#pragma unroll
  for (int n = 0; n < HDP / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = lane / 4 + 8 * (c >> 1);
      mo[(warp * 16 + r) * MS + 8 * n + 2 * (lane & 3) + (c & 1)] = o[n][c];
    }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mm_s[warp * 16 + lane / 4 + 8 * h] = m[h];
      ll_s[warp * 16 + lane / 4 + 8 * h] = l[h];
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * a.hd; e += NW * 32) {
    const int r = e / a.hd, d = e % a.hd;
    float mm = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, mm_s[w * 16 + r]);
    float ls = 0.0f, as = 0.0f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = mm_s[w * 16 + r];
      if (mw == -INFINITY) continue;
      const float c = expf(mw - mm);
      ls += c * ll_s[w * 16 + r];
      as += c * mo[(w * 16 + r) * MS + d];
    }
    const size_t pi = part0 + (size_t)r * a.nsplit;
    a.part[pi * a.hd + d] = as;
    if (d == 0) {
      ml[2 * pi] = mm;
      ml[2 * pi + 1] = ls;
    }
  }
}

template <typename QT, typename PT, int HDP, class Addr>
cudaError_t launch_mma(const SplitArgs& a, cudaStream_t st) {
  const int rep = a.nh / a.nkv;
  const int grid = a.B * a.nkv * ((rep + 15) / 16) * a.nsplit;
  const size_t smem =
      mma_smem(a.spp, HDP, a.nst, sizeof(PT) == 1, sizeof(QT) == 4);
  auto kernel = mma_split_kernel<QT, PT, HDP, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NW * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// Dynamic shared memory of split_kernel, in bytes.
inline size_t split_smem(int spp, int rc, int lpr) {
  return sizeof(float) * (((spp + 3) & ~3) + 2 * NW * rc + NW * rc * 8 * lpr);
}

inline int lanes_per_row(int hd) {
  return hd <= 64 ? 8 : (hd <= 128 ? 16 : 32);
}

template <typename QT, typename PT, int LPR, int RC, class Addr>
cudaError_t launch_split(const SplitArgs& a, int grid, cudaStream_t st) {
  const size_t smem = split_smem(a.spp, RC, LPR);
  auto kernel = split_kernel<QT, PT, LPR, RC, Addr>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NW * 32, smem, st>>>(a);
  return cudaGetLastError();
}

// The split kernel for a pool type, head dim and group size: the
// tensor-core kernel for bf16 and int8 pools with whole 16-byte row chunks,
// the CUDA-core kernel for the rest (f32 pools, other head dims).
template <typename QT, typename PT, class Addr = PagedAddr>
cudaError_t launch_split_for(SplitArgs a, cudaStream_t st) {
  if constexpr (sizeof(PT) != 4) {
    if (a.vec && (a.hd * (int)sizeof(PT)) % 16 == 0) {
      a.nst = a.spp * a.ps > TR ? 2 : 1;
      if (a.hd <= 64) return launch_mma<QT, PT, 64, Addr>(a, st);
      if (a.hd <= 128) return launch_mma<QT, PT, 128, Addr>(a, st);
      return launch_mma<QT, PT, 256, Addr>(a, st);
    }
  }
  const int rep = a.nh / a.nkv;
  const int rc = rep > 4 ? 8 : 4;
  const int grid = a.B * a.nkv * ((rep + rc - 1) / rc) * a.nsplit;
  const int lpr = lanes_per_row(a.hd);
  if (rc == 4) {
    if (lpr == 8) return launch_split<QT, PT, 8, 4, Addr>(a, grid, st);
    if (lpr == 16) return launch_split<QT, PT, 16, 4, Addr>(a, grid, st);
    return launch_split<QT, PT, 32, 4, Addr>(a, grid, st);
  }
  if (lpr == 8) return launch_split<QT, PT, 8, 8, Addr>(a, grid, st);
  if (lpr == 16) return launch_split<QT, PT, 16, 8, Addr>(a, grid, st);
  return launch_split<QT, PT, 32, 8, Addr>(a, grid, st);
}

}  // namespace paged
