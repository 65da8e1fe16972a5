// Host-side int4 repacking for checkpoint save and load: AutoAWQ's GEMM
// layout <-> the port's layout, one pass over the nibbles, no temporaries;
// and the inner loops of the gemv / gemv_fast / marlin layouts.
//
// The port's copy of csrc/packing.cpp (the JAX package's host packer, whose
// planar layout the port does not use): the AutoAWQ codec below is that
// file's, taking int8 nibbles, and the port-layout codec is new. Built
// with the system C++ compiler into autoawq_tpu_torch/_build on first use
// and loaded with ctypes by autoawq_tpu_torch/core/native.py; the numpy /
// torch functions of autoawq_tpu_torch/core/packing.py are its oracle.
//
// Layouts (must match core/packing.py exactly):
//  * AutoAWQ GEMM: int32 [K, N/8]; nibble i of word (k, j) =
//    q4[k, 8j + AWQ_ORDER[i]], AWQ_ORDER = {0,2,4,6,1,3,5,7}.
//  * port: int32 [ceil(R/8), N]; nibble i of word (r, n) = q4[8r + i, n]
//    (a ragged R pads with zero nibbles).

#include <cstdint>

extern "C" {

static const int AWQ_ORDER[8] = {0, 2, 4, 6, 1, 3, 5, 7};
static const int AWQ_NIBBLE[8] = {0, 4, 1, 5, 2, 6, 3, 7};  // col % 8 -> i

// q4: int8 [k, n] nibbles (n % 8 == 0); out: int32 [k, n / 8].
void pack_awq(const int8_t* q4, int64_t k, int64_t n, int32_t* out) {
  const int64_t n8 = n / 8;
  for (int64_t row = 0; row < k; ++row) {
    const int8_t* src = q4 + row * n;
    int32_t* dst = out + row * n8;
    for (int64_t j = 0; j < n8; ++j) {
      const int8_t* s = src + 8 * j;
      uint32_t w = 0;
      for (int i = 0; i < 8; ++i)
        w |= (uint32_t)(s[AWQ_ORDER[i]] & 0xF) << (4 * i);
      dst[j] = (int32_t)w;
    }
  }
}

// packed: int32 [k, n8]; out: int8 [k, n] with n <= 8 * n8.
void unpack_awq(const int32_t* packed, int64_t k, int64_t n8, int64_t n,
                int8_t* out) {
  for (int64_t row = 0; row < k; ++row) {
    const uint32_t* src = (const uint32_t*)(packed + row * n8);
    int8_t* dst = out + row * n;
    for (int64_t col = 0; col < n; ++col)
      dst[col] = (int8_t)((src[col / 8] >> (4 * AWQ_NIBBLE[col % 8])) & 0xF);
  }
}

// q4: int8 [r, n] nibbles; out: int32 [(r + 7) / 8, n], zeroed by the
// caller.
void pack_port(const int8_t* q4, int64_t r, int64_t n, int32_t* out) {
  for (int64_t row = 0; row < r; ++row) {
    const int8_t* src = q4 + row * n;
    uint32_t* dst = (uint32_t*)(out + (row / 8) * n);
    const int shift = 4 * (int)(row % 8);
    for (int64_t col = 0; col < n; ++col)
      dst[col] |= (uint32_t)(src[col] & 0xF) << shift;
  }
}

// words: int32 [r8, n]; out: int8 [rows, ncols], rows <= 8 * r8 and
// ncols <= n (the first ncols columns).
void unpack_port(const int32_t* words, int64_t r8, int64_t n, int64_t rows,
                 int64_t ncols, int8_t* out) {
  (void)r8;
  for (int64_t row = 0; row < rows; ++row) {
    const uint32_t* src = (const uint32_t*)(words + (row / 8) * n);
    const int shift = 4 * (int)(row % 8);
    int8_t* dst = out + row * ncols;
    for (int64_t col = 0; col < ncols; ++col)
      dst[col] = (int8_t)((src[col] >> shift) & 0xF);
  }
}

// The non-GEMM layouts' inner loops (io/interop.py; each layout's nibble
// order is an index array that interop computes once per shape).
// Sequential nibbles along rows: words [r, ceil(n / 8)], nibble i of word
// (row, c) = vals[row, 8c + i] (zero-padded).
void pack_seq(const int8_t* vals, int64_t r, int64_t n, int32_t* out) {
  const int64_t c8 = (n + 7) / 8;
  for (int64_t row = 0; row < r; ++row) {
    const int8_t* src = vals + row * n;
    uint32_t* dst = (uint32_t*)(out + row * c8);
    for (int64_t c = 0; c < c8; ++c) {
      uint32_t w = 0;
      for (int i = 0; i < 8 && 8 * c + i < n; ++i)
        w |= (uint32_t)(src[8 * c + i] & 0xF) << (4 * i);
      dst[c] = w;
    }
  }
}

// words [r, c8] -> out int8 [r, n], n <= 8 * c8.
void unpack_seq(const int32_t* words, int64_t r, int64_t c8, int64_t n,
                int8_t* out) {
  for (int64_t row = 0; row < r; ++row) {
    const uint32_t* src = (const uint32_t*)(words + row * c8);
    int8_t* dst = out + row * n;
    for (int64_t col = 0; col < n; ++col)
      dst[col] = (int8_t)((src[col / 8] >> (4 * (col % 8))) & 0xF);
  }
}

// out[w] = OR over i < nib of (vals[src[w * nib + i]] & 0xF) << 4i.
void gather_pack(const int8_t* vals, const int64_t* src, int64_t words,
                 int32_t nib, uint32_t* out) {
  for (int64_t w = 0; w < words; ++w) {
    const int64_t* s = src + w * nib;
    uint32_t v = 0;
    for (int i = 0; i < nib; ++i) v |= (uint32_t)(vals[s[i]] & 0xF) << (4 * i);
    out[w] = v;
  }
}

// out[src[w * nib + i]] = (words[w] >> 4i) & 0xF.
void scatter_unpack(const uint32_t* words, const int64_t* src, int64_t count,
                    int32_t nib, int8_t* out) {
  for (int64_t w = 0; w < count; ++w) {
    const int64_t* s = src + w * nib;
    const uint32_t v = words[w];
    for (int i = 0; i < nib; ++i) out[s[i]] = (int8_t)((v >> (4 * i)) & 0xF);
  }
}

}  // extern "C"
