// ADC distance of one code row: the summation rule shared by K1
// (pq_scan.cu) and K3 (pq_scan_topk.cu).
//
// Both kernels sum lut[m][code_m] over ascending m in f32, one add at a
// time, starting from 0, and so does the plain PyTorch version
// (kernels/ref.py).  Keeping the definitions here is what makes the two
// kernels, and each kernel and its plain version, agree bitwise.  The
// forms below differ only in how they find the table entries and in how
// many queries' sums they carry at once; each sum keeps that order.
#pragma once

#include <cstdint>

// Tables in global memory, read through the read-only data cache (__ldg):
// the form K3 takes when one query's tables do not fit in a CTA's shared
// memory (e.g. M = 256 at K = 256: 256 KB; K1 stages them in ranges
// instead, pq_scan.cu's pq_scan_staged).  It indexes and offsets like a
// pointer to shared memory, so the sums below serve both, in the same
// order.
struct LdgTable {
  const float* p;
  __device__ __forceinline__ float operator[](int i) const {
    return __ldg(p + i);
  }
  template <typename I>
  __device__ __forceinline__ LdgTable operator+(I i) const {
    return {p + i};
  }
};

// The tables a CTA reads: staged in shared memory (`slut`), or (GT) left in
// global memory (`glut`) and read through the read-only cache.
template <bool GT>
__device__ __forceinline__ auto tables(const float* glut, const float* slut) {
  if constexpr (GT)
    return LdgTable{glut};
  else
    return slut;
}

// Add the table entries of code byte `c` of a row.  Packed: the lo nibble
// is subquantizer 2c, the hi nibble 2c + 1.
template <bool PACKED, typename Tab>
__device__ __forceinline__ float add_byte(float acc, Tab ql, int K,
                                          uint32_t byte, int c) {
  if (PACKED) {
    acc = acc + ql[(2 * c) * K + (byte & 15u)];
    acc = acc + ql[(2 * c + 1) * K + (byte >> 4)];
  } else {
    acc = acc + ql[c * K + byte];
  }
  return acc;
}

// sum_m ql[m][code_m] over the MB code bytes of `row`, for the first `nq`
// of QC queries whose tables lie `tab` floats apart from `ql` (a pointer to
// shared memory, or an LdgTable): each code byte is read once and added to
// every one of those sums.  `vec16` reads the row with 16-byte loads
// (MB % 16 == 0 and a 16-byte aligned row).
template <int QC, bool PACKED, typename Tab>
__device__ __forceinline__ void score_row_queries(
    float (&acc)[QC], const uint8_t* __restrict__ row, Tab ql, int tab,
    int K, int MB, int nq, bool vec16) {
#pragma unroll
  for (int q = 0; q < QC; ++q) acc[q] = 0.f;
  auto add = [&](uint32_t byte, int c) {
#pragma unroll
    for (int q = 0; q < QC; ++q)
      if (q < nq) acc[q] = add_byte<PACKED>(acc[q], ql + q * tab, K, byte, c);
  };
  if (vec16) {
    for (int c = 0; c < MB; c += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        add((w[j >> 2] >> (8 * (j & 3))) & 255u, c + j);
    }
  } else {
    for (int c = 0; c < MB; ++c) add(row[c], c);
  }
}

// The same sum for one query.
template <bool PACKED, typename Tab>
__device__ __forceinline__ float score_row(const uint8_t* __restrict__ row,
                                           Tab ql, int K, int MB,
                                           bool vec16) {
  float acc[1];
  score_row_queries<1, PACKED>(acc, row, ql, 0, K, MB, 1, vec16);
  return acc[0];
}

// The same sum for an unpacked row held in registers (MB / 16 pieces of 16
// bytes) and QC queries whose tables lie MB * K floats apart from `ql`, with
// compile-time K and MB.  Each code word is shifted once so that every byte
// is its entry's byte offset within a subquantizer's table (codes < K <= 64,
// so code * 4 < 256); each byte is extracted once (one PRMT) for all QC
// queries, and the rest of every lookup's address is an immediate.
template <int QC, int K, int MB>
__device__ __forceinline__ void score_regs(float (&acc)[QC],
                                           const uint4 (&row)[MB / 16],
                                           const float* ql) {
  static_assert(K <= 64 && MB % 16 == 0, "byte offsets must fit a byte");
  const char* base = reinterpret_cast<const char*>(ql);
#pragma unroll
  for (int q = 0; q < QC; ++q) acc[q] = 0.f;
#pragma unroll
  for (int v = 0; v < MB / 16; ++v) {
    const uint32_t w[4] = {row[v].x << 2, row[v].y << 2, row[v].z << 2,
                           row[v].w << 2};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = 16 * v + j;
      const char* e =
          base + __byte_perm(w[j >> 2], 0, 0x4440 | (j & 3)) + 4 * c * K;
#pragma unroll
      for (int q = 0; q < QC; ++q)
        acc[q] = acc[q] + *reinterpret_cast<const float*>(e + 4 * q * MB * K);
    }
  }
}

// The same sum for a nibble-packed row held in registers (MB / 4 code
// words; byte c holds subquantizer 2c in its lo nibble, 2c + 1 in its hi
// nibble) at K = 16, for QC queries whose tables lie 2 * MB * K floats
// apart from `ql`.  Each code word gives two offset words, one for the lo
// and one for the hi nibbles, each byte an entry's byte offset within its
// table (code * 4 < 64); each byte is extracted once (one PRMT) for all QC
// queries.  The adds take lo, then hi, byte by byte: ascending m.
template <int QC, int MB>
__device__ __forceinline__ void score_packed(float (&acc)[QC],
                                             const uint32_t (&row)[MB / 4],
                                             const float* ql) {
  constexpr int K = 16, M = 2 * MB;
  static_assert(MB % 4 == 0, "whole code words");
  const char* base = reinterpret_cast<const char*>(ql);
#pragma unroll
  for (int q = 0; q < QC; ++q) acc[q] = 0.f;
#pragma unroll
  for (int v = 0; v < MB / 4; ++v) {
    const uint32_t lo = (row[v] & 0x0F0F0F0Fu) << 2;
    const uint32_t hi = (row[v] >> 2) & 0x3C3C3C3Cu;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * v + j;
      const char* el = base + __byte_perm(lo, 0, 0x4440 | j) + 4 * (2 * c) * K;
#pragma unroll
      for (int q = 0; q < QC; ++q)
        acc[q] = acc[q] + *reinterpret_cast<const float*>(el + 4 * q * M * K);
      const char* eh =
          base + __byte_perm(hi, 0, 0x4440 | j) + 4 * (2 * c + 1) * K;
#pragma unroll
      for (int q = 0; q < QC; ++q)
        acc[q] = acc[q] + *reinterpret_cast<const float*>(eh + 4 * q * M * K);
    }
  }
}

// The same sum for K = 256 and unpacked codes, one piece of CH code bytes
// (CH = 16: a uint4, or 8: a uint2) of a row at a time: `acc` is the sum so
// far, `t` the table of the piece's first subquantizer (tables 256 floats
// apart).  Each byte is extracted once (one PRMT); the rest of a lookup's
// address is an immediate.  The K1 and K3 forms for K = 256 (`k256`) add
// the pieces of a row in order, so each sum stays ascending m.
template <int CH>
__device__ __forceinline__ void piece_words(const uint4& p, uint32_t (&w)[4]) {
  w[0] = p.x, w[1] = p.y, w[2] = p.z, w[3] = p.w;
}
template <int CH>
__device__ __forceinline__ void piece_words(const uint2& p, uint32_t (&w)[2]) {
  w[0] = p.x, w[1] = p.y;
}

template <int CH, typename Piece>
__device__ __forceinline__ float score_k256_piece(float acc, const Piece& p,
                                                  const float* t) {
  uint32_t w[CH / 4];
  piece_words<CH>(p, w);
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const uint32_t code = __byte_perm(w[j >> 2], 0, 0x4440 | (j & 3));
    acc = acc + t[j * 256 + code];
  }
  return acc;
}

// The piece type of CH code bytes.
template <int CH>
struct K256Piece {
  using type = uint4;
};
template <>
struct K256Piece<8> {
  using type = uint2;
};
