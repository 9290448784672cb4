// K1: paged PQ fast-scan (unfused ADC scan) for Hopper (sm_90a).
//
// Replaces repro/kernels/pq_scan.py::pq_scan_tiled_kernel (pallas_call at
// pq_scan.py:112, body _make_kernel and _tile_codes), and through it the
// per-query entry pq_scan_paged_kernel (K2).
//
//   out[b, s, i] = sum_m lut[b, m, codes[tile_idx[b / QT, s], i, m]]
//
// The TPU body turns the table lookup into a one-hot (QT, M*K) x (M*K, BLK)
// product on the MXU.  Here it is a plain lookup in shared memory, summed
// over ascending m in f32, one add at a time (adc.cuh), as the plain
// PyTorch version (kernels/ref.py) sums, so the two agree bitwise.
//
// What bounds it on this card: the table lookups.  Each (item, query) costs
// M shared-memory reads and M dependent f32 adds for M (or M / 2, packed)
// bytes of codes, read once per query tile, and 4 bytes of output.  At one
// 4-byte shared read per lane per clock on 132 SMs the main path's batches
// need 2.5-5x longer for their lookups than for their bytes (chip_smoke.py's
// lookup floor beside its byte bound).  So the design spends as few
// instructions as it can beside each lookup and keeps the card full:
//   * Compile-time shapes for the main path (K = 16, MB = M = 64,
//     unpacked; queries in chunks of QC = 1 or 8).  A thread holds its
//     item's 64-byte code row in registers, shifts each code word once so
//     every byte is its table offset (codes < K <= 64, so code * 4 fits a
//     byte), and extracts each byte once (PRMT) for all QC queries.  Every
//     lookup is then one LDS with an immediate offset and one FADD, and the
//     QC sums, each over ascending m, interleave.
//   * The next item's code row is loaded while the current one is scored,
//     and the CTA's slice of tile_idx is staged in shared memory first (the
//     TPU's scalar prefetch), so no lookup waits on a global load.
//   * The grid is (tiles, splits): a tile's S positions are cut into
//     `splits` ranges from the shape alone (kernels/pq_scan.py::scan_splits)
//     for about 8 x 132 CTAs of 256 threads, two waves and more.
//   * A query tile whose tables do not fit in shared memory is scanned in
//     query groups, one launch each (kernels/pq_scan.py::query_groups): a
//     launch scores QT of the tile's QS rows, whose pointers the wrapper has
//     advanced to the group's first row.
//   * The compact planes (nibble-packed, K = 16, MB = 8 or 16 code bytes:
//     M 16 and 32) have an instantiation of the same shape
//     (pq_scan_packed): the row in registers (one uint2 or uint4), each
//     code word turned into two offset words, lo and hi nibbles (adc.cuh's
//     score_packed), the next row loaded while this one is scored.
//   * Unpacked K = 256 codes (an nbits=8 index, PQ64x8: 64 KB of tables a
//     query) take the k256 form, one launch a call: at QT 1 the query's
//     table whole in shared memory (pq_scan_k256_one, three CTAs an SM),
//     on tiles the tables of each group of 8 queries interleaved by query
//     in device memory first and staged in ranges of KR subquantizers, as
//     the staged form does but copied as they are (pq_scan_k256_tile).
// Any other shape that keeps its tables in shared memory (K 4 or 128, odd
// widths, QT not 1 or a multiple of 8, rows not aligned) runs through the
// generic instantiation of the same loop: runtime K and MB, the row read in
// 16-byte pieces (or bytes), each piece's bytes extracted once for a chunk
// of up to 8 queries.
// Where one query's tables alone pass a CTA's shared memory (M = 256 at
// K = 256 is 256 KB), the staged form (pq_scan_staged) holds the tables of
// its (at most 8) queries for 8 subquantizers at a time (16 for one query)
// in shared memory; cp.async brings the next range in while the current
// one is scored.  A tile's tables are interleaved by query in shared
// memory, so one 16-byte read serves four queries' lookups.  Each thread
// carries the sums of its IPT items for every query in registers from one
// range to the next, so each sum is still one accumulator over ascending
// m.  A CTA's items (at most a pass of IPT x NT, sized by
// kernels/pq_scan.py::staged_splits) are scored against each range once,
// and a tile's splits are adjacent in launch order (a 1-D grid, split
// fastest), so a tile's tables come from device memory about once and
// from the L2 for its other splits.  At K = 256 a warp's 32 codes fall on
// about 3 distinct entries of the busiest bank: the lookups, not the
// bytes, set the pace.
// kernels/pq_scan.py::k1_form picks the form from the shape alone and the
// launch checks that the shape allows it.
// Entries of tile_idx must lie in [0, TB): callers clamp padding to 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"

namespace {

constexpr int NT = 256;           // threads of a CTA (K1_THREADS)
constexpr int MAX_POSITIONS = 1024;  // tile_idx entries a CTA stages
constexpr int FAST_K = 16, FAST_MB = 64;
// The staged form: a range holds the tables of SR subquantizers (SR1 for
// a launch of one query), each table SK floats apart (any K <= SK), of at
// most SQ queries; a thread carries IPT items through a pass
// (kernels/pq_scan.py's K1_STAGED_*).
constexpr int SR = 8, SR1 = 16, SK = 256, SQ = 8, IPT = 8;

// The forms, as kernels/pq_scan.py::K1_FORMS numbers them.
enum Form { GENERIC = 0, FAST = 1, PACKED = 2, STAGED = 3, K256_FORM = 4 };

// Stage tile_idx[tile, s0:s1] into `sidx`.  Ends with a barrier.
__device__ __forceinline__ void stage_positions(int* sidx,
                                                const int32_t* tile_idx,
                                                int s0, int s1) {
  for (int j = threadIdx.x; j < s1 - s0; j += NT) sidx[j] = tile_idx[s0 + j];
  __syncthreads();
}

// Main-path instantiation: unpacked, K = 16, MB = M = 64, BLK = 1 << lb,
// and QT = 1 (QC = 1) or a multiple of QC = 8.  slut holds the group's QT
// tables, then the CTA's positions.
template <int QC>
__global__ void __launch_bounds__(NT) pq_scan_fast(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int lb,
    int S, int QT, int QS, int s_per) {
  constexpr int TAB = FAST_MB * FAST_K, V = FAST_MB / 16;
  extern __shared__ float slut[];
  const int qt = QC == 1 ? 1 : QT;
  int* sidx = reinterpret_cast<int*>(slut + qt * TAB);
  const int qi = blockIdx.x, tid = threadIdx.x, BLK = 1 << lb;
  const int s0 = blockIdx.y * s_per, s1 = min(S, s0 + s_per);
  const float* glut = lut + (size_t)qi * QS * TAB;
  for (int j = tid; j < qt * TAB; j += NT) slut[j] = glut[j];
  stage_positions(sidx, tile_idx + (size_t)qi * S, s0, s1);

  const int n = (s1 - s0) << lb;
  const size_t qstride = (size_t)S << lb;  // floats between two queries' rows
  uint4 cur[V], nxt[V];
  auto load_row = [&](int f, uint4(&r)[V]) {
    const uint4* row = reinterpret_cast<const uint4*>(
        codes + (((size_t)sidx[f >> lb] << lb) + (f & (BLK - 1))) * FAST_MB);
#pragma unroll
    for (int v = 0; v < V; ++v) r[v] = __ldg(row + v);
  };
  if (tid < n) load_row(tid, cur);
  for (int f = tid; f < n; f += NT) {
    if (f + NT < n) load_row(f + NT, nxt);
    float* o = out + (size_t)qi * QS * qstride + ((size_t)s0 << lb) + f;
    for (int q0 = 0; q0 < qt; q0 += QC) {
      float acc[QC];
      score_regs<QC, FAST_K, FAST_MB>(acc, cur, slut + q0 * TAB);
#pragma unroll
      for (int q = 0; q < QC; ++q) o[(q0 + q) * qstride] = acc[q];
    }
#pragma unroll
    for (int v = 0; v < V; ++v) cur[v] = nxt[v];
  }
}

// Compact planes: nibble-packed, K = 16, MB = 8 or 16 (M = 2 * MB),
// BLK = 1 << lb, QT = 1 (QC = 1) or a multiple of QC = 8, rows MB-byte
// aligned.  pq_scan_fast's loop over score_packed.
template <int QC, int MB>
__global__ void __launch_bounds__(NT) pq_scan_packed(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int lb,
    int S, int QT, int QS, int s_per) {
  constexpr int TAB = 2 * MB * 16, W = MB / 4;
  extern __shared__ float slut[];
  const int qt = QC == 1 ? 1 : QT;
  int* sidx = reinterpret_cast<int*>(slut + qt * TAB);
  const int qi = blockIdx.x, tid = threadIdx.x, BLK = 1 << lb;
  const int s0 = blockIdx.y * s_per, s1 = min(S, s0 + s_per);
  const float* glut = lut + (size_t)qi * QS * TAB;
  for (int j = tid; j < qt * TAB; j += NT) slut[j] = glut[j];
  stage_positions(sidx, tile_idx + (size_t)qi * S, s0, s1);

  const int n = (s1 - s0) << lb;
  const size_t qstride = (size_t)S << lb;  // floats between two queries' rows
  uint32_t cur[W], nxt[W];
  auto load_row = [&](int f, uint32_t(&r)[W]) {
    const uint8_t* row =
        codes + (((size_t)sidx[f >> lb] << lb) + (f & (BLK - 1))) * MB;
    if constexpr (MB == 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row));
      r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
    } else {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row));
      r[0] = v.x, r[1] = v.y;
    }
  };
  if (tid < n) load_row(tid, cur);
  for (int f = tid; f < n; f += NT) {
    if (f + NT < n) load_row(f + NT, nxt);
    float* o = out + (size_t)qi * QS * qstride + ((size_t)s0 << lb) + f;
    for (int q0 = 0; q0 < qt; q0 += QC) {
      float acc[QC];
      score_packed<QC, MB>(acc, cur, slut + q0 * TAB);
#pragma unroll
      for (int q = 0; q < QC; ++q) o[(q0 + q) * qstride] = acc[q];
    }
#pragma unroll
    for (int v = 0; v < W; ++v) cur[v] = nxt[v];
  }
}

// Every other shape whose tables fit in shared memory: runtime K and MB,
// packed or not; queries in chunks of up to QC.  Two CTAs per SM at
// least: left alone, ptxas hoists all 128 table reads of a 16-byte piece
// for QC = 8 and takes 254 registers.
template <int QC, bool PACKED>
__global__ void __launch_bounds__(NT, 2) pq_scan_generic(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int M,
    int K, int BLK, int MB, int S, int QT, int QS, int s_per, int vec16) {
  extern __shared__ float slut[];
  const int tab = M * K;
  int* sidx = reinterpret_cast<int*>(slut + QT * tab);
  const int qi = blockIdx.x, tid = threadIdx.x;
  const int s0 = blockIdx.y * s_per, s1 = min(S, s0 + s_per);
  const float* glut = lut + (size_t)qi * QS * tab;
  for (int j = tid; j < QT * tab; j += NT) slut[j] = glut[j];
  stage_positions(sidx, tile_idx + (size_t)qi * S, s0, s1);

  const int n = (s1 - s0) * BLK;
  for (int f = tid; f < n; f += NT) {
    const int p = f / BLK, i = f - p * BLK;
    const uint8_t* row = codes + ((size_t)sidx[p] * BLK + i) * MB;
    float* o = out + ((size_t)qi * QS * S + s0 + p) * BLK + i;
    for (int q0 = 0; q0 < QT; q0 += QC) {
      const int nq = min(QC, QT - q0);
      float acc[QC];
      score_row_queries<QC, PACKED>(acc, row, slut + q0 * tab, tab, K, MB,
                                    nq, vec16 != 0);
#pragma unroll
      for (int q = 0; q < QC; ++q)
        if (q < nq) o[(size_t)(q0 + q) * S * BLK] = acc[q];
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until all of this thread's copies have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The staged form's range of R subquantizers (R = SR, or SR1 for one
// query) and its layout in shared memory.  One query: two range buffers
// of [R][SK] floats, a lookup one LDS.  A tile (QC = SQ = 8 queries): a
// raw buffer of [SQ][R][SK] floats that cp.async fills, and a range buffer
// of [R][2][SK][4] floats that the CTA transposes it into, each code's
// entries for queries 4h .. 4h + 3 side by side, so that a lookup for four
// queries is one LDS.128 (the halves h a table apart, so a warp's 16-byte
// reads spread over all 8 bank groups).
template <int QC>
struct Staged {
  static constexpr int R = QC == 1 ? SR1 : SR;
  static constexpr int BUF = R * SK * (QC == 1 ? 1 : SQ);  // floats
  // the next range's code bytes loaded while this range is scored
  static constexpr bool PREFETCH = QC != 1;
  // CTAs an SM holds at least (the register cap)
  static constexpr int MIN_CTAS = QC == 1 ? 3 : 1;
};

// Start copying the tables of subquantizers [m0, m0 + nr) of `nq` queries
// (M * K floats apart from `glut`) into `dst` ([nq][R][SK] floats), every
// thread a share: 16 bytes a copy where K % 4 == 0 and the tables are
// 16-byte aligned (`c16`), else 4.  At K = SK a query's range is one run
// at both ends.
template <int R>
__device__ __forceinline__ void stage_rows(float* dst, const float* glut,
                                           int M, int K, int nq, int m0,
                                           int nr, bool c16) {
  if (c16 && K == SK) {
    for (int q = 0; q < nq; ++q) {
      float* d = dst + q * R * SK;
      const float* s = glut + ((size_t)q * M + m0) * K;
      for (int c = 4 * threadIdx.x; c < nr * SK; c += 4 * NT)
        cp_async16(d + c, s + c);
    }
    return;
  }
  const int w = c16 ? 4 : 1, kw = K / w;
  for (int c = threadIdx.x; c < nq * nr * kw; c += NT) {
    const int row = c / kw, e = w * (c - row * kw), q = row / nr;
    const int j = row - q * nr;
    float* d = dst + (q * R + j) * SK + e;
    const float* s = glut + ((size_t)q * M + m0 + j) * K + e;
    if (c16)
      cp_async16(d, s);
    else
      cp_async4(d, s);
  }
}

// A tile's raw range ([SQ][R][SK]) into its range buffer ([R][2][SK][4]):
// each 16-byte entry group gathered from four queries' rows.
template <int R>
__device__ __forceinline__ void interleave(float* dst, const float* raw,
                                           int nr) {
  for (int c = threadIdx.x; c < nr * 2 * SK; c += NT) {
    const int code = c % SK, h = (c / SK) & 1, j = c / (2 * SK);
    const float* s = raw + (4 * h * R + j) * SK + code;
    reinterpret_cast<float4*>(dst)[c] =
        make_float4(s[0], s[R * SK], s[2 * R * SK], s[3 * R * SK]);
  }
}

// Tables too large for shared memory (one query's alone pass 227 KB): the
// tables of the launch's QT <= SQ queries staged R subquantizers at a
// time (Staged<QC>), and each thread's IPT items scored against every
// range with their QT sums carried in registers, ascending m.  One query:
// double-buffered, the next range's copy in flight while this one is
// scored, one barrier a range.  A tile: the next range's raw copy in
// flight while this one is scored, then interleaved between two barriers.
// The items' code bytes of the next range are loaded while this one is
// scored (Staged::PREFETCH).  Grid: T * splits CTAs, split fastest; CTA x
// scans positions [y * s_per, min(S, (y + 1) * s_per)) of tile x / splits,
// y = x % splits, in passes of IPT * NT items.  Shared memory: two range
// buffers (or a raw buffer and a range buffer), then the positions.
template <int QC, bool PACKED>
__global__ void __launch_bounds__(NT, Staged<QC>::MIN_CTAS) pq_scan_staged(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int M,
    int K, int BLK, int MB, int S, int QT, int QS, int s_per, int splits) {
  constexpr int R = Staged<QC>::R, BUF = Staged<QC>::BUF;
  constexpr bool PREFETCH = Staged<QC>::PREFETCH;
  constexpr bool RAW = QC != 1;  // a raw range, then the range buffer
  constexpr int CB = PACKED ? R / 2 : R, CW = CB / 4;  // code bytes, words
  extern __shared__ __align__(16) unsigned char staged_smem[];
  float* tabs = reinterpret_cast<float*>(staged_smem);
  float* raw = tabs + BUF;  // the second range buffer, or the raw range
  const int nq = QC == 1 ? 1 : QT;
  int* sidx = reinterpret_cast<int*>(tabs + 2 * BUF);
  const int qi = blockIdx.x / splits, tid = threadIdx.x;
  const int s0 = (blockIdx.x - qi * splits) * s_per, s1 = min(S, s0 + s_per);
  const float* glut = lut + (size_t)qi * QS * M * K;
  stage_positions(sidx, tile_idx + (size_t)qi * S, s0, s1);

  const int n = (s1 - s0) * BLK, ranges = (M + R - 1) / R;
  const bool c16 =
      K % 4 == 0 && (reinterpret_cast<uintptr_t>(glut) & 15) == 0;
  const bool vec =
      MB % CB == 0 && reinterpret_cast<uintptr_t>(codes) % CB == 0;
  // range r's copy into the range buffer it is scored from (r's parity)
  // or into the raw range
  auto stage = [&](int r) {
    const int m0 = r * R, nr = min(R, M - m0);
    stage_rows<R>(RAW ? raw : tabs + (r & 1) * BUF, glut, M, K, nq, m0, nr,
                  c16);
    cp_async_commit();
  };
  float* o = out + ((size_t)qi * QS * S + s0) * BLK;
  const size_t qstride = (size_t)S * BLK;  // floats between two queries' rows
  for (int p0 = 0; p0 < n; p0 += IPT * NT) {
    const int first = p0 + tid;
    const int cnt = first < n ? min(IPT, (n - first + NT - 1) / NT) : 0;
    uint32_t item[IPT];  // code rows of this thread's items in the pass
    float acc[IPT][QC];
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int f = first + i * NT, p = f / BLK;
      item[i] = i < cnt ? (uint32_t)sidx[p] * BLK + f - p * BLK : 0u;
#pragma unroll
      for (int q = 0; q < QC; ++q) acc[i][q] = 0.f;
    }
    // the code bytes of subquantizers [m0, m0 + R) of each item, zero
    // past M
    uint32_t w[IPT][CW], wn[IPT][CW] = {};
    auto load_codes = [&](uint32_t(&d)[IPT][CW], int m0) {
      const int nr = min(R, M - m0);
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
#pragma unroll
        for (int v = 0; v < CW; ++v) d[i][v] = 0u;
        if (i >= cnt) continue;
        const uint8_t* pc =
            codes + (size_t)item[i] * MB + (PACKED ? m0 / 2 : m0);
        if (vec && nr == R) {
          if constexpr (CB == 16) {
            const uint4 v4 = __ldg(reinterpret_cast<const uint4*>(pc));
            d[i][0] = v4.x, d[i][1] = v4.y, d[i][2] = v4.z, d[i][3] = v4.w;
          } else if constexpr (CB == 8) {
            const uint2 v2 = __ldg(reinterpret_cast<const uint2*>(pc));
            d[i][0] = v2.x, d[i][1] = v2.y;
          } else {
            d[i][0] = __ldg(reinterpret_cast<const uint32_t*>(pc));
          }
        } else {
          const int nb = PACKED ? (nr + 1) / 2 : nr;
#pragma unroll
          for (int b = 0; b < CB; ++b)
            if (b < nb)
              d[i][b >> 2] |= (uint32_t)__ldg(pc + b) << (8 * (b & 3));
        }
      }
    };
    if constexpr (PREFETCH) load_codes(w, 0);
    stage(0);
    if constexpr (RAW) {
      cp_async_wait_all();
      __syncthreads();
      interleave<R>(tabs, raw, min(R, M));
      __syncthreads();
      if (ranges > 1) stage(1);
    }
    for (int r = 0; r < ranges; ++r) {
      const int m0 = r * R, nr = min(R, M - m0);
      if constexpr (!PREFETCH) load_codes(w, m0);
      if constexpr (!RAW) {
        // range r's tables have landed, and every thread is done with
        // range r - 1, whose buffer range r + 1 takes
        cp_async_wait_all();
        __syncthreads();
        if (r + 1 < ranges) stage(r + 1);
      }
      if constexpr (PREFETCH)
        if (r + 1 < ranges) load_codes(wn, m0 + R);
      const float* tb = RAW ? tabs : tabs + (r & 1) * BUF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
#pragma unroll
        for (int i = 0; i < IPT; ++i) {
          if (j >= nr || i >= cnt) continue;
          const uint32_t code =
              PACKED ? (w[i][j >> 3] >> (4 * (j & 7))) & 15u
                     : (w[i][j >> 2] >> (8 * (j & 3))) & 255u;
          if constexpr (QC == 1) {
            acc[i][0] = acc[i][0] + tb[j * SK + code];
          } else {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float4 e = *reinterpret_cast<const float4*>(
                  tb + 4 * ((2 * j + h) * SK + code));
              acc[i][4 * h] = acc[i][4 * h] + e.x;
              acc[i][4 * h + 1] = acc[i][4 * h + 1] + e.y;
              acc[i][4 * h + 2] = acc[i][4 * h + 2] + e.z;
              acc[i][4 * h + 3] = acc[i][4 * h + 3] + e.w;
            }
          }
        }
      }
      if constexpr (RAW) {
        // range r + 1's raw copy has landed and range r is scored: the
        // range buffer takes range r + 1, and the raw range r + 2
        if (r + 1 < ranges) {
          cp_async_wait_all();
          __syncthreads();
          interleave<R>(tabs, raw, min(R, M - m0 - R));
          __syncthreads();
          if (r + 2 < ranges) stage(r + 2);
        }
      }
      if constexpr (PREFETCH) {
#pragma unroll
        for (int i = 0; i < IPT; ++i)
#pragma unroll
          for (int v = 0; v < CW; ++v) w[i][v] = wn[i][v];
      }
    }
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      if (i >= cnt) continue;
#pragma unroll
      for (int q = 0; q < QC; ++q)
        if (q < nq) o[q * qstride + first + i * NT] = acc[i][q];
    }
    __syncthreads();  // the last range's buffer is read: the next pass
                      // may stage over it
  }
}

// ---------------------------------------------------------------------------
// The K = 256 form (k256): unpacked K = 256 codes, MB = M, whose one
// query's tables fit in a CTA's shared memory (PQ64x8: 64 KB), any QT, one
// launch a call.  The generic loop scored such a tile in query groups (a
// tile of 8 queries is 512 KB of tables: three launches, each reading the
// tile's code rows and positions again) at one CTA an SM, with runtime K
// and MB and a scalar lookup per (item, query).
// ---------------------------------------------------------------------------
constexpr int KR = 4;     // subquantizers in a range of a tile's tables
constexpr int KQ = 8;     // queries a tile CTA carries (two LDS.128 each)
constexpr int KIPT = 8;   // items a tile thread carries through a pass
constexpr int KNT = 256;  // threads of a tile CTA (KIPT * KNT = 2048 items
                          // a pass: kernels/pq_scan.py's K1_STAGED_PASS)
constexpr int K256 = 256;
static_assert(KR == 4 || KR == 8, "a range's code bytes are one or two words");

// One query (QT = 1): its M x 256 table in shared memory, copied by
// cp.async in 16-byte pieces, three CTAs an SM (65 KB each at M 64).  A
// thread scores items tid, tid + NT, ... of the CTA's positions; an item's
// row is read in CH-byte pieces (CH = 16 where M % 16 == 0 and the rows
// are 16-byte aligned, else 8), the next piece (of this item, or the first
// of its next) loaded while this one is scored, each byte extracted once
// (adc.cuh's score_k256_piece).  A lookup at K 256 is one LDS at ~3
// wavefronts (a warp's 32 random codes fall on ~3 entries of the busiest
// bank): the lookups set the pace, the pieces in flight hide the loads.
template <int CH>
__global__ void __launch_bounds__(NT, 3) pq_scan_k256_one(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int M,
    int BLK, int S, int QS, int s_per) {
  using Piece = typename K256Piece<CH>::type;
  extern __shared__ __align__(16) unsigned char k256_smem[];
  float* tab = reinterpret_cast<float*>(k256_smem);
  int* pidx = reinterpret_cast<int*>(tab + M * K256);
  const int qi = blockIdx.x, tid = threadIdx.x;
  const int s0 = blockIdx.y * s_per, s1 = min(S, s0 + s_per);
  const float* glut = lut + (size_t)qi * QS * M * K256;
  for (int c = 4 * tid; c < M * K256; c += 4 * NT) cp_async16(tab + c, glut + c);
  cp_async_commit();
  for (int j = tid; j < s1 - s0; j += NT) pidx[j] = tile_idx[(size_t)qi * S + s0 + j];
  cp_async_wait_all();
  __syncthreads();

  const int n = (s1 - s0) * BLK, P = M / CH;  // items, pieces a row
  float* o = out + ((size_t)qi * QS * S + s0) * BLK;
  auto row_of = [&](int f) {
    const int p = f / BLK;
    return reinterpret_cast<const Piece*>(
        codes + ((size_t)pidx[p] * BLK + (f - p * BLK)) * M);
  };
  int f = tid;
  const Piece* row = f < n ? row_of(f) : nullptr;
  Piece cur = {};
  if (row) cur = __ldg(row);
  while (f < n) {
    const int fn = f + NT;
    const Piece* next_row = fn < n ? row_of(fn) : nullptr;
    float acc = 0.f;
    for (int v = 0; v < P; ++v) {
      Piece nxt = {};
      if (v + 1 < P)
        nxt = __ldg(row + v + 1);
      else if (next_row)
        nxt = __ldg(next_row);
      acc = score_k256_piece<CH>(acc, cur, tab + v * CH * K256);
      cur = nxt;
    }
    o[f] = acc;
    f = fn;
    row = next_row;
  }
}

// A tile's tables interleaved by query for pq_scan_k256_tile: for each
// tile t and group g of KQ queries, [M][2][256] float4s, the float4 of
// (m, h, code) holding queries 8g + 4h + j, j < 4, of the tile (0 past
// QT).  Every thread writes float4s; neighbouring threads read
// neighbouring entries of one table.
__global__ void __launch_bounds__(NT) k256_interleave(
    const float* __restrict__ lut, float4* __restrict__ il, int T, int QS,
    int QT, int G, int M) {
  const size_t n = (size_t)T * G * M * 2 * K256;
  for (size_t e = (size_t)blockIdx.x * NT + threadIdx.x; e < n;
       e += (size_t)gridDim.x * NT) {
    const int code = (int)(e % K256);
    size_t r = e / K256;
    const int h = (int)(r & 1);
    r >>= 1;
    const int m = (int)(r % M);
    r /= M;
    const int g = (int)(r % G), t = (int)(r / G);
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = KQ * g + 4 * h + j;
      v[j] = q < QT ? lut[((size_t)(t * QS + q) * M + m) * K256 + code] : 0.f;
    }
    il[e] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Query tiles (QT > 1): KQ queries a CTA, QT > KQ in groups of KQ over
// the grid.  The tiles' tables are interleaved first (k256_interleave, into
// a scratch tensor the wrapper allocates), so a range of KR subquantizers
// of a group is one run of KR x 8 KB that cp.async copies into a range
// buffer as it is; two buffers, the next range's copy in flight while this
// one is scored, one barrier a range.  One LDS.128 serves four queries.
// Ranges of 4 (two 32 KB buffers, 128 registers) hold two CTAs an SM,
// which measured faster than ranges of 8 at one CTA an SM
// (tools/k1_limits.py --nbits8, "k256 ranges of 8").
// Each thread carries the sums of its KIPT items for the group's queries
// in registers from one range to the next (one accumulator per (item,
// query), ascending m) and reads each item's code bytes of a range once
// for all of them, the next range's while this one is scored.  Grid: T *
// G * splits CTAs, split fastest (a tile group's splits are adjacent, so
// its tables come from device memory about once); CTA x scans positions
// [y * s_per, min(S, (y + 1) * s_per)) of group x / splits % G of tile x /
// splits / G, y = x % splits, in passes of KIPT * NT items
// (kernels/pq_scan.py::staged_splits: one pass a CTA).
__global__ void __launch_bounds__(KNT, 2) pq_scan_k256_tile(
    const float4* __restrict__ il, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int M,
    int BLK, int S, int QT, int QS, int G, int s_per, int splits) {
  constexpr int BUF = KR * 2 * K256;  // float4s of a range buffer
  extern __shared__ __align__(16) unsigned char k256_smem[];
  float4* tabs = reinterpret_cast<float4*>(k256_smem);
  int* pidx = reinterpret_cast<int*>(tabs + 2 * BUF);
  const int tid = threadIdx.x, tg = blockIdx.x / splits;
  const int g = tg % G, qi = tg / G;
  const int s0 = (blockIdx.x - tg * splits) * s_per, s1 = min(S, s0 + s_per);
  const int q0 = KQ * g, nq = min(KQ, QT - q0);
  const bool upper = nq > 4;  // queries 4 .. 7 of the group exist
  const float4* gtab = il + (size_t)tg * M * 2 * K256;
  for (int j = tid; j < s1 - s0; j += KNT) pidx[j] = tile_idx[(size_t)qi * S + s0 + j];
  __syncthreads();

  const int n = (s1 - s0) * BLK, ranges = (M + KR - 1) / KR;
  const bool vec = M % KR == 0 && reinterpret_cast<uintptr_t>(codes) % KR == 0;
  auto stage = [&](int r) {
    const int m0 = r * KR, nr = min(KR, M - m0);
    float4* d = tabs + (r & 1) * BUF;
    const float4* src = gtab + (size_t)m0 * 2 * K256;
    for (int c = tid; c < nr * 2 * K256; c += KNT) cp_async16(d + c, src + c);
    cp_async_commit();
  };
  float* o = out + ((size_t)(qi * QS + q0) * S + s0) * BLK;
  const size_t qstride = (size_t)S * BLK;  // floats between two queries' rows
  for (int p0 = 0; p0 < n; p0 += KIPT * KNT) {
    const int first = p0 + tid;
    const int cnt = first < n ? min(KIPT, (n - first + KNT - 1) / KNT) : 0;
    const uint8_t* rows[KIPT];  // this thread's items' code rows
    float acc[KIPT][KQ];
#pragma unroll
    for (int i = 0; i < KIPT; ++i) {
      const int f = first + i * KNT, p = f / BLK;
      rows[i] = i < cnt ? codes + ((size_t)pidx[p] * BLK + f - p * BLK) * M
                        : codes;
#pragma unroll
      for (int q = 0; q < KQ; ++q) acc[i][q] = 0.f;
    }
    // the code bytes of subquantizers [m0, m0 + KR) of each item (KW
    // words), zero past M
    constexpr int KW = KR / 4;
    uint32_t w[KIPT][KW], wn[KIPT][KW] = {};
    auto range_codes = [&](uint32_t(&d)[KIPT][KW], int m0) {
      const int nr = min(KR, M - m0);
#pragma unroll
      for (int i = 0; i < KIPT; ++i) {
#pragma unroll
        for (int v = 0; v < KW; ++v) d[i][v] = 0u;
        if (i >= cnt) continue;
        if (vec) {
          if constexpr (KW == 2) {
            const uint2 v2 =
                __ldg(reinterpret_cast<const uint2*>(rows[i] + m0));
            d[i][0] = v2.x, d[i][KW - 1] = v2.y;
          } else {
            d[i][0] = __ldg(reinterpret_cast<const uint32_t*>(rows[i] + m0));
          }
        } else {
          for (int b = 0; b < nr; ++b)
            d[i][b >> 2] |= (uint32_t)__ldg(rows[i] + m0 + b) << (8 * (b & 3));
        }
      }
    };
    range_codes(w, 0);
    stage(0);
    for (int r = 0; r < ranges; ++r) {
      const int m0 = r * KR, nr = min(KR, M - m0);
      // range r has landed, and every thread is done with range r - 1,
      // whose buffer range r + 1 takes
      cp_async_wait_all();
      __syncthreads();
      if (r + 1 < ranges) {
        stage(r + 1);
        range_codes(wn, m0 + KR);
      }
      const float4* tb = tabs + (r & 1) * BUF;
#pragma unroll
      for (int j = 0; j < KR; ++j) {
#pragma unroll
        for (int i = 0; i < KIPT; ++i) {
          if (j >= nr || i >= cnt) continue;
          const uint32_t code = (w[i][j >> 2] >> (8 * (j & 3))) & 255u;
          const float4 lo = tb[(2 * j) * K256 + code];
          acc[i][0] = acc[i][0] + lo.x;
          acc[i][1] = acc[i][1] + lo.y;
          acc[i][2] = acc[i][2] + lo.z;
          acc[i][3] = acc[i][3] + lo.w;
          if (upper) {
            const float4 hi = tb[(2 * j + 1) * K256 + code];
            acc[i][4] = acc[i][4] + hi.x;
            acc[i][5] = acc[i][5] + hi.y;
            acc[i][6] = acc[i][6] + hi.z;
            acc[i][7] = acc[i][7] + hi.w;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < KIPT; ++i)
#pragma unroll
        for (int v = 0; v < KW; ++v) w[i][v] = wn[i][v];
    }
#pragma unroll
    for (int i = 0; i < KIPT; ++i) {
      if (i >= cnt) continue;
#pragma unroll
      for (int q = 0; q < KQ; ++q)
        if (q < nq) o[q * qstride + first + i * KNT] = acc[i][q];
    }
    __syncthreads();  // the last range's buffer is read: the next pass
                      // may stage over it
  }
}

template <int THREADS = NT, typename Kern, typename... Args>
cudaError_t launch(Kern kern, dim3 grid, size_t smem, cudaStream_t st,
                   Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, THREADS, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one CTA, by where its tables are (`tables`):
// 0, QT queries' tables; 1 (the staged form, global tables), two range
// buffers (Staged<1> for one query, Staged<SQ> for up to SQ); 2 (the k256
// form), one query's table at QT 1, else two range buffers of KR
// subquantizers of KQ queries; then the CTA's s_per staged positions.  The
// wrapper picks the form and cuts a tile into query groups by it
// (kernels/pq_scan.py::k1_query_groups).
size_t pq_scan_tiled_smem_bytes(int M, int K, int QT, int s_per,
                                int tables) {
  size_t floats = (size_t)QT * M * K;
  if (tables == 1)
    floats = QT < 1 ? 0 : 2 * (QT == 1 ? Staged<1>::BUF : Staged<SQ>::BUF);
  else if (tables == 2)
    floats = QT < 1 ? 0 : QT == 1 ? (size_t)M * K : 2 * KR * 2 * K256 * 4;
  return floats * sizeof(float) + (size_t)s_per * sizeof(int);
}

// Bytes of the scratch tensor of a k256 launch of QT > 1 queries of B / QS
// tiles (the interleaved tables, k256_interleave); 0 for any other launch.
size_t pq_scan_tiled_scratch_bytes(int B, int M, int QT, int QS, int form) {
  if (form != K256_FORM || QT <= 1 || QS < 1) return 0;
  const size_t groups = (QT + KQ - 1) / KQ;
  return (size_t)(B / QS) * groups * M * 2 * K256 * sizeof(float4);
}

// lut (B, M, K) f32; codes (TB, BLK, MB) u8; tile_idx (B / QS, S) i32;
// out (B, S, BLK) f32.  All contiguous; M == (packed ? 2 * MB : MB).  A
// tile has QS query rows; this launch scores QT of them: lut and out point
// at the group's first row of tile 0, rows qi * QS + [0, QT) of each tile.
// A CTA scans s_per of a tile's positions.  `form` (enum Form) is
// kernels/pq_scan.py::k1_form's choice; a shape the form does not take
// returns cudaErrorInvalidValue.  `scratch` (pq_scan_tiled_scratch_bytes)
// is the k256 form's interleaved tables at QT > 1, else unused.
int pq_scan_tiled_launch(const void* lut, const void* codes,
                         const void* tile_idx, void* out, int B, int M, int K,
                         int BLK, int MB, int S, int QT, int QS, int packed,
                         int s_per, int form, void* scratch, void* stream) {
  const int bad = (int)cudaErrorInvalidValue;
  if (QS < 1 || B % QS != 0 || QT < 1 || QT > QS || BLK < 1 || s_per < 1 ||
      s_per > MAX_POSITIONS || M != (packed ? 2 * MB : MB))
    return bad;
  const int T = B / QS;
  if (T == 0 || S == 0) return 0;
  const int splits = (S + s_per - 1) / s_per;
  const size_t smem = pq_scan_tiled_smem_bytes(
      M, K, QT, s_per, form == STAGED ? 1 : form == K256_FORM ? 2 : 0);
  const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
  const int lb = __builtin_ctz((unsigned)BLK);
  const bool pow2 = BLK == 1 << lb, tiles8 = QT == 1 || QT % 8 == 0;
  const int vec16 = (MB % 16 == 0) && (at % 16 == 0);
  const dim3 grid(T, splits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int32_t* ti = static_cast<const int32_t*>(tile_idx);
  float* o = static_cast<float*>(out);
  switch (form) {
    case FAST:
      if (packed || K != FAST_K || MB != FAST_MB || !vec16 || !pow2 ||
          !tiles8)
        return bad;
      return (int)(QT == 1 ? launch(pq_scan_fast<1>, grid, smem, st, l, c,
                                    ti, o, lb, S, QT, QS, s_per)
                           : launch(pq_scan_fast<8>, grid, smem, st, l, c,
                                    ti, o, lb, S, QT, QS, s_per));
    case PACKED:
      if (!packed || K != 16 || (MB != 8 && MB != 16) || at % MB != 0 ||
          !pow2 || !tiles8)
        return bad;
      if (MB == 8)
        return (int)(QT == 1 ? launch(pq_scan_packed<1, 8>, grid, smem, st,
                                      l, c, ti, o, lb, S, QT, QS, s_per)
                             : launch(pq_scan_packed<8, 8>, grid, smem, st,
                                      l, c, ti, o, lb, S, QT, QS, s_per));
      return (int)(QT == 1 ? launch(pq_scan_packed<1, 16>, grid, smem, st, l,
                                    c, ti, o, lb, S, QT, QS, s_per)
                           : launch(pq_scan_packed<8, 16>, grid, smem, st, l,
                                    c, ti, o, lb, S, QT, QS, s_per));
    case GENERIC: {
      auto kern = packed ? (QT == 1 ? pq_scan_generic<1, true>
                                    : pq_scan_generic<8, true>)
                         : (QT == 1 ? pq_scan_generic<1, false>
                                    : pq_scan_generic<8, false>);
      return (int)launch(kern, grid, smem, st, l, c, ti, o, M, K, BLK, MB, S,
                         QT, QS, s_per, vec16);
    }
    case STAGED: {
      if (QT > SQ || K > SK || (long long)T * splits > 0x7fffffffLL)
        return bad;
      auto kern = packed ? (QT == 1 ? pq_scan_staged<1, true>
                                    : pq_scan_staged<SQ, true>)
                         : (QT == 1 ? pq_scan_staged<1, false>
                                    : pq_scan_staged<SQ, false>);
      return (int)launch(kern, dim3(T * splits), smem, st, l, c, ti, o, M, K,
                         BLK, MB, S, QT, QS, s_per, splits);
    }
    case K256_FORM: {
      // unpacked K 256, the table 16-byte aligned; at QT 1 the rows in
      // pieces of 8 or 16 bytes
      if (packed || K != K256 || MB != M ||
          reinterpret_cast<uintptr_t>(lut) % 16 != 0 ||
          (size_t)M * K256 * sizeof(float) + sizeof(int) > 232448)
        return bad;
      if (QT == 1) {
        if (M % 8 != 0 || at % 8 != 0) return bad;
        return (int)(M % 16 == 0 && at % 16 == 0
                         ? launch(pq_scan_k256_one<16>, grid, smem, st, l, c,
                                  ti, o, M, BLK, S, QS, s_per)
                         : launch(pq_scan_k256_one<8>, grid, smem, st, l, c,
                                  ti, o, M, BLK, S, QS, s_per));
      }
      const int G = (QT + KQ - 1) / KQ;
      if (scratch == nullptr ||
          (long long)T * G * splits > 0x7fffffffLL)
        return bad;
      float4* il = static_cast<float4*>(scratch);
      const size_t n = (size_t)T * G * M * 2 * K256;
      const int blocks = (int)((n + NT - 1) / NT < 8 * 132 * 4
                                   ? (n + NT - 1) / NT
                                   : 8 * 132 * 4);
      k256_interleave<<<blocks, NT, 0, st>>>(l, il, T, QS, QT, G, M);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      return (int)launch<KNT>(pq_scan_k256_tile, dim3(T * G * splits), smem,
                              st,
                         static_cast<const float4*>(il), c, ti, o, M, BLK, S,
                         QT, QS, G, s_per, splits);
    }
    default:
      return bad;
  }
}

}  // extern "C"
