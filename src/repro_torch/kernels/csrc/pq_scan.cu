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
// Any other shape (K up to 256, packed planes, odd widths, QT not 1 or a
// multiple of 8) runs through the generic instantiation of the same loop:
// runtime K and MB, the row read in 16-byte pieces (or bytes), each piece's
// bytes extracted once for a chunk of up to 8 queries.
// Where one query's tables alone pass a CTA's shared memory (M = 256 at
// K = 256 is 256 KB), the generic loop reads them from global memory
// through the read-only cache (adc.cuh's LdgTable), in the same order, and
// shared memory holds only the staged positions: the whole tile is one
// launch, and a tile's tables (2 MB for 8 such queries) stay in the L2.
// The shape alone picks this form (kernels/pq_scan.py::query_groups).
// Entries of tile_idx must lie in [0, TB): callers clamp padding to 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"

namespace {

constexpr int NT = 256;           // threads of a CTA (K1_THREADS)
constexpr int MAX_POSITIONS = 1024;  // tile_idx entries a CTA stages
constexpr int FAST_K = 16, FAST_MB = 64;

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

// Every other shape: runtime K and MB, packed or not; queries in chunks of
// up to QC; tables in shared memory, or in global memory (GT).  Two CTAs
// per SM at least: left alone, ptxas hoists all 128 table reads of a
// 16-byte piece for QC = 8 and takes 254 registers.
template <int QC, bool PACKED, bool GT>
__global__ void __launch_bounds__(NT, 2) pq_scan_generic(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ tile_idx, float* __restrict__ out, int M,
    int K, int BLK, int MB, int S, int QT, int QS, int s_per, int vec16) {
  extern __shared__ float slut[];
  const int tab = M * K;
  int* sidx = reinterpret_cast<int*>(GT ? slut : slut + QT * tab);
  const int qi = blockIdx.x, tid = threadIdx.x;
  const int s0 = blockIdx.y * s_per, s1 = min(S, s0 + s_per);
  const float* glut = lut + (size_t)qi * QS * tab;
  if (!GT)
    for (int j = tid; j < QT * tab; j += NT) slut[j] = glut[j];
  stage_positions(sidx, tile_idx + (size_t)qi * S, s0, s1);
  const auto tabs = tables<GT>(glut, slut);

  const int n = (s1 - s0) * BLK;
  for (int f = tid; f < n; f += NT) {
    const int p = f / BLK, i = f - p * BLK;
    const uint8_t* row = codes + ((size_t)sidx[p] * BLK + i) * MB;
    float* o = out + ((size_t)qi * QS * S + s0 + p) * BLK + i;
    for (int q0 = 0; q0 < QT; q0 += QC) {
      const int nq = min(QC, QT - q0);
      float acc[QC];
      score_row_queries<QC, PACKED>(acc, row, tabs + (size_t)q0 * tab, tab,
                                    K, MB, nq, vec16 != 0);
#pragma unroll
      for (int q = 0; q < QC; ++q)
        if (q < nq) o[(size_t)(q0 + q) * S * BLK] = acc[q];
    }
  }
}

template <typename Kern>
cudaError_t prepare(Kern kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

using GenericKernel = decltype(&pq_scan_generic<1, false, false>);

template <bool GT>
GenericKernel generic_kernel(bool packed, bool one_query) {
  return packed ? (one_query ? pq_scan_generic<1, true, GT>
                             : pq_scan_generic<8, true, GT>)
                : (one_query ? pq_scan_generic<1, false, GT>
                             : pq_scan_generic<8, false, GT>);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one CTA: QT queries' tables (none when they are
// read from global memory), then the CTA's s_per staged positions.  The
// wrapper picks the form and cuts a tile into query groups by it
// (kernels/pq_scan.py::query_groups).
size_t pq_scan_tiled_smem_bytes(int M, int K, int QT, int s_per,
                                int global_tables) {
  return (global_tables ? 0 : (size_t)QT * M * K * sizeof(float)) +
         (size_t)s_per * sizeof(int);
}

// lut (B, M, K) f32; codes (TB, BLK, MB) u8; tile_idx (B / QS, S) i32;
// out (B, S, BLK) f32.  All contiguous; M == (packed ? 2 * MB : MB).  A
// tile has QS query rows; this launch scores QT of them: lut and out point
// at the group's first row of tile 0, rows qi * QS + [0, QT) of each tile.
// CTA (tile, y) scans positions [y * s_per, min(S, (y + 1) * s_per)).
// global_tables: read the tables from global memory (generic loop only).
int pq_scan_tiled_launch(const void* lut, const void* codes,
                         const void* tile_idx, void* out, int B, int M, int K,
                         int BLK, int MB, int S, int QT, int QS, int packed,
                         int s_per, int global_tables, void* stream) {
  if (QS < 1 || B % QS != 0 || QT < 1 || QT > QS || BLK < 1 || s_per < 1 ||
      s_per > MAX_POSITIONS)
    return (int)cudaErrorInvalidValue;
  const int T = B / QS;
  if (T == 0 || S == 0) return 0;
  const int splits = (S + s_per - 1) / s_per;
  const size_t smem =
      pq_scan_tiled_smem_bytes(M, K, QT, s_per, global_tables);
  const int vec16 =
      (MB % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid(T, splits), block(NT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lut);
  const uint8_t* c = static_cast<const uint8_t*>(codes);
  const int32_t* ti = static_cast<const int32_t*>(tile_idx);
  float* o = static_cast<float*>(out);
  cudaError_t err;
  const int lb = __builtin_ctz((unsigned)BLK);
  const bool fast = !packed && !global_tables && K == FAST_K &&
                    MB == FAST_MB && M == FAST_MB && vec16 && BLK == 1 << lb &&
                    (QT == 1 || QT % 8 == 0);
  if (fast && QT == 1) {
    if ((err = prepare(pq_scan_fast<1>, smem)) != cudaSuccess) return (int)err;
    pq_scan_fast<1><<<grid, block, smem, st>>>(l, c, ti, o, lb, S, QT, QS,
                                                s_per);
  } else if (fast) {
    if ((err = prepare(pq_scan_fast<8>, smem)) != cudaSuccess) return (int)err;
    pq_scan_fast<8><<<grid, block, smem, st>>>(l, c, ti, o, lb, S, QT, QS,
                                                s_per);
  } else {
    const GenericKernel kern =
        global_tables ? generic_kernel<true>(packed, QT == 1)
                      : generic_kernel<false>(packed, QT == 1);
    if ((err = prepare(kern, smem)) != cudaSuccess) return (int)err;
    kern<<<grid, block, smem, st>>>(l, c, ti, o, M, K, BLK, MB, S, QT, QS,
                                    s_per, vec16);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
