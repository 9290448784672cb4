// K1: paged PQ fast-scan (unfused ADC scan) for Hopper (sm_90a).
//
// Replaces repro/kernels/pq_scan.py::pq_scan_tiled_kernel (pallas_call at
// pq_scan.py:112, body _make_kernel and _tile_codes), and through it the
// per-query entry pq_scan_paged_kernel (K2).
//
//   out[b, s, i] = sum_m lut[b, m, codes[tile_idx[b / QT, s], i, m]]
//
// The TPU body turns the table lookup into a one-hot (QT, M*K) x (M*K, BLK)
// product on the MXU.  Here it is a plain lookup: one CTA per (query tile,
// range of scan positions) copies the tile's QT x M x K f32 tables into
// shared memory (8 KB per query at M = 64, K = 16), then each thread scores
// one item: it reads the item's code row (16-byte loads when the row width
// allows), unpacks nibbles in registers when `packed`, and sums
// lut[m][code] over ascending m in f32, one add at a time (adc.cuh).  The
// plain PyTorch version (kernels/ref.py) sums in the same order, so the two
// agree bitwise.
//
// Bound on this card: bytes.  Each item costs M table lookups from shared
// memory and M f32 adds for M / 2 (packed) or M bytes of codes and 4 bytes
// of output; the output (B, S, BLK) f32 is the largest stream.  The design
// reads each code row once per query tile (the QT queries of a tile share
// the row through L1) and writes each output once, coalesced across lanes.
// tile_idx is read inside the CTA in place of the TPU's scalar prefetch.
// Entries of tile_idx must lie in [0, TB): callers clamp padding to 0.
#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"

namespace {

template <bool PACKED>
__global__ void pq_scan_tiled(const float* __restrict__ lut,
                              const uint8_t* __restrict__ codes,
                              const int32_t* __restrict__ tile_idx,
                              float* __restrict__ out, int M, int K, int BLK,
                              int MB, int S, int QT, int s_per_cta,
                              int vec16) {
  extern __shared__ float slut[];  // QT * M * K
  const int qi = blockIdx.x;
  const int s0 = blockIdx.y * s_per_cta;
  const int s1 = min(S, s0 + s_per_cta);
  const int n_lut = QT * M * K;
  const float* glut = lut + (size_t)qi * n_lut;
  for (int j = threadIdx.x; j < n_lut; j += blockDim.x) slut[j] = glut[j];
  __syncthreads();
  const int n_items = (s1 - s0) * BLK;
  for (int f = threadIdx.x; f < n_items; f += blockDim.x) {
    const int s = s0 + f / BLK;
    const int i = f % BLK;
    const int blk = tile_idx[(size_t)qi * S + s];
    const uint8_t* row = codes + ((size_t)blk * BLK + i) * MB;
    for (int q = 0; q < QT; ++q) {
      const float acc =
          score_row<PACKED>(row, slut + (size_t)q * M * K, K, MB, vec16 != 0);
      out[((size_t)(qi * QT + q) * S + s) * BLK + i] = acc;
    }
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// lut (B, M, K) f32; codes (TB, BLK, MB) u8; tile_idx (B / QT, S) i32;
// out (B, S, BLK) f32.  All contiguous; M == (packed ? 2 * MB : MB).
int pq_scan_tiled_launch(const void* lut, const void* codes,
                         const void* tile_idx, void* out, int B, int M, int K,
                         int BLK, int MB, int S, int QT, int packed,
                         int s_per_cta, void* stream) {
  if (B % QT != 0 || s_per_cta < 1) return (int)cudaErrorInvalidValue;
  const int T = B / QT;
  if (T == 0 || S == 0) return 0;
  const size_t smem = (size_t)QT * M * K * sizeof(float);
  const int vec16 =
      (MB % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid(T, (S + s_per_cta - 1) / s_per_cta);
  const dim3 block(128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (packed) {
    err = cudaFuncSetAttribute(pq_scan_tiled<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    pq_scan_tiled<true><<<grid, block, smem, st>>>(
        static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(tile_idx), static_cast<float*>(out), M, K,
        BLK, MB, S, QT, s_per_cta, vec16);
  } else {
    err = cudaFuncSetAttribute(pq_scan_tiled<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    pq_scan_tiled<false><<<grid, block, smem, st>>>(
        static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
        static_cast<const int32_t*>(tile_idx), static_cast<float*>(out), M, K,
        BLK, MB, S, QT, s_per_cta, vec16);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
