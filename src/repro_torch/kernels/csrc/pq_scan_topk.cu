// K3: fused PQ fast-scan -> keep mask -> per-query top-F, for Hopper (sm_90a).
//
// Replaces repro/kernels/pq_scan.py::pq_scan_topk_kernel (pallas_call at
// pq_scan.py:311, body _make_topk_kernel) together with its in-kernel
// selection network K4 (repro/kernels/topk.py: bitonic_sort, bitonic_merge,
// merge_topf, _compare_exchange, _lex_le).
//
// The Pallas grid carries the top-F accumulator across scan steps in an
// output block pinned in VMEM.  Hopper runs blocks in no order, so here the
// loop over the S scan positions runs *inside* one CTA per query tile:
//
//   * the tile's QT x M x K f32 tables sit in shared memory, next to a
//     (d, pos, id) buffer of 2 * FW triples per query, FW = pow2 >= max(F,
//     BLK).  The first half is the accumulator, sorted ascending by the
//     lexicographic key (d, pos); the second half takes the next FW
//     candidates (FW / BLK scan positions) of the query;
//   * a candidate is scored only when it is kept: block_ids >= 0 and
//     slot_of >= 0 (item_ok, counted into the DCO), not a misc duplicate
//     (rank_of[b, other] < rank_u[b, s]) and not dead.  Its distance is the
//     same ascending-m f32 sum as K1 (adc.cuh), so the two kernels agree
//     bitwise;
//   * when some candidate of the round beats the current FW-th key of its
//     query (__syncthreads_or), one bitonic sort of each query's 2 * FW
//     buffer leaves the top FW in the first half; otherwise the round is
//     dropped unsorted.  pos = slot * BLK + lane is unique among kept
//     candidates, so the result is the exact top-F under (d, pos) whatever
//     the network, the same set and order as the stable selection of the
//     plain version (kernels/ref.py) and of the reference;
//   * rank_of (QT x nlist int32, 128 KB at nlist = 4096 and QT = 8) is not
//     staged in shared memory: each kept item with a co-assigned list reads
//     its one rank from global memory, where the tile's rows stay in L2.
//
// Bound on this card: bytes of the code tiles, ids and co-lists it pages
// (the outputs are only (B, fetch) triples), plus the selection work in
// shared memory, which the threshold test skips once the accumulator holds
// good candidates.  Masked slots come out as (+inf, PAD_POS, -1).
#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"

namespace {

constexpr int PAD_POS = 1 << 30;

__device__ __forceinline__ bool lex_less(float ad, int ap, float bd, int bp) {
  return ad < bd || (ad == bd && ap < bp);
}

template <bool PACKED>
__global__ void pq_scan_topk(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ block_ids,
    const int32_t* __restrict__ block_other,
    const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ rank_of,
    const int32_t* __restrict__ slot_of, const int32_t* __restrict__ rank_u,
    const uint8_t* __restrict__ dead, float* __restrict__ out_d,
    int32_t* __restrict__ out_pos, int32_t* __restrict__ out_id,
    int32_t* __restrict__ out_dco, int M, int K, int BLK, int MB, int S,
    int QT, int nlist, int FW, int fetch, int vec16) {
  extern __shared__ float smem[];
  const int W2 = 2 * FW;
  float* slut = smem;                       // QT * M * K
  float* bd = slut + QT * M * K;            // QT * W2
  int* bp = reinterpret_cast<int*>(bd + QT * W2);
  int* bi = bp + QT * W2;
  int* sdco = bi + QT * W2;                 // QT
  const int qi = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  const int n_lut = QT * M * K;
  const float* glut = lut + (size_t)qi * n_lut;
  for (int j = tid; j < n_lut; j += nt) slut[j] = glut[j];
  for (int j = tid; j < QT * W2; j += nt) {
    bd[j] = __int_as_float(0x7f800000);
    bp[j] = PAD_POS;
    bi[j] = -1;
  }
  for (int j = tid; j < QT; j += nt) sdco[j] = 0;
  __syncthreads();

  const int P = FW / BLK;  // scan positions per round
  for (int s0 = 0; s0 < S; s0 += P) {
    int any = 0;
    for (int j = tid; j < QT * FW; j += nt) {
      const int q = j / FW;
      const int c = j % FW;
      const int s = s0 + c / BLK;
      const int lane = c % BLK;
      float d = __int_as_float(0x7f800000);
      int pos = PAD_POS;
      int id = -1;
      if (s < S) {
        const int b = qi * QT + q;
        const int blk = tile_idx[(size_t)qi * S + s];
        const size_t item = (size_t)blk * BLK + lane;
        const int iid = block_ids[item];
        const int slot = slot_of[(size_t)b * S + s];
        if (iid >= 0 && slot >= 0) {
          atomicAdd(&sdco[q], 1);
          const int oth = block_other[item];
          const bool dup = oth >= 0 && rank_of[(size_t)b * nlist + oth] <
                                           rank_u[(size_t)b * S + s];
          const bool keep = !dup && (dead == nullptr || dead[item] == 0);
          if (keep) {
            d = score_row<PACKED>(codes + item * MB, slut + (size_t)q * M * K,
                                  K, MB, vec16 != 0);
            pos = slot * BLK + lane;
            id = iid;
          }
        }
      }
      const int base = q * W2;
      if (lex_less(d, pos, bd[base + FW - 1], bp[base + FW - 1])) any = 1;
      bd[base + FW + c] = d;
      bp[base + FW + c] = pos;
      bi[base + FW + c] = id;
    }
    if (!__syncthreads_or(any)) continue;
    // bitonic sort of each query's W2 triples, ascending by (d, pos)
    for (int k = 2; k <= W2; k <<= 1) {
      for (int jj = k >> 1; jj > 0; jj >>= 1) {
        for (int t = tid; t < QT * FW; t += nt) {
          const int q = t / FW;
          const int p = t % FW;
          const int i = 2 * jj * (p / jj) + (p % jj);
          const int l = i + jj;
          const int base = q * W2;
          const float di = bd[base + i], dl = bd[base + l];
          const int pi = bp[base + i], pl = bp[base + l];
          const bool i_first = !lex_less(dl, pl, di, pi);
          const bool asc = (i & k) == 0;
          if (i_first != asc) {
            bd[base + i] = dl;
            bd[base + l] = di;
            bp[base + i] = pl;
            bp[base + l] = pi;
            const int ii = bi[base + i];
            bi[base + i] = bi[base + l];
            bi[base + l] = ii;
          }
        }
        __syncthreads();
      }
    }
  }

  for (int j = tid; j < QT * fetch; j += nt) {
    const int q = j / fetch;
    const int c = j % fetch;
    const size_t o = (size_t)(qi * QT + q) * fetch + c;
    out_d[o] = bd[q * W2 + c];
    out_pos[o] = bp[q * W2 + c];
    out_id[o] = bi[q * W2 + c];
  }
  for (int q = tid; q < QT; q += nt) out_dco[qi * QT + q] = sdco[q];
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one CTA: the layout at the top of pq_scan_topk.
// The wrapper checks it against the card's limit before it launches.
size_t pq_scan_topk_smem_bytes(int M, int K, int QT, int FW) {
  return sizeof(float) * ((size_t)QT * M * K + 3 * (size_t)QT * 2 * FW + QT);
}

// lut (B, M, K) f32; codes (TB, BLK, MB) u8; block_ids / block_other
// (TB, BLK) i32; tile_idx (B / QT, S) i32; rank_of (B, nlist) i32;
// slot_of / rank_u (B, S) i32; dead (TB, BLK) u8 or NULL;
// out_d / out_pos / out_id (B, fetch); out_dco (B,).
// FW is a power of two >= max(fetch, BLK); BLK is a power of two.
int pq_scan_topk_launch(const void* lut, const void* codes,
                        const void* block_ids, const void* block_other,
                        const void* tile_idx, const void* rank_of,
                        const void* slot_of, const void* rank_u,
                        const void* dead, void* out_d, void* out_pos,
                        void* out_id, void* out_dco, int B, int M, int K,
                        int BLK, int MB, int S, int QT, int nlist, int FW,
                        int fetch, int packed, void* stream) {
  if (B % QT != 0 || FW < BLK || FW % BLK != 0 || fetch > FW)
    return (int)cudaErrorInvalidValue;
  const int T = B / QT;
  if (T == 0) return 0;
  const size_t smem = pq_scan_topk_smem_bytes(M, K, QT, FW);
  const int vec16 =
      (MB % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  const dim3 grid(T);
  const dim3 block(QT * FW <= 128 ? 128 : 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kern = packed ? pq_scan_topk<true> : pq_scan_topk<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, block, smem, st>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(block_ids),
      static_cast<const int32_t*>(block_other),
      static_cast<const int32_t*>(tile_idx),
      static_cast<const int32_t*>(rank_of),
      static_cast<const int32_t*>(slot_of),
      static_cast<const int32_t*>(rank_u), static_cast<const uint8_t*>(dead),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_pos),
      static_cast<int32_t*>(out_id), static_cast<int32_t*>(out_dco), M, K, BLK,
      MB, S, QT, nlist, FW, fetch, vec16);
  return (int)cudaGetLastError();
}

}  // extern "C"
