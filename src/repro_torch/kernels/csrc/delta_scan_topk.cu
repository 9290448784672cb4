// The routed delta scan of a streaming index, fused with each query's
// stable top-fetch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference's delta scan
// (src/repro/core/stream/search.py::routed_delta_candidates) is plain JAX.
// It takes the place of the port's plain routed scan with its top-fetch
// cut (core/stream/search.py::_routed_chunks), which gathers the code row
// of every padded posting position into (B, P * L, M) temporaries and
// scores them with one gather and one add per subquantizer.
//
// What it computes for query b (the plain version's contract).  The probed
// lists are sel[b, 0..P), in rank order.  Row delta_post[sel[b, p]] holds
// L slot ids: a prefix of slots, then -1 pads (DeltaSegment fills rows as
// prefixes and never prunes them).  Position p * L + l names slot
// s = delta_post[sel[b, p], l].  The slot is kept iff delta_ids[s] >= 0 and
// the smallest rank_of[b, a] over its assigned lists a = delta_assigns[s, :]
// is p: a slot posted under several probed lists is scored once, at the
// lowest-ranked.  A kept slot scores sum_m lut[b, m, codes[s, m]] over
// ascending m from 0 in f32 (adc.cuh: the rule of K1, K3 and _adc_rows).
// Out: the stable top-fetch of the kept (d, position) pairs, ascending,
// ties by position (-0.0 equal to +0.0, as float compares take it), with
// the slots' ids, unfilled places (+inf, -1); dco[b], the kept count; and
// walked[b], the posted slots read (each probed row's prefix).
//
// What bounds it on this card.  Few bytes: the delta's codes, ids,
// assignments and postings (about 24 MB at capacity 262,144) stay in the
// 50 MB L2, and each query reads its walked slots' ids and assignments and
// its kept slots' code rows.  The lookups: M shared-memory reads and f32
// adds per kept slot (1,024 queries x ~2,100 kept x 64: ~0.02 ms at 32 a
// clock on 132 SMs at 1980 MHz).  What costs time is latency: a slot's
// keep test waits on its posting, then on its id and assignments, and a
// kept slot's score on its code row.
//
// The design (K3's `shared` form without a block plan):
//   * Grid (B, splits): a CTA per query, or, at small batches, `splits`
//     CTAs per query, each taking an equal share of the query's walk (the
//     probed rows' prefixes end to end); splits come from B alone
//     (kernels/pq_scan.py::delta_splits) and K3's topk_merge merges their
//     sorted lists.
//   * Staging.  The query's table in shared memory, or read through __ldg
//     (adc.cuh's LdgTable, form GT) where it does not fit; its rank_of row
//     where that fits too; the probed lists.  A warp finds a row's first
//     pad with ballots over 32 probes a step (two steps up to L = 1024,
//     rows are prefixes), and a scan turns the lengths into offsets.
//   * Walk.  NT positions of the walk a round, one a thread: the thread
//     finds its list by binary search over the offsets, reads its slot,
//     then the slot's id and assignments, and scores the code row (16-byte
//     loads where M % 16 == 0) only if it keeps the slot.  No row is read
//     past its first pad, and nothing is written but the results.
//   * Selection: K3's filter / queue / merge (queue_select.cuh; Johnson,
//     Douze and Jegou, 2017) for one query.  An accumulator of FW (d, pos, id) triples,
//     ascending, and a queue of FW; a kept slot takes a queue place (one
//     atomic a warp) only if it beats the accumulator's fetch-th key, which
//     only improves.  A full queue is bitonic-sorted as wide as its fill and
//     merged into the accumulator (one min against the reversed queue, then
//     log2(FW) half-cleaners); a slot that found the queue full tries again
//     against the new key.  pos = p * L + l is unique among a query's kept
//     slots, so the result is the plain version's, ties included.
//   * Candidate rows (GS, as K3's).  Where the six FW-wide arrays do not
//     fit in shared memory (fetch above 8192), each kept triple is appended
//     to its query's row (B, P * L wide: never overflows), and the row
//     select (topk_select.cu) selects; splits append to the same rows.
// One launch a call (two with the merge or the row select); the wrapper
// allocates every output by shape alone, so CUDA graphs capture it.

#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"
#include "queue_select.cuh"

namespace {

constexpr int NT = 256;  // threads of a CTA

// Form bits (kernels/pq_scan.py::DELTA_GT / DELTA_RANK / DELTA_GS).
constexpr int F_GT = 1;    // the table read from global memory (__ldg)
constexpr int F_RANK = 2;  // the rank_of row staged in shared memory
constexpr int F_GS = 4;    // kept triples appended to rows, no selection

// Shared memory of one CTA, in 4-byte words: the table (not GT), the
// rank_of row (RANK), the probed lists and their offsets, one query's
// selection state (queue_select.cuh; not GS), the kept count.
__host__ __device__ __forceinline__ size_t smem_words(int M, int K, int nlist,
                                                      int P, int FW,
                                                      int form) {
  return ((form & F_GT) ? 0 : (size_t)M * K) +
         ((form & F_RANK) ? (size_t)nlist : 0) + 2 * (size_t)P + 1 +
         ((form & F_GS) ? 0 : sel_array_words(1, FW) + sel_count_words(1)) +
         1;
}

// The length of a row's prefix of slots (entries >= 0 before the first
// -1), found by one warp: each step probes 32 evenly spaced entries of the
// interval that holds the boundary and keeps the stretch between the last
// slot probed and the first pad.
__device__ __forceinline__ int prefix_length(const int32_t* __restrict__ row,
                                             int L, int lane) {
  int lo = 0, hi = L;  // the length lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int at = lo + lane * step;
    const int c = __popc(__ballot_sync(FULL, at < hi && row[at] >= 0));
    if (c == 0) break;
    const int top = min(lo + c * step, hi);
    lo += (c - 1) * step + 1;
    hi = top;
  }
  return lo;
}

template <bool GT, bool GS>
__global__ void __launch_bounds__(NT) delta_scan_topk(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ ids, const int32_t* __restrict__ post,
    const int32_t* __restrict__ assigns, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ rank_of, float* __restrict__ out_d,
    int32_t* __restrict__ out_pos, int32_t* __restrict__ out_id,
    int32_t* __restrict__ row_n, int32_t* __restrict__ dco,
    int32_t* __restrict__ walked, int M, int K, int L, int P, int nlist,
    int MA, int FW, int fetch, int width, int stage_rank, int vec16) {
  extern __shared__ int smem[];
  const int b = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_lut = GT ? 0 : M * K;
  float* slut = reinterpret_cast<float*>(smem);
  int* srank = smem + n_lut;
  int* slist = srank + (stage_rank ? nlist : 0);
  int* soff = slist + P;  // P + 1 offsets of the lists in the walk
  int* sarr = soff + P + 1;  // the selection state (not GS)
  const size_t n_arr = GS ? 0 : sel_array_words(1, FW);
  int* skept = sarr + (GS ? 0 : n_arr + sel_count_words(1));  // kept slots
  Sel s{};
  if constexpr (!GS) carve(s, sarr, sarr + n_arr, 1, FW, fetch);

  const float* glut = lut + (size_t)b * M * K;
  const int32_t* grank = rank_of + (size_t)b * nlist;
  for (int j = tid; j < n_lut; j += NT) slut[j] = glut[j];
  if (stage_rank)
    for (int j = tid; j < nlist; j += NT) srank[j] = grank[j];
  for (int p = tid; p < P; p += NT) slist[p] = sel[(size_t)b * P + p];
  if constexpr (!GS) {
    for (int j = tid; j < FW; j += NT) {
      s.ad[j] = inf();
      s.ap[j] = PAD_POS;
      s.ai[j] = -1;
    }
    for (int j = tid; j < (int)sel_count_words(1); j += NT) s.cnt[j] = 0;
  }
  if (tid == 0) *skept = 0;
  __syncthreads();
  for (int p = warp; p < P; p += NT / 32) {
    const int n = prefix_length(post + (size_t)slist[p] * L, L, lane);
    if (lane == 0) soff[p + 1] = n;
  }
  __syncthreads();
  if (warp == 0) {  // lengths to offsets: an inclusive scan, 32 at a time
    int carry = 0;
    for (int base = 0; base < P; base += 32) {
      const int i = base + lane;
      int v = i < P ? soff[i + 1] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
      }
      if (i < P) soff[i + 1] = carry + v;
      carry += __shfl_sync(FULL, v, 31);
    }
    if (lane == 0) soff[0] = 0;
  }
  __syncthreads();

  const int total = soff[P];
  if (split == 0 && tid == 0) walked[b] = total;
  const int w0 = (int)((long long)total * split / splits);
  const int w1 = (int)((long long)total * (split + 1) / splits);
  const int* rk = stage_rank ? srank : grank;
  const auto tab = tables<GT>(glut, slut);
  int kept = 0;
  for (int f0 = w0; f0 < w1; f0 += NT) {
    const int f = f0 + tid;
    bool keep = false;
    float d = 0.f;
    int pos = 0, id = -1;
    if (f < w1) {
      int p = 0, hi = P - 1;  // the last list whose offset is <= f
      while (p < hi) {
        const int mid = (p + hi + 1) >> 1;
        if (soff[mid] <= f)
          p = mid;
        else
          hi = mid - 1;
      }
      const int l = f - soff[p];
      const int slot = post[(size_t)slist[p] * L + l];
      id = ids[slot];
      if (id >= 0) {
        const int32_t* a = assigns + (size_t)slot * MA;
        int r = rk[a[0]];
        for (int j = 1; j < MA; ++j) r = min(r, rk[a[j]]);
        keep = r == p;
      }
      if (keep) {
        d = score_row<false>(codes + (size_t)slot * M, tab, K, M, vec16 != 0);
        pos = p * L + l;
        ++kept;
      }
    }
    if constexpr (GS) {
      append_warp(out_d, out_pos, out_id, row_n, b, width, keep, d, pos, id);
    } else {
      bool pend = keep;  // every lane takes part in each push
      for (;;) {
        bool full = false;
        const bool want = pend && s.beats(0, d, pos);
        const bool placed = push_warp(s, 0, want, d, pos, id, full);
        pend = want && !placed;
        if (!__syncthreads_or(full)) break;
        flush(s);
        if (!__syncthreads_or(pend)) break;
      }
    }
  }
  kept = __reduce_add_sync(FULL, kept);
  if (lane == 0 && kept) atomicAdd(skept, kept);
  __syncthreads();
  if (tid == 0 && *skept) atomicAdd(&dco[b], *skept);
  if constexpr (!GS) {
    if (s.any_queued()) flush(s);  // read after the barrier: alike in all
    const size_t o = ((size_t)b * splits + split) * fetch;
    for (int j = tid; j < fetch; j += NT) {
      out_d[o + j] = s.ad[j];
      if (out_pos) out_pos[o + j] = s.ap[j];
      out_id[o + j] = s.ai[j];
    }
  }
}

using DeltaKernel = void (*)(const float*, const uint8_t*, const int32_t*,
                             const int32_t*, const int32_t*, const int32_t*,
                             const int32_t*, float*, int32_t*, int32_t*,
                             int32_t*, int32_t*, int32_t*, int, int, int, int,
                             int, int, int, int, int, int, int);

DeltaKernel kernel_for(int form) {
  if (form & F_GT)
    return (form & F_GS) ? delta_scan_topk<true, true>
                         : delta_scan_topk<true, false>;
  return (form & F_GS) ? delta_scan_topk<false, true>
                       : delta_scan_topk<false, false>;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one CTA of `form` (bits F_GT | F_RANK | F_GS)
// for a query of P probed lists over nlist lists, tables (M, K), and an
// accumulator of FW triples; kernels/pq_scan.py::delta_form picks the
// first form that fits.
size_t delta_scan_topk_smem_bytes(int M, int K, int nlist, int P, int FW,
                                  int form) {
  return 4 * smem_words(M, K, nlist, P, FW, form);
}

// CTAs of `form` with `smem` bytes of shared memory that one SM holds at
// once (the current device); negative on a CUDA error.
int delta_scan_topk_ctas_per_sm(int form, size_t smem) {
  const DeltaKernel kern = kernel_for(form);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// lut (B, M, K) f32; codes (cap, M) u8; ids (cap,); post (nlist, L);
// assigns (cap, MA); sel (B, P); rank_of (B, nlist): all int32 but lut and
// codes.  Not GS: out_d / out_pos (or NULL) / out_id (B, splits, fetch),
// each split's list, ascending, pads (+inf, PAD_POS, -1) last.  GS: rows
// (B, width) with width >= P * L and their fills row_n (B,), zeroed.
// dco (B,) zeroed: kept slots; walked (B,): the walk's length.  fetch <=
// FW, FW a power of two >= 32 (not GS).
int delta_scan_topk_launch(const void* lut, const void* codes,
                           const void* ids, const void* post,
                           const void* assigns, const void* sel,
                           const void* rank_of, void* out_d, void* out_pos,
                           void* out_id, void* row_n, void* dco,
                           void* walked, int B, int M, int K, int L, int P,
                           int nlist, int MA, int FW, int fetch, int width,
                           int splits, int form, int vec16, void* stream) {
  const bool gs = form & F_GS;
  if (MA < 1 || P < 1 || L < 1 || splits < 1 ||
      (!gs && (fetch < 1 || fetch > FW || FW < 32 || (FW & (FW - 1)))) ||
      (gs && (size_t)width < (size_t)P * L))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = 4 * smem_words(M, K, nlist, P, FW, form);
  const DeltaKernel kern = kernel_for(form);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B, splits), dim3(NT), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(ids), static_cast<const int32_t*>(post),
      static_cast<const int32_t*>(assigns), static_cast<const int32_t*>(sel),
      static_cast<const int32_t*>(rank_of), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_pos), static_cast<int32_t*>(out_id),
      static_cast<int32_t*>(row_n), static_cast<int32_t*>(dco),
      static_cast<int32_t*>(walked), M, K, L, P, nlist, MA, FW, fetch, width,
      (form & F_RANK) ? 1 : 0, vec16);
  return (int)cudaGetLastError();
}

}  // extern "C"
