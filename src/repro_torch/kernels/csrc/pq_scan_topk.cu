// K3: fused PQ fast-scan -> keep mask -> per-query top-F, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/pq_scan.py::pq_scan_topk_kernel (defined at
// pq_scan.py:251, pallas_call at :311, body _make_topk_kernel) together
// with its in-kernel selection network K4 (src/repro/kernels/topk.py:
// bitonic_sort, bitonic_merge, merge_topf).
//
// What bounds it on this card.  The bytes it must move are few: the code
// rows of kept items, the ids and co-lists of planned blocks, the plan
// sidecars, and (B, F) triples out (chip_smoke.py's k3_bound).  What
// costs time is
//   * the table lookups: M shared-memory reads and f32 adds for each kept
//     item and query (chip_smoke.py counts 0.80 G in the main path's paged
//     batch of 1024 queries: about 0.1 ms at one 4-byte lookup per lane
//     per clock on 132 SMs at 1980 MHz);
//   * the selection: compare-exchange stages in shared memory, each
//     waiting on the one before;
//   * parallelism: the TPU grid walks a query tile's scan positions in
//     order, and a batch has few tiles (8 in grouped mode at B = 64).
// tools/k3_phases.py times the phases of a CTA on the card: the scoring
// rounds and the flushes take most of it.
//
// The design:
//   * Split.  The grid is (T, splits): CTA (tile, split) scans positions
//     [split * s_per, (split + 1) * s_per) of its tile, with splits taken
//     from the shape alone (kernels/pq_scan.py::k3_wave_splits): as many
//     CTAs as the card holds at once (pq_scan_topk_ctas_per_sm), one full
//     wave, or two where that cuts a tile 8 ways or more (a partial wave
//     costs a whole CTA's time; see k3_wave_splits).  Each CTA writes its
//     sorted top-F of every query to a (B, splits, F) scratch and adds its
//     DCO counts into a zeroed (B,) int32 (integer atomics: exact in any
//     order).  topk_merge,
//     one CTA per query, merges the splits' lists by counting (no queue,
//     no network; see its comment); with splits == 1 the scan writes the
//     output and no merge runs.  Exact: a member of the global top-F is in
//     the top-F of its own split.
//   * Plan first.  A round stages slot_of of its positions for the tile's
//     QT queries, and tile_idx of the positions, in shared memory.  A lane
//     whose position no query of the tile plans reads nothing else
//     (block_ids, codes): with BLK >= 32 a warp is one position, so the
//     skip is warp-uniform.  A planned item's id, co-list and code row are
//     requested together, so scoring waits on two loads in a row (those
//     and rank_of), not four; rank_of is read only for valid items, and
//     the DCO is one ballot and one shared add per warp and query.  A
//     round has two barriers: after its staging, and at its end, whose OR
//     says whether a push filled a queue.  (Staging the next round during
//     this one, with cp.async into a second buffer, was tried: a little
//     faster with the tables in shared memory, about twice as slow with
//     global tables.)
//   * Filter, queue, merge (the thread-queue / block-select scheme of
//     Johnson, Douze and Jegou, "Billion-scale similarity search with
//     GPUs", 2017; its code in queue_select.cuh, which the stream's delta
//     scan, delta_scan_topk.cu, shares).  Each query keeps a sorted accumulator of FW triples
//     and a queue of FW candidates in shared memory.  A scored candidate
//     takes a queue slot (one atomic per warp) only if it beats the
//     accumulator's F-th key under (d, pos).  The key only improves, so a
//     candidate that loses to it, however stale, cannot reach the final
//     top-F.  When a queue fills, every non-empty queue is bitonic-sorted
//     (FW wide) and merged into its accumulator: one min against the
//     reversed queue, then log2(FW) half-cleaner stages.  A candidate that
//     found its queue full is rescored and tried again against the new
//     key.  A queue is sorted only as wide as its fill, and an accumulator
//     that holds only pads takes the sorted queue without a merge: where a
//     split keeps fewer than FW items of a query (the grouped batches, 66
//     splits), its last flush is one narrow sort a query.  A round is NT
//     items (NT / BLK positions), one per thread.
//     Network stages that pair elements less than 64 apart stay inside a
//     warp and end in __syncwarp, not a block barrier.
//   * Scoring as in K1.  score_row (adc.cuh), the ascending-m f32 sum; the
//     thread of an item scores its row for every query of the tile that
//     keeps it, so K3 agrees bitwise with K1 and with both plain versions.
//     Where one query's tables alone pass a CTA's shared memory and the
//     shape is not k256's (M not a multiple of 8 at K = 256, or K 16 /
//     packed with M in the thousands: no index of the repository), the
//     GT-ldg instantiation reads them from global memory through the
//     read-only cache (adc.cuh's LdgTable) and shared memory holds only
//     the selection state and plan slots; the shape alone picks it
//     (kernels/pq_scan.py::query_groups).
//   * Candidate rows (GS).  Where one query's selection arrays pass a
//     CTA's shared memory (4 * 6 * FW bytes: 393 KB at FW = 16384, fetch
//     above 8192), a filter, a queue and a network in device memory would
//     move tens of megabytes a query and a flush, and would filter nothing
//     where fetch is near the kept count (a paged query of the wide
//     two-tier case keeps ~12,200 of 17,792 planned items for fetch
//     16,000).  So that form selects nothing: it scores as above (the
//     staging, score_row and the DCO ballot are the same code) and appends
//     each kept triple (d, pos, id) to its query's candidate row, with one
//     warp-aggregated atomic per warp and query on the row's fill.  The
//     rows are (B, cap) tensors from PyTorch's caching allocator (graph
//     capture keeps working), cap = BLK times the query's plan width: pos
//     is unique among a query's kept items, so a row never overflows.  The
//     order inside a row is arbitrary, but (d, pos) is unique among its
//     entries, so the row select that follows (csrc/topk_select.cu, one
//     CTA per query) gives the stable top-fetch whatever the order.  This
//     layout ("append") writes only kept items and tells the select how
//     many there are, where a row dense by pos would need pads written
//     first and read back.  Splits append to the same rows, so the form
//     splits as the shared one does (topk_splits) and needs no merge.  The
//     shape alone picks it (kernels/pq_scan.py::query_groups).
//   * One query a CTA (k256).  Unpacked K = 256 codes (PQ64x8) would put
//     a tile's 512 KB of tables into three query groups; the k256 form
//     runs a CTA a query of a tile instead, in one launch, its table in
//     shared memory, the positions its query plans compacted first
//     (pq_scan_topk_k256, below).  The shape alone picks it
//     (kernels/pq_scan.py::k256_fits).
//   * Global tables (GT).  At K = 256 where one query's table passes a
//     CTA's shared memory (PQ256x8, gist: 256 KB), a CTA a query too, its
//     kept items listed first and scored a pass of 2,048 at a time against
//     the table staged through shared memory in ranges of 16
//     subquantizers (pq_scan_topk_gt, below; kernels/pq_scan.py::gt_fits).
//
// pos = slot * BLK + lane is unique among a query's kept candidates and
// every pad is (+inf, PAD_POS, -1), so the result is the stable selection
// of the plain version (kernels/ref.py), ties included.
#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"
#include "queue_select.cuh"

namespace {

constexpr int NT = 256;        // threads of a scan CTA (TOPK_THREADS)
constexpr int MERGE_NT = 256;  // threads of a merge CTA
constexpr int MAX_QT = 64;     // query bitmasks are one 64-bit word

template <bool PACKED, bool GT, bool GS>
__global__ void __launch_bounds__(NT) pq_scan_topk(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ block_ids,
    const int32_t* __restrict__ block_other,
    const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ rank_of,
    const int32_t* __restrict__ slot_of, const int32_t* __restrict__ rank_u,
    const uint8_t* __restrict__ dead, float* __restrict__ part_d,
    int32_t* __restrict__ part_pos, int32_t* __restrict__ part_id,
    int32_t* __restrict__ dco, int* __restrict__ row_n, int M, int K,
    int BLK, int MB, int S, int QT, int QS, int nlist, int FW, int fetch,
    int s_per, int vec16) {
  extern __shared__ int smem[];
  const int qi = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int s0 = split * s_per, s1 = min(S, s0 + s_per);
  const int P = max(1, NT / BLK);  // positions per round
  const int n_lut = GT ? 0 : QT * M * K;  // tables staged in shared memory
  float* slut = reinterpret_cast<float*>(smem);
  // GS: part_* are the (B, fetch) candidate rows, row_n their fills
  const size_t n_sel = GS ? 0 : sel_array_words(QT, FW);
  int* cnt = smem + n_lut + n_sel;  // sel_count_words(QT) (not GS)
  Sel sel;
  if (!GS) carve(sel, smem + n_lut, cnt, QT, FW, fetch);
  int* sslot = cnt + (GS ? 0 : sel_count_words(QT));  // QT * P
  int* stile = sslot + QT * P;                          // P
  int* sdco = stile + P;                                // QT

  const float* glut = lut + (size_t)qi * QS * M * K;
  for (int j = tid; j < n_lut; j += NT) slut[j] = glut[j];
  const auto tabs = tables<GT>(glut, slut);
  if (!GS) {
    for (int j = tid; j < QT * FW; j += NT) {
      sel.ad[j] = inf();
      sel.ap[j] = PAD_POS;
      sel.ai[j] = -1;
    }
    for (int j = tid; j < (int)sel_count_words(QT); j += NT) sel.cnt[j] = 0;
  }
  for (int q = tid; q < QT; q += NT) sdco[q] = 0;

  const int f_end = s1 * BLK;
  for (int f0 = s0 * BLK; f0 < f_end; f0 += NT) {
    const int sr = f0 / BLK;  // first position of the round
    // the round's plan: slot_of of the tile's queries and tile_idx at its
    // P positions (-1 / 0 past the split)
    for (int j = tid; j < QT * P + P; j += NT) {
      const int q = j / P, s = sr + j % P;
      if (q < QT)
        sslot[j] = s < s1 ? slot_of[(size_t)(qi * QS + q) * S + s] : -1;
      else
        stile[j % P] = s < s1 ? tile_idx[(size_t)qi * S + s] : 0;
    }
    __syncthreads();
    const int f = f0 + tid;
    const int p = f / BLK - sr, s = sr + p, ln = f % BLK;
    uint64_t plan = 0;  // queries of the tile that plan this position
    if (f < f_end)
      for (int q = 0; q < QT; ++q)
        if (sslot[q * P + p] >= 0) plan |= 1ull << q;
    int iid = -1, oth = -1;
    bool is_dead = false;
    const uint8_t* row = nullptr;
    if (plan) {
      // the item's id, co-list, tombstone and code row are requested at
      // once (the row into L1): only rank_of waits on another load.  With
      // global tables the row is left to score_row: their reads want L1
      const int blk = stile[p];
      const size_t item = (size_t)blk * BLK + ln;
      row = codes + item * MB;
      if (!GT) asm volatile("prefetch.global.L1 [%0];" ::"l"(row));
      iid = block_ids[item];
      oth = block_other[item];
      is_dead = dead != nullptr && dead[item] != 0;
    }
    if (iid < 0) plan = 0;  // item_ok needs a valid item
    uint64_t pend = 0;      // queries whose queue was full for this item
    bool full = false;      // a push of this thread's filled a queue
    if (__any_sync(FULL, plan != 0)) {
      for (int q = 0; q < QT; ++q) {
        const bool ok = (plan >> q) & 1ull;
        const unsigned m = __ballot_sync(FULL, ok);
        if (m == 0) continue;
        if (lane == __ffs(m) - 1) atomicAdd(&sdco[q], __popc(m));
        const int b = qi * QS + q;
        bool keep = ok && !is_dead;
        if (keep && oth >= 0)
          keep = rank_of[(size_t)b * nlist + oth] >= rank_u[(size_t)b * S + s];
        float d = 0.f;
        int pos = 0;
        bool want = false;
        if (keep) {
          d = score_row<PACKED>(row, tabs + (size_t)q * M * K, K, MB,
                                vec16 != 0);
          pos = sslot[q * P + p] * BLK + ln;
          want = GS || sel.beats(q, d, pos);
        }
        if (GS)
          append_warp(part_d, part_pos, part_id, row_n, b, fetch, want, d,
                      pos, iid);
        else if (!push_warp(sel, q, want, d, pos, iid, full))
          pend |= 1ull << q;
      }
    }
    // the round's last barrier: its plan may be overwritten, and every
    // thread learns whether a queue is full
    bool again = __syncthreads_or(full);
    while (!GS && again) {
      flush(sel);
      full = false;
      for (uint64_t r = pend; r; r &= r - 1) {
        const int q = __ffsll((long long)r) - 1;
        const float d = score_row<PACKED>(row, tabs + (size_t)q * M * K, K,
                                          MB, vec16 != 0);
        const int pos = sslot[q * P + p] * BLK + ln;
        if (!sel.beats(q, d, pos) || push_one(sel, q, d, pos, iid, full))
          pend &= ~(1ull << q);
      }
      again = __syncthreads_or(full);
    }
  }
  __syncthreads();
  if (!GS && sel.any_queued()) flush(sel);

  for (int j = tid; !GS && j < QT * fetch; j += NT) {
    const int q = j / fetch, c = j % fetch;
    const size_t o = ((size_t)(qi * QS + q) * splits + split) * fetch + c;
    const int a = q * FW + c;
    part_d[o] = sel.ad[a];
    part_pos[o] = sel.ap[a];
    part_id[o] = sel.ai[a];
  }
  for (int q = tid; q < QT; q += NT)
    if (sdco[q]) atomicAdd(&dco[qi * QS + q], sdco[q]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// The K = 256 form (k256): unpacked K = 256 codes, MB = M, whose one
// query's table and selection state fit in shared memory (PQ64x8: 64 KB
// and 3 KB at fetch 100), any QT, one launch.  The shared form would cut
// such a tile into query groups (a tile of 8 queries holds 512 KB of
// tables: three launches, each staging the tile's plan and reading its ids,
// co-lists and codes again) at one CTA an SM, and walk every position of
// the tile's union, most of which a query does not plan in clustered and
// grouped mode.  Here a CTA is one query of one tile and one split:
//   * its table comes into shared memory by cp.async (three CTAs an SM at
//     M 64, fetch 100);
//   * it compacts the positions of its split that its query plans, KWIN at
//     a time (slot_of, tile_idx and rank_u read once; a ballot a warp and
//     a prefix sum of the warps' counts keep them in ascending order, the
//     shared form's order, in which the nearest lists come first and the
//     filter's key tightens soonest), so no round is spent on positions
//     it skips;
//   * it scores KIPT items a thread at once: their ids, co-lists,
//     tombstones and first row pieces are requested together, then rank_of
//     (keep), then each kept row in 16- or 8-byte pieces, the next piece
//     loaded while this one is scored (adc.cuh's score_k256_piece: each
//     byte extracted once, the sum ascending m);
//   * the filter, queue and flush are the shared form's (Sel, push_warp,
//     flush), the scores held in registers across a flush (no rescoring).
// (d, pos) is unique among a query's kept items, so the result is the
// stable top-F whatever the order; the order sets only how often the
// queue fills.
constexpr int KWIN = 512;  // positions a k256 CTA compacts at a time
constexpr int KIPT = 4;    // items a k256 thread scores at once
constexpr int K256 = 256;

template <int CH>
__global__ void __launch_bounds__(NT, 3) pq_scan_topk_k256(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ block_ids,
    const int32_t* __restrict__ block_other,
    const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ rank_of,
    const int32_t* __restrict__ slot_of, const int32_t* __restrict__ rank_u,
    const uint8_t* __restrict__ dead, float* __restrict__ part_d,
    int32_t* __restrict__ part_pos, int32_t* __restrict__ part_id,
    int32_t* __restrict__ dco, int M, int lb, int S, int QT, int QS,
    int nlist, int FW, int fetch, int s_per) {
  using Piece = typename K256Piece<CH>::type;
  extern __shared__ __align__(16) int ksmem[];
  float* tab = reinterpret_cast<float*>(ksmem);  // M * 256
  int* sel_at = ksmem + M * K256;
  Sel sel;
  carve(sel, sel_at, sel_at + sel_array_words(1, FW), 1, FW, fetch);
  int* wblk = sel_at + sel_array_words(1, FW) + sel_count_words(1);  // KWIN
  int* wslot = wblk + KWIN;                                          // KWIN
  int* wru = wslot + KWIN;                                           // KWIN
  int* wcnt = wru + KWIN;  // KWIN / 32: planned positions a warp's 32
  const int qi = blockIdx.x / QT, b = qi * QS + blockIdx.x % QT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int BLK = 1 << lb;
  const int s0 = split * s_per, s1 = min(S, s0 + s_per);
  const int P = M / CH;  // pieces a row
  const float* glut = lut + (size_t)b * M * K256;
  for (int c = 4 * tid; c < M * K256; c += 4 * NT) cp_async16(tab + c, glut + c);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int j = tid; j < FW; j += NT) {
    sel.ad[j] = inf();
    sel.ap[j] = PAD_POS;
    sel.ai[j] = -1;
  }
  for (int j = tid; j < (int)sel_count_words(1); j += NT) sel.cnt[j] = 0;
  int ndco = 0;  // this thread's valid items of planned positions
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  constexpr int SUB = KWIN / NT, WARPS = NT / 32;
  for (int w0 = s0; w0 < s1; w0 += KWIN) {
    // the window's positions this query plans, in ascending order: thread
    // tid of sub-window k holds position w0 + k * NT + tid; each warp
    // counts its planned ones, and a position's entry is the count of
    // those before it
    int sl[SUB], bk[SUB], ru[SUB];
    unsigned pm[SUB];
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      const int s = w0 + k * NT + tid;
      const bool in = s < s1;
      sl[k] = in ? slot_of[(size_t)b * S + s] : -1;
      bk[k] = in ? tile_idx[(size_t)qi * S + s] : 0;
      ru[k] = in ? rank_u[(size_t)b * S + s] : 0;
    }
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      pm[k] = __ballot_sync(FULL, sl[k] >= 0);
      if (lane == 0) wcnt[k * WARPS + warp] = __popc(pm[k]);
    }
    __syncthreads();
    int planned = 0, off[SUB];
#pragma unroll
    for (int c = 0; c < SUB * WARPS; ++c) {
      if (c % WARPS == warp) off[c / WARPS] = planned;
      planned += wcnt[c];
    }
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      if (sl[k] < 0) continue;
      const int e = off[k] + __popc(pm[k] & ((1u << lane) - 1u));
      wblk[e] = bk[k];
      wslot[e] = sl[k];
      wru[e] = ru[k];
    }
    // the entries are written, and every thread has read the counts
    __syncthreads();
    const int n = planned << lb;  // items of the planned positions
    for (int p0 = 0; p0 < n; p0 += KIPT * NT) {
      const int first = p0 + tid;
      int iid[KIPT], pos[KIPT], oth[KIPT], rk[KIPT];
      bool keep[KIPT];
      const Piece* row[KIPT];
      Piece cur[KIPT];
#pragma unroll
      for (int i = 0; i < KIPT; ++i) {
        const int f = first + i * NT;
        iid[i] = -1, oth[i] = -1, pos[i] = 0, rk[i] = 0, keep[i] = false;
        row[i] = nullptr;
        cur[i] = Piece{};
        if (f < n) {
          const int e = f >> lb, ln = f & (BLK - 1);
          const size_t item = ((size_t)wblk[e] << lb) + ln;
          iid[i] = block_ids[item];
          oth[i] = block_other[item];
          keep[i] = dead == nullptr || dead[item] == 0;
          row[i] = reinterpret_cast<const Piece*>(codes + item * M);
          cur[i] = __ldg(row[i]);
          pos[i] = wslot[e] * BLK + ln;
          rk[i] = wru[e];
        }
      }
      float acc[KIPT];
#pragma unroll
      for (int i = 0; i < KIPT; ++i) {
        ndco += iid[i] >= 0;
        keep[i] = keep[i] && iid[i] >= 0;
        if (keep[i] && oth[i] >= 0)
          keep[i] = rank_of[(size_t)b * nlist + oth[i]] >= rk[i];
        acc[i] = 0.f;
      }
      for (int v = 0; v < P; ++v) {
        Piece nxt[KIPT];
#pragma unroll
        for (int i = 0; i < KIPT; ++i) {
          nxt[i] = Piece{};
          if (keep[i] && v + 1 < P) nxt[i] = __ldg(row[i] + v + 1);
        }
        const float* t = tab + v * CH * K256;
#pragma unroll
        for (int i = 0; i < KIPT; ++i)
          if (keep[i]) acc[i] = score_k256_piece<CH>(acc[i], cur[i], t);
#pragma unroll
        for (int i = 0; i < KIPT; ++i) cur[i] = nxt[i];
      }
      // the filter: a kept item whose push found the queue full waits for
      // the flush and is tried again against the new key
      unsigned pend = 0;
      bool full = false;
#pragma unroll
      for (int i = 0; i < KIPT; ++i) {
        const bool want = keep[i] && sel.beats(0, acc[i], pos[i]);
        if (!push_warp(sel, 0, want, acc[i], pos[i], iid[i], full))
          pend |= 1u << i;
      }
      bool again = __syncthreads_or(full);
      while (again) {
        flush(sel);
        full = false;
#pragma unroll
        for (int i = 0; i < KIPT; ++i)
          if (((pend >> i) & 1u) &&
              (!sel.beats(0, acc[i], pos[i]) ||
               push_one(sel, 0, acc[i], pos[i], iid[i], full)))
            pend &= ~(1u << i);
        again = __syncthreads_or(full);
      }
    }
  }
  __syncthreads();
  if (sel.any_queued()) flush(sel);
  for (int c = tid; c < fetch; c += NT) {
    const size_t o = ((size_t)b * splits + split) * fetch + c;
    part_d[o] = sel.ad[c];
    part_pos[o] = sel.ap[c];
    part_id[o] = sel.ai[c];
  }
  for (int o = 16; o > 0; o >>= 1) ndco += __shfl_xor_sync(FULL, ndco, o);
  if (lane == 0 && ndco) atomicAdd(&dco[b], ndco);
}

// The global-table form (GT): unpacked K = 256 codes as in k256, but one
// query's table does not fit in shared memory (PQ256x8: 256 KB).  The PR 14
// form (pq_scan_topk<.., GT = true, ..>, now "GT-ldg") walked a tile's
// whole union for all its queries and read every lookup through the L2
// (LdgTable).  Here a CTA is one query of one tile and one split, as in
// k256:
//   * it compacts the positions its query plans, KWIN at a time, in
//     ascending order (k256's windows);
//   * it tests their items GCK a thread at once (id, co-list, tombstone,
//     then rank_of), counts the DCO, and appends the kept ones (item, pos,
//     id) to a list in shared memory, in ascending order (a ballot a warp
//     and a prefix sum of the warps' counts): SEIL's skipped duplicates,
//     tombstones and empty lanes take no slot in a pass;
//   * once the list holds a pass of GPASS = GIPT * NT items (or at the
//     end), the CTA scores them: the query's table comes through shared
//     memory in ranges of GR subquantizers (16 KB), cp.async filling one
//     of two buffers while the other is scored (one barrier a range), each
//     thread's GIPT sums carried in registers from range to range, each
//     item's code piece of the next range loaded while this one is scored
//     (adc.cuh's score_k256_piece); the items past the pass move to the
//     front of the list;
//   * the filter, queue and flush are k256's (scores held in registers
//     across a flush), with the retries after a flush warp-aggregated
//     (push_warp, not one atomic an item: 1% faster, tools/k3_phases.py
//     --gist).
// A query's table is read once a pass: once for up to 2,048 kept items.
// Each sum is one f32 accumulator over ascending m (ranges, pieces and
// bytes in order), so the result is bitwise k256's, the shared form's and
// the plain version's.
constexpr int GR = 16;    // subquantizers in a range of a GT table (16 KB)
constexpr int GIPT = 8;   // kept items a GT thread scores in a pass
constexpr int GCK = 4;    // items a GT thread tests for keep at a time
constexpr int GPASS = GIPT * NT;         // items of a full pass
constexpr int GLIST = GPASS + GCK * NT;  // list entries: a pass and a step

// Words of a GT CTA's shared memory: two range buffers, one query's
// selection state, a window of compacted positions and its warp counts,
// the kept list (item, pos, id) and two sets of a step's warp counts.
__host__ __device__ __forceinline__ size_t gt_smem_words(int FW) {
  return 2 * (size_t)GR * K256 + sel_array_words(1, FW) + sel_count_words(1) +
         3 * KWIN + KWIN / 32 + 3 * (size_t)GLIST + 2 * GCK * (NT / 32);
}

template <int CH>
__global__ void __launch_bounds__(NT, 2) pq_scan_topk_gt(
    const float* __restrict__ lut, const uint8_t* __restrict__ codes,
    const int32_t* __restrict__ block_ids,
    const int32_t* __restrict__ block_other,
    const int32_t* __restrict__ tile_idx, const int32_t* __restrict__ rank_of,
    const int32_t* __restrict__ slot_of, const int32_t* __restrict__ rank_u,
    const uint8_t* __restrict__ dead, float* __restrict__ part_d,
    int32_t* __restrict__ part_pos, int32_t* __restrict__ part_id,
    int32_t* __restrict__ dco, int M, int lb, int S, int QT, int QS,
    int nlist, int FW, int fetch, int s_per) {
  using Piece = typename K256Piece<CH>::type;
  constexpr int PR = GR / CH;  // pieces of a full range
  constexpr int SUB = KWIN / NT, WARPS = NT / 32;
  extern __shared__ __align__(16) int gsmem[];
  float* tabs = reinterpret_cast<float*>(gsmem);  // 2 x GR * 256
  int* sel_at = gsmem + 2 * GR * K256;
  Sel sel;
  carve(sel, sel_at, sel_at + sel_array_words(1, FW), 1, FW, fetch);
  int* wblk = sel_at + sel_array_words(1, FW) + sel_count_words(1);  // KWIN
  int* wslot = wblk + KWIN;                                          // KWIN
  int* wru = wslot + KWIN;                                           // KWIN
  int* wcnt = wru + KWIN;        // KWIN / 32
  int* litem = wcnt + KWIN / 32;  // GLIST: the kept list
  int* lpos = litem + GLIST;
  int* lid = lpos + GLIST;
  int* kcnt = lid + GLIST;  // 2 x GCK * WARPS: a step's warp counts
  const int qi = blockIdx.x / QT, b = qi * QS + blockIdx.x % QT;
  const int split = blockIdx.y, splits = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int BLK = 1 << lb;
  const int s0 = split * s_per, s1 = min(S, s0 + s_per);
  const int ranges = (M + GR - 1) / GR;
  const float* glut = lut + (size_t)b * M * K256;
  for (int j = tid; j < FW; j += NT) {
    sel.ad[j] = inf();
    sel.ap[j] = PAD_POS;
    sel.ai[j] = -1;
  }
  for (int j = tid; j < (int)sel_count_words(1); j += NT) sel.cnt[j] = 0;
  int ndco = 0;  // this thread's valid items of planned positions

  // range r's tables into buffer r & 1
  auto stage = [&](int r) {
    const int m0 = r * GR, n4 = min(GR, M - m0) * (K256 / 4);
    float* d = tabs + (r & 1) * GR * K256;
    const float* s = glut + (size_t)m0 * K256;
    for (int c = tid; c < n4; c += NT) cp_async16(d + 4 * c, s + 4 * c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the code pieces of range r of this thread's items (none past `has`)
  auto load_pieces = [&](Piece(&p)[GIPT][PR], const uint32_t(&item)[GIPT],
                         unsigned has, int r) {
    const int m0 = r * GR, np = min(GR, M - m0) / CH;
#pragma unroll
    for (int i = 0; i < GIPT; ++i)
#pragma unroll
      for (int v = 0; v < PR; ++v) {
        p[i][v] = Piece{};
        if (((has >> i) & 1u) && v < np)
          p[i][v] = __ldg(reinterpret_cast<const Piece*>(
                              codes + (size_t)item[i] * M + m0) +
                          v);
      }
  };
  // Score the list's first n entries against every range of the table and
  // offer them to the filter.  All threads call it; it starts with a
  // barrier (the list is written) and ends with one.
  auto score_pass = [&](int n) {
    stage(0);
    __syncthreads();
    uint32_t item[GIPT];
    unsigned has = 0;
    float acc[GIPT];
#pragma unroll
    for (int i = 0; i < GIPT; ++i) {
      const int e = i * NT + tid;
      item[i] = 0u;
      if (e < n) {
        item[i] = (uint32_t)litem[e];
        has |= 1u << i;
      }
      acc[i] = 0.f;
    }
    Piece cur[GIPT][PR], nxt[GIPT][PR];
    load_pieces(cur, item, has, 0);
    for (int r = 0; r < ranges; ++r) {
      const int np = min(GR, M - r * GR) / CH;
      // range r's tables have landed, and every thread is done with range
      // r - 1, whose buffer range r + 1 takes
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();
      if (r + 1 < ranges) {
        stage(r + 1);
        load_pieces(nxt, item, has, r + 1);
      }
      const float* t = tabs + (r & 1) * GR * K256;
#pragma unroll
      for (int i = 0; i < GIPT; ++i)
#pragma unroll
        for (int v = 0; v < PR; ++v)
          if (((has >> i) & 1u) && v < np)
            acc[i] = score_k256_piece<CH>(acc[i], cur[i][v], t + v * CH * K256);
#pragma unroll
      for (int i = 0; i < GIPT; ++i)
#pragma unroll
        for (int v = 0; v < PR; ++v) cur[i][v] = nxt[i][v];
    }
    // the filter: a kept item whose push found the queue full waits for
    // the flush and is tried again against the new key
    unsigned pend = 0;
    bool full = false;
#pragma unroll
    for (int i = 0; i < GIPT; ++i) {
      const int e = i * NT + tid;
      const int pos = (has >> i) & 1u ? lpos[e] : 0;
      const bool want = ((has >> i) & 1u) && sel.beats(0, acc[i], pos);
      if (!push_warp(sel, 0, want, acc[i], pos, want ? lid[e] : -1, full))
        pend |= 1u << i;
    }
    bool again = __syncthreads_or(full);
    while (again) {
      flush(sel);
      full = false;
#pragma unroll
      for (int i = 0; i < GIPT; ++i) {  // warp-aggregated retries
        const int e = i * NT + tid;
        const bool retry = (pend >> i) & 1u;
        const int pos = retry ? lpos[e] : 0;
        const bool want = retry && sel.beats(0, acc[i], pos);
        if (push_warp(sel, 0, want, acc[i], pos, want ? lid[e] : -1, full))
          pend &= ~(1u << i);
      }
      again = __syncthreads_or(full);
    }
  };

  __syncthreads();
  int fill = 0, par = 0;  // entries in the kept list; kcnt's set
  for (int w0 = s0; w0 < s1; w0 += KWIN) {
    // the window's positions this query plans, in ascending order (k256's
    // compaction)
    int sl[SUB], bk[SUB], ru[SUB];
    unsigned pm[SUB];
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      const int s = w0 + k * NT + tid;
      const bool in = s < s1;
      sl[k] = in ? slot_of[(size_t)b * S + s] : -1;
      bk[k] = in ? tile_idx[(size_t)qi * S + s] : 0;
      ru[k] = in ? rank_u[(size_t)b * S + s] : 0;
    }
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      pm[k] = __ballot_sync(FULL, sl[k] >= 0);
      if (lane == 0) wcnt[k * WARPS + warp] = __popc(pm[k]);
    }
    __syncthreads();
    int planned = 0, off[SUB];
#pragma unroll
    for (int c = 0; c < SUB * WARPS; ++c) {
      if (c % WARPS == warp) off[c / WARPS] = planned;
      planned += wcnt[c];
    }
#pragma unroll
    for (int k = 0; k < SUB; ++k) {
      if (sl[k] < 0) continue;
      const int e = off[k] + __popc(pm[k] & ((1u << lane) - 1u));
      wblk[e] = bk[k];
      wslot[e] = sl[k];
      wru[e] = ru[k];
    }
    // the entries are written, and every thread has read the counts
    __syncthreads();
    const int n = planned << lb;  // items of the planned positions
    for (int f0 = 0; f0 < n; f0 += GCK * NT) {
      // GCK items a thread: id, co-list and tombstone requested together,
      // then rank_of for the co-assigned ones
      int iid[GCK], oth[GCK], ps[GCK], rk[GCK];
      uint32_t it[GCK];
      bool keep[GCK];
#pragma unroll
      for (int k = 0; k < GCK; ++k) {
        const int f = f0 + k * NT + tid;
        iid[k] = -1, oth[k] = -1, ps[k] = 0, rk[k] = 0, it[k] = 0u;
        keep[k] = false;
        if (f < n) {
          const int e = f >> lb, ln = f & (BLK - 1);
          const size_t item = ((size_t)wblk[e] << lb) + ln;
          iid[k] = block_ids[item];
          oth[k] = block_other[item];
          keep[k] = dead == nullptr || dead[item] == 0;
          it[k] = (uint32_t)item;
          ps[k] = wslot[e] * BLK + ln;
          rk[k] = wru[e];
        }
      }
      int* kc = kcnt + par * GCK * WARPS;
      unsigned km[GCK];
#pragma unroll
      for (int k = 0; k < GCK; ++k) {
        ndco += iid[k] >= 0;
        keep[k] = keep[k] && iid[k] >= 0;
        if (keep[k] && oth[k] >= 0)
          keep[k] = rank_of[(size_t)b * nlist + oth[k]] >= rk[k];
        km[k] = __ballot_sync(FULL, keep[k]);
        if (lane == 0) kc[k * WARPS + warp] = __popc(km[k]);
      }
      __syncthreads();
      int kept = 0, koff[GCK];
#pragma unroll
      for (int c = 0; c < GCK * WARPS; ++c) {
        if (c % WARPS == warp) koff[c / WARPS] = kept;
        kept += kc[c];
      }
#pragma unroll
      for (int k = 0; k < GCK; ++k) {
        if (!keep[k]) continue;
        const int e = fill + koff[k] + __popc(km[k] & ((1u << lane) - 1u));
        litem[e] = (int)it[k];
        lpos[e] = ps[k];
        lid[e] = iid[k];
      }
      fill += kept;
      par ^= 1;
      if (fill >= GPASS) {
        score_pass(GPASS);
        // the entries past the pass move to the front (fewer than a step:
        // no overlap); the next step's barrier publishes them
        fill -= GPASS;
        for (int j = tid; j < fill; j += NT) {
          litem[j] = litem[GPASS + j];
          lpos[j] = lpos[GPASS + j];
          lid[j] = lid[GPASS + j];
        }
      }
    }
  }
  if (fill > 0) score_pass(fill);
  __syncthreads();
  if (sel.any_queued()) flush(sel);
  for (int c = tid; c < fetch; c += NT) {
    const size_t o = ((size_t)b * splits + split) * fetch + c;
    part_d[o] = sel.ad[c];
    part_pos[o] = sel.ap[c];
    part_id[o] = sel.ai[c];
  }
  for (int o = 16; o > 0; o >>= 1) ndco += __shfl_xor_sync(FULL, ndco, o);
  if (lane == 0 && ndco) atomicAdd(&dco[b], ndco);
}

// (d, pos) as one 64-bit key that orders as lex_less does: the f32 bits
// made monotone (-0.0 taken as +0.0), then pos (>= 0) below them.
__device__ __forceinline__ uint64_t merge_key(float d, int pos) {
  uint32_t u = __float_as_uint(d);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (uint64_t)u << 32 | (uint32_t)pos;
}

// Entries of the ascending run keys[0, n) below x; top is the largest
// power of two <= n.  One shared-memory read a step, log2(n) + 1 steps.
__device__ __forceinline__ int count_below(const uint64_t* keys, int n,
                                           int top, uint64_t x) {
  int lo = 0;
  for (int step = top; step > 0; step >>= 1)
    if (lo + step <= n && keys[lo + step - 1] < x) lo += step;
  return lo;
}

// One CTA per query: the top-F under (d, pos) of `splits` ascending lists
// of F triples, (B, splits, F) -> (B, F).  No queue, no network: every
// list is sorted and every real key is unique (pos is unique among a
// query's real entries; all pads are (+inf, PAD_POS, -1), the largest
// key), so the F-th key T of the union is found by counting, and each
// entry up to it is placed by counting.
//   1. load: the lists' keys into shared memory (splits * F words of 64
//      bits; the wrapper takes the row select where they do not fit).
//   2. search: T is the largest v with fewer than F keys below it.  It is
//      fixed MERGE_BITS bits a round from the top: each round counts the
//      keys below 2^MERGE_BITS - 1 candidates for the next bits, one
//      binary search a (candidate, list) pair, MERGE_ILP in flight a
//      thread, summed in registers and then with one shared atomic a warp
//      and candidate into one of three buffers (one barrier a round).  A
//      round whose first rejected candidate has exactly F keys below it
//      ends the search: with distinct distances that comes after a few
//      rounds, not sixteen.
//   3. survivors: the keys below the end of the search (T, and T itself
//      unless it is the pad key) are the first c_l of each list l: at
//      most F, F when T is real.  They are gathered in list order.
//   4. rank and output: a survivor's place is the number of survivors
//      below it (their keys are unique); its triple is copied from the
//      input (d keeps its sign of zero), and the places past the last
//      survivor get pads.
// Where the lists' keys pass a CTA's shared memory the wrapper merges with
// the row select instead (csrc/topk_select.cu).
constexpr int MERGE_BITS = 4;
constexpr int MERGE_PIVOTS = (1 << MERGE_BITS) - 1;
constexpr int MERGE_ILP = 4;
// Lists placed directly, with no search: an entry costs a binary search in
// each other list, so the direct path grows with the lists and the search
// does not; up to 6 lists of 100 or 400 it is the faster of the two
// (tools/k3_phases.py --merge-paths).
constexpr int MERGE_DIRECT = 6;

__global__ void __launch_bounds__(MERGE_NT) topk_merge(
    const float* __restrict__ part_d, const int32_t* __restrict__ part_pos,
    const int32_t* __restrict__ part_id, float* __restrict__ out_d,
    int32_t* __restrict__ out_pos, int32_t* __restrict__ out_id, int splits,
    int fetch) {
  extern __shared__ int smem[];
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int n = splits * fetch, top = 1 << (31 - __clz(fetch));
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);  // splits * fetch
  uint64_t* skey = keys + n;                            // fetch survivors
  int* sidx = reinterpret_cast<int*>(skey + fetch);     // their entries
  int* cnt = sidx + fetch;                              // 3 * MERGE_PIVOTS
  int* run = cnt + 3 * MERGE_PIVOTS;                    // splits: c_l
  int* off = run + splits;                              // splits: offsets
  int* n_surv = off + splits;
  const size_t base = (size_t)b * n;
  const uint64_t pad = merge_key(inf(), PAD_POS);

  // 1. load
  if (n % 4 == 0 && (reinterpret_cast<uintptr_t>(part_d + base) |
                     reinterpret_cast<uintptr_t>(part_pos + base)) % 16 == 0) {
    const float4* d4 = reinterpret_cast<const float4*>(part_d + base);
    const int4* p4 = reinterpret_cast<const int4*>(part_pos + base);
#pragma unroll 2
    for (int e = tid; e < n / 4; e += MERGE_NT) {
      const float4 d = d4[e];
      const int4 q = p4[e];
      keys[4 * e] = merge_key(d.x, q.x);
      keys[4 * e + 1] = merge_key(d.y, q.y);
      keys[4 * e + 2] = merge_key(d.z, q.z);
      keys[4 * e + 3] = merge_key(d.w, q.w);
    }
  } else {
    for (int e = tid; e < n; e += MERGE_NT)
      keys[e] = merge_key(part_d[base + e], part_pos[base + e]);
  }
  for (int j = tid; j < 3 * MERGE_PIVOTS; j += MERGE_NT) cnt[j] = 0;
  if (tid == 0) *n_surv = 0;
  __syncthreads();

  int ns;  // real entries placed; the places from ns on get pads
  if (splits <= MERGE_DIRECT) {
    // Few lists (the clustered batches): no search.  A real entry's place
    // is its index plus the keys below it in the other lists (real keys
    // are unique); the pads are counted out, not placed.
    int reals = 0;
    for (int e = tid; e < n; e += MERGE_NT) {
      const uint64_t key = keys[e];
      if (key == pad) continue;
      ++reals;
      const int l = e / fetch;
      int r = e - l * fetch;
      for (int o = 0; o < splits && r < fetch; ++o)
        if (o != l)
          r += count_below(keys + (size_t)o * fetch, fetch, top, key);
      if (r < fetch) {
        const size_t at = (size_t)b * fetch + r;
        out_d[at] = part_d[base + e];
        out_pos[at] = part_pos[base + e];
        out_id[at] = part_id[base + e];
      }
    }
    for (int w = 16; w > 0; w >>= 1) reals += __shfl_xor_sync(FULL, reals, w);
    if (lane == 0 && reals) atomicAdd(n_surv, reals);
    __syncthreads();
    ns = min(*n_surv, fetch);
  } else {
    // 2. search.  Thread (slot, piv) counts, for candidate piv + 1, the keys
    // below it in lists slot, slot + MERGE_NT / 16, ...; a half-warp holds
    // one slot's 16 candidates (15 used), so a shuffle adds two slots and
    // each warp adds one count a candidate.  The round ends early when the
    // first candidate rejected has exactly fetch keys below it: they are
    // the survivors, whatever the bits below.
    const int piv = tid & 15, slot = tid >> 4;
    uint64_t v = 0, end = 0;
    for (int shift = 64 - MERGE_BITS, r = 0; shift >= 0;
         shift -= MERGE_BITS, ++r) {
      int* c = cnt + (r % 3) * MERGE_PIVOTS;
      const uint64_t x = v | (uint64_t)(piv + 1) << shift;
      int below = 0;
      for (int l0 = slot; l0 < splits; l0 += MERGE_ILP * (MERGE_NT / 16)) {
        const uint64_t* k[MERGE_ILP];
        int lo[MERGE_ILP];
  #pragma unroll
        for (int u = 0; u < MERGE_ILP; ++u) {
          const int l = min(l0 + u * (MERGE_NT / 16), splits - 1);
          k[u] = keys + (size_t)l * fetch;
          lo[u] = 0;
        }
        for (int step = top; step > 0; step >>= 1)
  #pragma unroll
          for (int u = 0; u < MERGE_ILP; ++u)
            if (lo[u] + step <= fetch && k[u][lo[u] + step - 1] < x)
              lo[u] += step;
  #pragma unroll
        for (int u = 0; u < MERGE_ILP; ++u)
          if (l0 + u * (MERGE_NT / 16) < splits) below += lo[u];
      }
      below += __shfl_xor_sync(FULL, below, 16);
      if (lane < MERGE_PIVOTS && below) atomicAdd(&c[piv], below);
      if (tid < MERGE_PIVOTS) cnt[((r + 1) % 3) * MERGE_PIVOTS + tid] = 0;
      __syncthreads();
      // the candidates with fewer than fetch keys below them are a prefix
      const int cl = lane < MERGE_PIVOTS ? c[lane] : 0;
      const int j = __popc(__ballot_sync(FULL, lane < MERGE_PIVOTS &&
                                                    cl < fetch));
      const int cj = __shfl_sync(FULL, cl, j & 31);
      if (j < MERGE_PIVOTS && cj == fetch) {
        end = v | (uint64_t)(j + 1) << shift;
        break;
      }
      v |= (uint64_t)j << shift;
    }

    // 3. survivors
    if (end == 0) end = v == pad ? pad : v + 1;
    for (int l = tid; l < splits; l += MERGE_NT)
      run[l] = count_below(keys + (size_t)l * fetch, fetch, top, end);
    __syncthreads();
    if (tid < 32) {  // exclusive prefix sum of run over the lists
      const int per = (splits + 31) / 32, l0 = min(splits, lane * per),
                l1 = min(splits, l0 + per);
      int s = 0;
      for (int l = l0; l < l1; ++l) s += run[l];
      int inc = s;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
      }
      for (int l = l0, at = inc - s; l < l1; ++l) {
        off[l] = at;
        at += run[l];
      }
      if (lane == 31) *n_surv = inc;
    }
    __syncthreads();
    for (int l = tid >> 5; l < splits; l += MERGE_NT / 32)
      for (int i = lane; i < run[l]; i += 32) {
        skey[off[l] + i] = keys[(size_t)l * fetch + i];
        sidx[off[l] + i] = l * fetch + i;
      }
    __syncthreads();

    // 4. rank and output
    ns = *n_surv;
    for (int j0 = tid; j0 < ns; j0 += 2 * MERGE_NT) {
      const int j1 = j0 + MERGE_NT;
      const uint64_t k0 = skey[j0], k1 = j1 < ns ? skey[j1] : 0;
      int r0 = 0, r1 = 0;
      for (int s = 0; s < ns; ++s) {
        const uint64_t ks = skey[s];
        r0 += ks < k0;
        r1 += ks < k1;
      }
      for (int h = 0; h < 2; ++h) {
        const int j = h ? j1 : j0;
        if (j >= ns) break;
        const size_t o = (size_t)b * fetch + (h ? r1 : r0);
        const size_t in = base + sidx[j];
        out_d[o] = part_d[in];
        out_pos[o] = part_pos[in];
        out_id[o] = part_id[in];
      }
    }
  }
  for (int c = ns + tid; c < fetch; c += MERGE_NT) {
    const size_t o = (size_t)b * fetch + c;
    out_d[o] = inf();
    out_pos[o] = PAD_POS;
    out_id[o] = -1;
  }
}

// Dynamic shared memory of one merge CTA (topk_merge's layout).
size_t merge_smem_bytes(int splits, int fetch) {
  return 8 * ((size_t)splits * fetch + fetch) +
         4 * ((size_t)fetch + 3 * MERGE_PIVOTS + 2 * (size_t)splits + 1);
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

using ScanKernel = decltype(&pq_scan_topk<false, false, false>);

template <bool GT, bool GS>
ScanKernel scan_kernel(bool packed) {
  return packed ? pq_scan_topk<true, GT, GS> : pq_scan_topk<false, GT, GS>;
}

// Where a scan CTA's tables are, as pq_scan_topk_launch's global_tables
// takes it: in shared memory, read from global memory through __ldg (the
// PR 14 form, "GT-ldg"), the k256 form's (one query's table in shared
// memory), or the GT form's (one query's table staged by range).
enum Tables { SHARED = 0, LDG = 1, K256_TABLE = 2, RANGES = 3 };

// Dynamic shared memory of one scan CTA (pq_scan_topk_smem_bytes), by
// where its tables are (`tables`; the k256 and GT forms' CTA holds one
// query whatever QT).
size_t scan_smem_bytes(int M, int K, int QT, int FW, int BLK, int tables,
                       bool gs) {
  if (tables == K256_TABLE)
    return sizeof(int) * ((size_t)M * K + sel_array_words(1, FW) +
                          sel_count_words(1) + 3 * KWIN + KWIN / 32);
  if (tables == RANGES) return sizeof(int) * gt_smem_words(FW);
  const int P = NT / BLK > 1 ? NT / BLK : 1;
  const size_t tab = tables ? 0 : (size_t)QT * M * K;
  const size_t arrays = gs ? 0 : sel_array_words(QT, FW) + sel_count_words(QT);
  return sizeof(int) * (tab + arrays + (size_t)QT * P + P + QT);
}

// A kernel of a form that runs a CTA a query (k256, GT).
using QueryKernel = decltype(&pq_scan_topk_k256<16>);

// The k256 or GT scan (`kern`, for rows of 16- or 8-byte pieces).
cudaError_t launch_query_ctas(QueryKernel kern, dim3 grid, size_t smem,
                              cudaStream_t st, const void* lut,
                              const void* codes, const void* block_ids,
                              const void* block_other, const void* tile_idx,
                              const void* rank_of, const void* slot_of,
                              const void* rank_u, const void* dead,
                              void* part_d, void* part_pos, void* part_id,
                              void* dco, int M, int BLK, int S, int QT,
                              int QS, int nlist, int FW, int fetch,
                              int s_per) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, dim3(NT), smem, st>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(block_ids),
      static_cast<const int32_t*>(block_other),
      static_cast<const int32_t*>(tile_idx),
      static_cast<const int32_t*>(rank_of),
      static_cast<const int32_t*>(slot_of),
      static_cast<const int32_t*>(rank_u), static_cast<const uint8_t*>(dead),
      static_cast<float*>(part_d), static_cast<int32_t*>(part_pos),
      static_cast<int32_t*>(part_id), static_cast<int32_t*>(dco), M,
      __builtin_ctz((unsigned)BLK), S, QT, QS, nlist, FW, fetch, s_per);
  return cudaGetLastError();
}

// Launch one scan of either form: GS when row_n is not NULL (then part_*
// are the candidate rows and `fetch` is their width).
int launch_scan(const void* lut, const void* codes, const void* block_ids,
                const void* block_other, const void* tile_idx,
                const void* rank_of, const void* slot_of, const void* rank_u,
                const void* dead, void* part_d, void* part_pos, void* part_id,
                void* dco, void* row_n, int B, int M, int K, int BLK, int MB,
                int S, int QT, int QS, int nlist, int FW, int fetch,
                int packed, int splits, int s_per, int global_tables,
                void* stream) {
  const bool per_query =
      global_tables == K256_TABLE || global_tables == RANGES;
  if (QT < 1 || (QT > MAX_QT && !per_query) || QT > QS || B % QS != 0 ||
      !pow2(BLK) || splits < 1 || s_per < 1 || splits > 65535 ||
      global_tables < SHARED || global_tables > RANGES)
    return (int)cudaErrorInvalidValue;
  const int T = B / QS;
  if (T == 0) return 0;
  const bool gs = row_n != nullptr;
  const size_t smem = scan_smem_bytes(M, K, QT, FW, BLK, global_tables, gs);
  if (per_query) {
    // unpacked K 256, rows in 8- or 16-byte pieces, the table 16-byte
    // aligned, and the CTA's state within a block's shared memory
    const uintptr_t at = reinterpret_cast<uintptr_t>(codes);
    if (gs || packed || K != K256 || MB != M || M % 8 != 0 || at % 8 != 0 ||
        reinterpret_cast<uintptr_t>(lut) % 16 != 0 || smem > 232448 ||
        (long long)T * QT > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    const bool p16 = M % 16 == 0 && at % 16 == 0;
    const QueryKernel kern =
        global_tables == RANGES
            ? (p16 ? pq_scan_topk_gt<16> : pq_scan_topk_gt<8>)
            : (p16 ? pq_scan_topk_k256<16> : pq_scan_topk_k256<8>);
    return (int)launch_query_ctas(
        kern, dim3(T * QT, splits), smem, static_cast<cudaStream_t>(stream),
        lut, codes, block_ids, block_other, tile_idx, rank_of, slot_of,
        rank_u, dead, part_d, part_pos, part_id, dco, M, BLK, S, QT, QS,
        nlist, FW, fetch, s_per);
  }
  const int vec16 =
      (MB % 16 == 0) && (reinterpret_cast<uintptr_t>(codes) % 16 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const ScanKernel kern =
      global_tables
          ? (gs ? scan_kernel<true, true>(packed)
                : scan_kernel<true, false>(packed))
          : (gs ? scan_kernel<false, true>(packed)
                : scan_kernel<false, false>(packed));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(T, splits), dim3(NT), smem, st>>>(
      static_cast<const float*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const int32_t*>(block_ids),
      static_cast<const int32_t*>(block_other),
      static_cast<const int32_t*>(tile_idx),
      static_cast<const int32_t*>(rank_of),
      static_cast<const int32_t*>(slot_of),
      static_cast<const int32_t*>(rank_u), static_cast<const uint8_t*>(dead),
      static_cast<float*>(part_d), static_cast<int32_t*>(part_pos),
      static_cast<int32_t*>(part_id), static_cast<int32_t*>(dco),
      static_cast<int*>(row_n), M, K, BLK, MB, S, QT, QS, nlist, FW, fetch,
      s_per, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one scan CTA: the tables (none when they are
// read from global memory, global_tables 1), the selection arrays and
// queue fills (none in the candidate-row form), and the round's staged
// plan slots and DCO counts (layout at the top of pq_scan_topk); with
// global_tables 2, of the k256 form's CTA (one query: its table, its
// selection state and a window of compacted positions, whatever QT); with
// 3, of the GT form's (gt_smem_words: two range buffers, one query's
// selection state, a window, the kept list).  The
// wrapper picks the form and cuts a tile into query groups by it
// (kernels/pq_scan.py::query_groups).
size_t pq_scan_topk_smem_bytes(int M, int K, int QT, int FW, int BLK,
                               int global_tables, int global_state) {
  return scan_smem_bytes(M, K, QT, FW, BLK, global_tables,
                         global_state != 0);
}

// Scan CTAs of the given form and dynamic shared memory that one SM holds
// at once (registers, threads and shared memory all counted), or a
// negative cudaError_t.  kernels/pq_scan.py::k3_wave_splits cuts a tile
// into as many splits as fill the card once at this occupancy.
int pq_scan_topk_ctas_per_sm(int packed, int global_tables, int global_state,
                             size_t smem) {
  int n = 0;
  if (global_tables == K256_TABLE || global_tables == RANGES) {
    // the k256 or GT form (its 16-byte instantiation)
    const QueryKernel kern = global_tables == RANGES ? pq_scan_topk_gt<16>
                                                     : pq_scan_topk_k256<16>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem);
    return err == cudaSuccess ? n : -(int)err;
  }
  const ScanKernel kern =
      global_tables
          ? (global_state ? scan_kernel<true, true>(packed != 0)
                          : scan_kernel<true, false>(packed != 0))
          : (global_state ? scan_kernel<false, true>(packed != 0)
                          : scan_kernel<false, false>(packed != 0));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// Dynamic shared memory of one merge CTA (one query) over `splits` lists
// of `fetch`.
size_t topk_merge_smem_bytes(int splits, int fetch) {
  return merge_smem_bytes(splits, fetch);
}

// lut (B, M, K) f32; codes (TB, BLK, MB) u8; block_ids / block_other
// (TB, BLK) i32; tile_idx (B / QS, S) i32; rank_of (B, nlist) i32;
// slot_of / rank_u (B, S) i32; dead (TB, BLK) u8 or NULL; part_d /
// part_pos / part_id (B, splits, fetch), the output itself when splits is
// 1; dco (B,) i32, zeroed.  A tile has QS query rows and this launch
// scores QT of them (a query group, kernels/pq_scan.py::query_groups):
// lut, rank_of, slot_of, rank_u, the part_* and dco point at the group's
// first row of tile 0, and CTA qi takes rows qi * QS + [0, QT).  Split y
// scans positions [y * s_per, min(S, (y + 1) * s_per)).  FW is a power of
// two >= max(fetch, 2); BLK is a power of two; 1 <= QT <= min(QS, 64).
// global_tables (enum Tables): 1, read the tables from global memory
// (GT-ldg); 2, the k256 form, 3 the GT form (a CTA a query of a tile: grid
// (T * QT, splits); any QT <= QS).
int pq_scan_topk_launch(const void* lut, const void* codes,
                        const void* block_ids, const void* block_other,
                        const void* tile_idx, const void* rank_of,
                        const void* slot_of, const void* rank_u,
                        const void* dead, void* part_d, void* part_pos,
                        void* part_id, void* dco, int B, int M, int K,
                        int BLK, int MB, int S, int QT, int QS, int nlist,
                        int FW, int fetch, int packed, int splits, int s_per,
                        int global_tables, void* stream) {
  if (!pow2(FW) || FW < 2 || fetch < 1 || fetch > FW)
    return (int)cudaErrorInvalidValue;
  return launch_scan(lut, codes, block_ids, block_other, tile_idx, rank_of,
                     slot_of, rank_u, dead, part_d, part_pos, part_id, dco,
                     nullptr, B, M, K, BLK, MB, S, QT, QS, nlist, FW, fetch,
                     packed, splits, s_per, global_tables, stream);
}

// The candidate-row form (GS): inputs, query groups and splits as
// pq_scan_topk_launch; row_d / row_pos / row_id (B, cap) and row_n (B,)
// i32, zeroed: each kept triple of query b is appended to row b, in no
// particular order, and row_n[b] counts them.  cap >= BLK times the
// number of plan slots of any query (slot_of < cap / BLK).
int pq_scan_rows_launch(const void* lut, const void* codes,
                        const void* block_ids, const void* block_other,
                        const void* tile_idx, const void* rank_of,
                        const void* slot_of, const void* rank_u,
                        const void* dead, void* row_d, void* row_pos,
                        void* row_id, void* row_n, void* dco, int B, int M,
                        int K, int BLK, int MB, int S, int QT, int QS,
                        int nlist, int cap, int packed, int splits, int s_per,
                        int global_tables, void* stream) {
  if (cap < 1 || row_n == nullptr) return (int)cudaErrorInvalidValue;
  return launch_scan(lut, codes, block_ids, block_other, tile_idx, rank_of,
                     slot_of, rank_u, dead, row_d, row_pos, row_id, dco,
                     row_n, B, M, K, BLK, MB, S, QT, QS, nlist, 0, cap,
                     packed, splits, s_per, global_tables, stream);
}

// part_d / part_pos / part_id (B, splits, fetch), each list ascending by
// (d, pos) with pads (+inf, PAD_POS, -1) last and pos unique among a
// query's other entries; out_d / out_pos / out_id (B, fetch), with
// topk_merge_smem_bytes(splits, fetch) within a CTA's shared memory.
int topk_merge_launch(const void* part_d, const void* part_pos,
                      const void* part_id, void* out_d, void* out_pos,
                      void* out_id, int B, int splits, int fetch,
                      void* stream) {
  if (fetch < 1 || splits < 1 || (size_t)splits * fetch > (1u << 30))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = merge_smem_bytes(splits, fetch);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<dim3(B), dim3(MERGE_NT), smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_d),
      static_cast<const int32_t*>(part_pos),
      static_cast<const int32_t*>(part_id), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_pos), static_cast<int32_t*>(out_id), splits,
      fetch);
  return (int)cudaGetLastError();
}

}  // extern "C"
