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
//     from the shape alone (kernels/pq_scan.py::topk_splits) for about
//     4 x 132 CTAs in flight.  Each CTA writes its sorted top-F of every
//     query to a (B, splits, F) scratch and adds its DCO counts into a
//     zeroed (B,) int32 (integer atomics: exact in any order).  topk_merge,
//     one CTA per query, merges the splits' lists; with splits == 1 the
//     scan writes the output and no merge runs.  Exact: a member of the
//     global top-F is in the top-F of its own split.
//   * Plan first.  A round stages slot_of of its positions for the tile's
//     QT queries in shared memory.  A lane whose position no query of the
//     tile plans reads nothing else (tile_idx, block_ids, codes): with
//     BLK >= 32 a warp is one position, so the skip is warp-uniform.
//     block_other and rank_of are read only for valid items, and the DCO
//     is one ballot and one shared add per warp and query.
//   * Filter, queue, merge (the thread-queue / block-select scheme of
//     Johnson, Douze and Jegou, "Billion-scale similarity search with
//     GPUs", 2017).  Each query keeps a sorted accumulator of FW triples
//     and a queue of FW candidates in shared memory.  A scored candidate
//     takes a queue slot (one atomic per warp) only if it beats the
//     accumulator's F-th key under (d, pos).  The key only improves, so a
//     candidate that loses to it, however stale, cannot reach the final
//     top-F.  When a queue fills, every non-empty queue is bitonic-sorted
//     (FW wide) and merged into its accumulator: one min against the
//     reversed queue, then log2(FW) half-cleaner stages.  A candidate that
//     found its queue full is rescored and tried again against the new
//     key.  A round is NT items (NT / BLK positions), one per thread.
//     Network stages that pair elements less than 64 apart stay inside a
//     warp and end in __syncwarp, not a block barrier.
//   * Scoring as in K1.  score_row (adc.cuh), the ascending-m f32 sum; the
//     thread of an item scores its row for every query of the tile that
//     keeps it, so K3 agrees bitwise with K1 and with both plain versions.
//     Where one query's tables alone pass a CTA's shared memory (M = 256
//     at K = 256: 256 KB), the GT instantiation reads them from global
//     memory through the read-only cache (adc.cuh's LdgTable) and shared
//     memory holds only the selection state and plan slots; the shape
//     alone picks it (kernels/pq_scan.py::query_groups).
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
//
// pos = slot * BLK + lane is unique among a query's kept candidates and
// every pad is (+inf, PAD_POS, -1), so the result is the stable selection
// of the plain version (kernels/ref.py), ties included.
#include <cstdint>
#include <cuda_runtime.h>

#include "adc.cuh"

namespace {

constexpr int PAD_POS = 1 << 30;
constexpr int NT = 256;        // threads of a scan CTA (TOPK_THREADS)
constexpr int MERGE_NT = 128;  // threads of a merge CTA
constexpr int MAX_QT = 64;     // query bitmasks are one 64-bit word
constexpr unsigned FULL = 0xffffffffu;
constexpr int ACROSS = 1 << 30;  // stage_sync: the next step crosses warps

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ bool lex_less(float ad, int ap, float bd, int bp) {
  return ad < bd || (ad == bd && ap < bp);
}

// Selection state of nq queries in shared memory.
struct Sel {
  float* ad;  // nq * FW accumulator, ascending by (d, pos)
  int* ap;
  int* ai;
  float* qd;  // nq * FW queue, unsorted
  int* qp;
  int* qi;
  int* cnt;   // nq queue fills; may pass FW when a push found it full
  int nq, fw, lw, fetch;  // lw = log2(fw)

  __device__ __forceinline__ bool beats(int q, float d, int p) const {
    const int t = (q << lw) + fetch - 1;
    return lex_less(d, p, ad[t], ap[t]);
  }
  __device__ __forceinline__ void put(int q, int off, float d, int p,
                                      int id) const {
    const int o = (q << lw) + off;
    qd[o] = d;
    qp[o] = p;
    qi[o] = id;
  }
  // Read between barriers: cnt changes only outside them.
  __device__ __forceinline__ bool any_full() const {
    for (int q = 0; q < nq; ++q)
      if (cnt[q] >= fw) return true;
    return false;
  }
  __device__ __forceinline__ bool any_queued() const {
    for (int q = 0; q < nq; ++q)
      if (cnt[q] > 0) return true;
    return false;
  }
};

// Warp-aggregated push: every lane of the warp calls it; the lanes with
// `want` take consecutive slots of query q's queue.  Returns false for a
// lane whose slot lay past the queue's end (retry after a flush).
__device__ __forceinline__ bool push_warp(const Sel& s, int q, bool want,
                                          float d, int p, int id) {
  const unsigned m = __ballot_sync(FULL, want);
  if (m == 0) return true;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&s.cnt[q], __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (!want) return true;
  const int off = base + __popc(m & ((1u << lane) - 1u));
  if (off >= s.fw) return false;
  s.put(q, off, d, p, id);
  return true;
}

__device__ __forceinline__ bool push_one(const Sel& s, int q, float d, int p,
                                         int id) {
  const int off = atomicAdd(&s.cnt[q], 1);
  if (off >= s.fw) return false;
  s.put(q, off, d, p, id);
  return true;
}

// Warp-aggregated append (GS): every lane of the warp calls it; the lanes
// with `want` write their triples to consecutive entries of row b (cap
// wide), claimed with one atomic on the row's fill rn[b].
__device__ __forceinline__ void append_warp(float* rd, int32_t* rp,
                                            int32_t* ri, int* rn, int b,
                                            int cap, bool want, float d,
                                            int p, int id) {
  const unsigned m = __ballot_sync(FULL, want);
  if (m == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&rn[b], __popc(m));
  base = __shfl_sync(FULL, base, leader);
  const int off = base + __popc(m & ((1u << lane) - 1u));
  if (!want || off >= cap) return;  // off < cap for a plan of cap / BLK
  const size_t o = (size_t)b * cap + off;
  rd[o] = d;
  rp[o] = p;
  ri[o] = id;
}

// Put the pair (i, l) of one triple array in order: ascending if `asc`.
__device__ __forceinline__ void order_pair(float* d, int* p, int* id, int i,
                                           int l, bool asc) {
  const float di = d[i], dl = d[l];
  const int pi = p[i], pl = p[l];
  if (asc ? lex_less(dl, pl, di, pi) : lex_less(di, pi, dl, pl)) {
    d[i] = dl;
    d[l] = di;
    p[i] = pl;
    p[l] = pi;
    const int t = id[i];
    id[i] = id[l];
    id[l] = t;
  }
}

// One compare-exchange stage at distance jj over the nq arrays of width
// fw (lw = log2 fw) that have something queued: pair c of array q orders
// (i, i + jj), i = 2 * jj * (c / jj) + c % jj, ascending where i & k is 0
// (k = 0: all ascending).  Thread tid takes pairs tid, tid + nt, ...: for
// jj <= 32 the 32 pairs of a warp touch one aligned run of 64 elements,
// so stages that narrow need only __syncwarp between them.
__device__ __forceinline__ void bitonic_stage(float* d, int* p, int* id,
                                              const int* cnt, int nq, int lw,
                                              int k, int jj) {
  const int half = nq << (lw - 1), cmask = (1 << (lw - 1)) - 1;
  for (int t = threadIdx.x; t < half; t += blockDim.x) {
    const int q = t >> (lw - 1), c = t & cmask;
    if (cnt[q] == 0) continue;
    const int i = ((c & ~(jj - 1)) << 1) | (c & (jj - 1));
    const int o = q << lw;
    order_pair(d + o, p + o, id + o, i, i + jj, (i & k) == 0);
  }
}

// The barrier after a stage at distance jj that precedes one at `next`
// (ACROSS for a step that reads other warps' elements): a block barrier
// when either spans more than a warp's 64 elements.
__device__ __forceinline__ void stage_sync(int jj, int next) {
  if (jj > 32 || next > 32)
    __syncthreads();
  else
    __syncwarp();
}

// Merge every non-empty queue into its accumulator.  All threads call it,
// after a barrier; it ends with one.  Afterwards every queue is empty and
// each accumulator holds the top FW of its old contents and its queue.
__device__ void flush(const Sel& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fw = s.fw, lw = s.lw, n = s.nq << lw;
  // pad each queue past its fill
  for (int j = tid; j < n; j += nt)
    if ((j & (fw - 1)) >= s.cnt[j >> lw]) s.put(0, j, inf(), PAD_POS, -1);
  __syncthreads();
  // bitonic sort of each queue, ascending
  for (int k = 2; k <= fw; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      bitonic_stage(s.qd, s.qp, s.qi, s.cnt, s.nq, lw, k, jj);
      stage_sync(jj, jj > 1 ? jj >> 1 : (k < fw ? k : ACROSS));
    }
  }
  // min(acc[i], queue[FW - 1 - i]) is the top FW of the two, bitonic
  for (int j = tid; j < n; j += nt) {
    const int q = j >> lw;
    if (s.cnt[q] == 0) continue;
    const int o = (q << lw) + fw - 1 - (j & (fw - 1));
    if (lex_less(s.qd[o], s.qp[o], s.ad[j], s.ap[j])) {
      s.ad[j] = s.qd[o];
      s.ap[j] = s.qp[o];
      s.ai[j] = s.qi[o];
    }
  }
  __syncthreads();
  // bitonic merge of each accumulator: log2(FW) half-cleaner stages
  for (int jj = fw >> 1; jj > 0; jj >>= 1) {
    bitonic_stage(s.ad, s.ap, s.ai, s.cnt, s.nq, lw, 0, jj);
    stage_sync(jj, jj > 1 ? jj >> 1 : ACROSS);
  }
  for (int q = tid; q < s.nq; q += nt) s.cnt[q] = 0;
  __syncthreads();
}

// Words of the six FW-wide selection arrays of nq queries.
__host__ __device__ __forceinline__ size_t sel_array_words(int nq, int fw) {
  return 6 * (size_t)nq * fw;
}

// Point nq accumulators and queues of width fw at `p` (shared memory:
// sel_array_words(nq, fw) words) and their fills at `cnt` (nq words).
__device__ __forceinline__ void carve(Sel& s, int* p, int* cnt, int nq,
                                      int fw, int fetch) {
  const size_t n = (size_t)nq * fw;
  s.ad = reinterpret_cast<float*>(p);
  s.ap = p + n;
  s.ai = p + 2 * n;
  s.qd = reinterpret_cast<float*>(p + 3 * n);
  s.qp = p + 4 * n;
  s.qi = p + 5 * n;
  s.cnt = cnt;
  s.nq = nq;
  s.fw = fw;
  s.lw = __ffs(fw) - 1;
  s.fetch = fetch;
}

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
  int* cnt = smem + n_lut + n_sel;                         // QT (not GS)
  Sel sel;
  if (!GS) carve(sel, smem + n_lut, cnt, QT, FW, fetch);
  int* sslot = cnt + (GS ? 0 : QT);                        // QT * P
  int* sdco = sslot + QT * P;                              // QT

  const float* glut = lut + (size_t)qi * QS * M * K;
  for (int j = tid; j < n_lut; j += NT) slut[j] = glut[j];
  const auto tabs = tables<GT>(glut, slut);
  if (!GS) {
    for (int j = tid; j < QT * FW; j += NT) {
      sel.ad[j] = inf();
      sel.ap[j] = PAD_POS;
      sel.ai[j] = -1;
    }
    for (int q = tid; q < QT; q += NT) sel.cnt[q] = 0;
  }
  for (int q = tid; q < QT; q += NT) sdco[q] = 0;

  const int f_end = s1 * BLK;
  for (int f0 = s0 * BLK; f0 < f_end; f0 += NT) {
    const int sr = f0 / BLK;  // first position of the round
    for (int j = tid; j < QT * P; j += NT) {
      const int q = j / P, s = sr + j % P;
      sslot[j] = s < s1 ? slot_of[(size_t)(qi * QS + q) * S + s] : -1;
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
      const int blk = tile_idx[(size_t)qi * S + s];
      const size_t item = (size_t)blk * BLK + ln;
      iid = block_ids[item];
      if (iid >= 0) {
        oth = block_other[item];
        is_dead = dead != nullptr && dead[item] != 0;
        row = codes + item * MB;
      }
    }
    if (iid < 0) plan = 0;  // item_ok needs a valid item
    uint64_t pend = 0;      // queries whose queue was full for this item
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
        else if (!push_warp(sel, q, want, d, pos, iid))
          pend |= 1ull << q;
      }
    }
    __syncthreads();
    while (!GS && __syncthreads_or(sel.any_full())) {
      flush(sel);
      for (uint64_t r = pend; r; r &= r - 1) {
        const int q = __ffsll((long long)r) - 1;
        const float d = score_row<PACKED>(row, tabs + (size_t)q * M * K, K,
                                          MB, vec16 != 0);
        const int pos = sslot[q * P + p] * BLK + ln;
        if (!sel.beats(q, d, pos) || push_one(sel, q, d, pos, iid))
          pend &= ~(1ull << q);
      }
      __syncthreads();
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

// One CTA per query: the top-F under (d, pos) of `splits` ascending lists
// of F triples, (B, splits, F) -> (B, F).  The first list seeds the
// accumulator; the others pass through the same filter and queue as the
// scan.  Where one query's selection arrays pass a CTA's shared memory
// (fetch above 8192) the wrapper merges with the row select instead
// (csrc/topk_select.cu).
__global__ void __launch_bounds__(MERGE_NT) topk_merge(
    const float* __restrict__ part_d, const int32_t* __restrict__ part_pos,
    const int32_t* __restrict__ part_id, float* __restrict__ out_d,
    int32_t* __restrict__ out_pos, int32_t* __restrict__ out_id, int splits,
    int fetch, int FW) {
  extern __shared__ int smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  Sel sel;
  carve(sel, smem, smem + sel_array_words(1, FW), 1, FW, fetch);
  const size_t base = (size_t)b * splits * fetch;
  for (int c = tid; c < FW; c += MERGE_NT) {
    const bool in = c < fetch;
    sel.ad[c] = in ? part_d[base + c] : inf();
    sel.ap[c] = in ? part_pos[base + c] : PAD_POS;
    sel.ai[c] = in ? part_id[base + c] : -1;
  }
  if (tid == 0) sel.cnt[0] = 0;
  __syncthreads();
  const int n = (splits - 1) * fetch;
  for (int f0 = 0; f0 < n; f0 += MERGE_NT) {
    const int f = f0 + tid;
    float d = inf();
    int p = PAD_POS, id = -1;
    if (f < n) {
      d = part_d[base + fetch + f];
      p = part_pos[base + fetch + f];
      id = part_id[base + fetch + f];
    }
    bool pend = !push_warp(sel, 0, f < n && sel.beats(0, d, p), d, p, id);
    __syncthreads();
    while (__syncthreads_or(sel.any_full())) {
      flush(sel);
      if (pend && (!sel.beats(0, d, p) || push_one(sel, 0, d, p, id)))
        pend = false;
      __syncthreads();
    }
  }
  if (sel.any_queued()) flush(sel);
  for (int c = tid; c < fetch; c += MERGE_NT) {
    out_d[(size_t)b * fetch + c] = sel.ad[c];
    out_pos[(size_t)b * fetch + c] = sel.ap[c];
    out_id[(size_t)b * fetch + c] = sel.ai[c];
  }
}

bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

using ScanKernel = decltype(&pq_scan_topk<false, false, false>);

template <bool GT, bool GS>
ScanKernel scan_kernel(bool packed) {
  return packed ? pq_scan_topk<true, GT, GS> : pq_scan_topk<false, GT, GS>;
}

// Dynamic shared memory of one scan CTA (pq_scan_topk_smem_bytes).
size_t scan_smem_bytes(int M, int K, int QT, int FW, int BLK, bool gt,
                       bool gs) {
  const int P = NT / BLK > 1 ? NT / BLK : 1;
  const size_t tables = gt ? 0 : (size_t)QT * M * K;
  const size_t arrays = gs ? 0 : sel_array_words(QT, FW) + QT;
  return sizeof(int) * (tables + arrays + (size_t)QT * P + QT);
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
  if (QT < 1 || QT > MAX_QT || QT > QS || B % QS != 0 || !pow2(BLK) ||
      splits < 1 || s_per < 1 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int T = B / QS;
  if (T == 0) return 0;
  const bool gs = row_n != nullptr;
  const size_t smem =
      scan_smem_bytes(M, K, QT, FW, BLK, global_tables != 0, gs);
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
// read from global memory), the selection arrays and queue fills (none in
// the candidate-row form), and the round's staged plan slots and DCO
// counts (layout at the top of pq_scan_topk).  The wrapper picks the form
// and cuts a tile into query groups by it
// (kernels/pq_scan.py::query_groups).
size_t pq_scan_topk_smem_bytes(int M, int K, int QT, int FW, int BLK,
                               int global_tables, int global_state) {
  return scan_smem_bytes(M, K, QT, FW, BLK, global_tables != 0,
                         global_state != 0);
}

// Dynamic shared memory of one merge CTA (one query).
size_t topk_merge_smem_bytes(int FW) {
  return sizeof(int) * (sel_array_words(1, FW) + 1);
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
// global_tables: read the tables from global memory.
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
// (d, pos); out_d / out_pos / out_id (B, fetch).  FW as above, with
// topk_merge_smem_bytes(FW) within a CTA's shared memory.
int topk_merge_launch(const void* part_d, const void* part_pos,
                      const void* part_id, void* out_d, void* out_pos,
                      void* out_id, int B, int splits, int fetch, int FW,
                      void* stream) {
  if (!pow2(FW) || FW < 2 || fetch < 1 || fetch > FW || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = topk_merge_smem_bytes(FW);
  cudaError_t err = cudaFuncSetAttribute(
      topk_merge, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<dim3(B), dim3(MERGE_NT), smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_d),
      static_cast<const int32_t*>(part_pos),
      static_cast<const int32_t*>(part_id), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_pos), static_cast<int32_t*>(out_id), splits,
      fetch, FW);
  return (int)cudaGetLastError();
}

}  // extern "C"
