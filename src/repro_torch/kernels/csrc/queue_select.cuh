// The per-query top-F selection in shared memory of K3 (pq_scan_topk.cu)
// and of the stream's delta scan (delta_scan_topk.cu): the filter / queue /
// merge scheme, the candidate-row append, and the shared-memory layout of
// the selection state (see pq_scan_topk.cu's "Filter, queue, merge" and
// "Candidate rows").  Keys are (d, pos), ascending, pos unique among a
// query's candidates; pads are (+inf, PAD_POS, -1).
#pragma once

#include <cstddef>
#include <cstdint>

namespace {

constexpr int PAD_POS = 1 << 30;
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
  int* w;     // flush: nq sort widths, nq merge widths, and their maxima
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
  __device__ __forceinline__ bool any_queued() const {
    for (int q = 0; q < nq; ++q)
      if (cnt[q] > 0) return true;
    return false;
  }
};

// Warp-aggregated push: every lane of the warp calls it; the lanes with
// `want` take consecutive slots of query q's queue.  Returns false for a
// lane whose slot lay past the queue's end (retry after a flush).  Sets
// `full` in every lane of a warp whose push filled the queue: a queue is
// full after a round iff some push of the round filled it, so the round's
// end needs no second barrier to read the fills.
__device__ __forceinline__ bool push_warp(const Sel& s, int q, bool want,
                                          float d, int p, int id,
                                          bool& full) {
  const unsigned m = __ballot_sync(FULL, want);
  if (m == 0) return true;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&s.cnt[q], __popc(m));
  base = __shfl_sync(FULL, base, leader);
  full |= base + __popc(m) >= s.fw;
  if (!want) return true;
  const int off = base + __popc(m & ((1u << lane) - 1u));
  if (off >= s.fw) return false;
  s.put(q, off, d, p, id);
  return true;
}

__device__ __forceinline__ bool push_one(const Sel& s, int q, float d, int p,
                                         int id, bool& full) {
  const int off = atomicAdd(&s.cnt[q], 1);
  full |= off + 1 >= s.fw;
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

// One compare-exchange stage at distance jj over the first w[q] elements
// of each of the nq arrays of stride fw (lw = log2 fw), skipping an array
// whose w[q] is below k: pair c of array q orders (i, i + jj),
// i = 2 * jj * (c / jj) + c % jj, ascending where i & k is 0 (k = 0: all
// ascending).  Thread tid takes pairs tid, tid + nt, ...: for jj <= 32 the
// 32 pairs of a warp touch one aligned run of 64 elements, so stages that
// narrow need only __syncwarp between them.
__device__ __forceinline__ void bitonic_stage(float* d, int* p, int* id,
                                              const int* w, int nq, int lw,
                                              int k, int jj) {
  const int half = nq << (lw - 1), cmask = (1 << (lw - 1)) - 1;
  for (int t = threadIdx.x; t < half; t += blockDim.x) {
    const int q = t >> (lw - 1), c = t & cmask;
    if (2 * c >= w[q] || k > w[q]) continue;
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
// each accumulator holds the top FW of its old contents and its queue.  A
// queue is sorted only as wide as its fill (the next power of two; pads
// after the fill), and only as many stages as the widest queue needs; an
// accumulator that holds only pads takes its sorted queue as it is, and
// only the others merge (where a split keeps fewer than FW items a query,
// its one flush sorts each queue at its fill's width and merges nothing).
__device__ void flush(const Sel& s) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int fw = s.fw, lw = s.lw, nq = s.nq, n = nq << lw;
  int* sw = s.w;             // sort widths
  int* mw = s.w + nq;        // merge widths: FW, or 0 for no merge
  int* wmax = s.w + 2 * nq;  // the largest of each, zero between flushes
  for (int q = tid; q < nq; q += nt) {
    const int c = min(s.cnt[q], fw);
    sw[q] = c == 0 ? 0 : c <= 2 ? 2 : 1 << (32 - __clz(c - 1));
    mw[q] = c > 0 && s.ap[q << lw] != PAD_POS ? fw : 0;
    atomicMax(&wmax[0], sw[q]);
    atomicMax(&wmax[1], mw[q]);
  }
  // pad each queue past its fill
  for (int j = tid; j < n; j += nt)
    if ((j & (fw - 1)) >= s.cnt[j >> lw]) s.put(0, j, inf(), PAD_POS, -1);
  __syncthreads();
  const int ws = wmax[0], wm = wmax[1];
  // bitonic sort of each queue, ascending
  for (int k = 2; k <= ws; k <<= 1) {
    for (int jj = k >> 1; jj > 0; jj >>= 1) {
      bitonic_stage(s.qd, s.qp, s.qi, sw, nq, lw, k, jj);
      stage_sync(jj, jj > 1 ? jj >> 1 : (k < ws ? k : ACROSS));
    }
  }
  // min(acc[i], queue[FW - 1 - i]) is the top FW of the two, bitonic; an
  // accumulator of pads takes the sorted queue
  for (int j = tid; j < n; j += nt) {
    const int q = j >> lw;
    if (sw[q] == 0) continue;
    const int o = mw[q] ? (q << lw) + fw - 1 - (j & (fw - 1)) : j;
    if (!mw[q] || lex_less(s.qd[o], s.qp[o], s.ad[j], s.ap[j])) {
      s.ad[j] = s.qd[o];
      s.ap[j] = s.qp[o];
      s.ai[j] = s.qi[o];
    }
  }
  __syncthreads();
  // bitonic merge of each accumulator that merged: log2(FW) half-cleaners
  for (int jj = wm >> 1; jj > 0; jj >>= 1) {
    bitonic_stage(s.ad, s.ap, s.ai, mw, nq, lw, 0, jj);
    stage_sync(jj, jj > 1 ? jj >> 1 : ACROSS);
  }
  for (int q = tid; q < nq; q += nt) s.cnt[q] = 0;
  if (tid < 2) wmax[tid] = 0;
  __syncthreads();
}

// Words of the six FW-wide selection arrays of nq queries.
__host__ __device__ __forceinline__ size_t sel_array_words(int nq, int fw) {
  return 6 * (size_t)nq * fw;
}

// Words of the fills and flush widths of nq queries (Sel::cnt, Sel::w).
__host__ __device__ __forceinline__ size_t sel_count_words(int nq) {
  return 3 * (size_t)nq + 2;
}

// Point nq accumulators and queues of width fw at `p` (shared memory:
// sel_array_words(nq, fw) words) and their fills and flush widths at `cnt`
// (sel_count_words(nq) words).
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
  s.w = cnt + nq;
  s.nq = nq;
  s.fw = fw;
  s.lw = __ffs(fw) - 1;
  s.fetch = fetch;
}

}  // namespace
