// Row select: the stable top-`fetch` of a row of (d, pos, id) triples under
// (d, pos), for Hopper (sm_90a).  One CTA per row.
//
// It is the second half of K3's candidate-row form (pq_scan_topk.cu, GS):
// together with the scan to rows it replaces, where fetch is above 8192,
// src/repro/kernels/pq_scan.py::pq_scan_topk_kernel's selection (its
// in-kernel network K4, src/repro/kernels/topk.py: bitonic_sort,
// bitonic_merge, merge_topf).  It also merges K3's split lists above fetch
// 8192 (kernels/pq_scan.py::merge_topk_kernel), a row being the
// concatenated lists of one query.
//
// Contract (kernels/ref.py::select_topk_ref): of the first n entries of a
// row (n = row_n[b], or the whole width W), the `fetch` first in the
// stable order by (d, pos), then pads (+inf, PAD_POS, -1).  d compares as
// an f32 (-0.0 equals +0.0; a NaN is last); pos as an int32.  On K3's rows
// (d, pos) is unique, so the order inside a row does not matter.
//
// What bounds it on this card: the bytes of the row (12 per entry, read
// once or a few times) and of the output are few; the cost is the
// ordering work of each CTA.  The design keeps that work in shared memory
// and does no more of it than the row needs:
//   1. Threshold.  When the row holds more than fetch entries, a radix
//      select finds the fetch-th key of the 64-bit key (monotone bits of d,
//      pos): passes of 11 bits from the top, each a shared-memory
//      histogram of the entries that match the digits found so far,
//      streamed from the row.  It stops as soon as the bucket of the
//      fetch-th key holds exactly the entries still needed.  When the row
//      holds at most fetch entries (K3's wide case: a paged query keeps
//      ~12,200 of 17,792 planned items for fetch 16,000) it does nothing.
//   2. Compaction.  One more pass writes the survivors (at most fetch), in
//      row order, to shared memory as (d bits, pos) and their ids to a
//      scratch tensor; with equal keys the first in row order win.
//   3. Sort.  An LSD radix sort of the survivors by the 64-bit key, 8 bits
//      a pass from the least significant, stable, that moves only a
//      16-bit permutation (keys stay in place); a pass whose digit is the
//      same for every survivor is skipped (the compaction ORs and ANDs
//      their keys: pos < 65,536 and the top bits of d that a row shares).
//      Each of the 32 warps ranks its own segment with one ballot a digit
//      bit and a warp-private histogram, so the scatter keeps the order of
//      equal digits.
//   4. The output gathers d, pos and id through the final permutation.
// Survivors that do not fit in shared memory (fetch above 16,618) take
// the same steps with keys and permutation in the scratch tensor (32-bit
// permutation); the shape alone picks that (topk_select_smem_bytes).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PAD_POS = 1 << 30;
constexpr int NT = 1024;           // threads of a select CTA
constexpr int NW = NT / 32;        // its warps
constexpr int SEL_BITS = 11;       // digit of a threshold pass
constexpr int SORT_BINS = 256;     // an 8-bit digit of a sort pass
constexpr int HIST = NW * SORT_BINS;  // ints: warp histograms, >= 1 << 11
constexpr int U = 4;               // row entries a thread loads at once
constexpr int MISC = 64;           // ints: block-scan partials and results
constexpr unsigned FULL = 0xffffffffu;

// Monotone 32 bits of an f32: unsigned order of the result is the order of
// the values; -0.0 takes +0.0's bits, every NaN the largest.
__device__ __forceinline__ uint32_t dkey(uint32_t u) {
  if ((u << 1) == 0) u = 0;
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The 64-bit key of a triple: dkey above, pos (as a signed int) below.
__device__ __forceinline__ uint64_t key64(uint32_t dbits, int pos) {
  return ((uint64_t)dkey(dbits) << 32) | (uint32_t)(pos ^ 0x80000000);
}

// The lanes of the warp whose `bits`-bit value v equals this lane's, among
// the lanes with `on` (every lane calls it): one ballot a bit, where
// __match_any_sync costs a step per distinct value.
__device__ __forceinline__ unsigned peers(unsigned v, int bits, bool on) {
  unsigned m = __ballot_sync(FULL, on);
  for (int b = 0; b < bits; ++b) {
    const unsigned x = __ballot_sync(FULL, (v >> b) & 1u);
    m &= ((v >> b) & 1u) ? x : ~x;
  }
  return m;
}

// Exclusive prefix sum over the block in thread order; `tmp` holds NW + 1
// ints of shared memory.  All threads call it; it ends with a barrier.
__device__ __forceinline__ int block_exclusive(int x, int* tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NW ? tmp[lane] : 0, wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, wi, o);
      if (lane >= o) wi += y;
    }
    if (lane < NW) tmp[lane] = wi - w;
    if (lane == NW - 1) tmp[NW] = wi;
  }
  __syncthreads();
  const int r = tmp[warp] + inc - x;
  *total = tmp[NW];
  __syncthreads();
  return r;
}

// One CTA per row b.  P is the permutation's type: uint16_t when keys and
// permutation live in shared memory (fetch < 65,536), uint32_t in the
// scratch tensor (GLOBAL).
template <typename P, bool GLOBAL>
__global__ void __launch_bounds__(NT) topk_select(
    const float* __restrict__ row_d, const int32_t* __restrict__ row_pos,
    const int32_t* __restrict__ row_id, const int32_t* __restrict__ row_n,
    float* __restrict__ out_d, int32_t* __restrict__ out_pos,
    int32_t* __restrict__ out_id, int* __restrict__ scratch, int W,
    int fetch, size_t scratch_words) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int* hist = smem;              // HIST ints
  int* misc = smem + HIST;       // MISC ints
  int* reg = scratch + (size_t)b * scratch_words;
  uint2* keys;                   // fetch survivors: (d bits, pos)
  P *pa, *pb;                    // permutations, ping-pong
  if (GLOBAL) {
    keys = reinterpret_cast<uint2*>(reg);
    pa = reinterpret_cast<P*>(reg + 2 * (size_t)fetch);
    pb = pa + fetch;
  } else {
    keys = reinterpret_cast<uint2*>(smem + HIST + MISC);
    pa = reinterpret_cast<P*>(keys + fetch);
    pb = pa + fetch;
  }
  int32_t* sid = reg + (GLOBAL ? 4 * (size_t)fetch : 0);  // survivors' ids

  const size_t base = (size_t)b * W;
  const uint32_t* dr = reinterpret_cast<const uint32_t*>(row_d) + base;
  const int32_t* pr = row_pos + base;
  const int n = row_n ? min(max(row_n[b], 0), W) : W;

  // 1. threshold: survivors are the entries whose key >> hi is below
  // prefix >> hi, then the first `need` in row order whose key >> hi equals
  // it (everything when the row holds at most fetch entries)
  const bool all = n <= fetch;
  uint64_t prefix = 0;
  int hi = 64, need = fetch;
  while (!all && hi > 0) {
    // digits [53, 64), [42, 53), [32, 42) of d, then [21, 32), [10, 21),
    // [0, 10) of pos: a pass over d alone never reads pos
    const int lo = hi > 32 ? max(hi - SEL_BITS, 32) : max(hi - SEL_BITS, 0);
    const int bins = 1 << (hi - lo);
    for (int v = tid; v < bins; v += NT) hist[v] = 0;
    __syncthreads();
    for (int i0 = 0; i0 < n; i0 += U * NT) {
      // U loads in flight a thread; one shared atomic per warp and digit
      // (a row's distances share few top digits)
      uint32_t du[U];
      int p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * NT + tid;
        du[u] = i < n ? dr[i] : 0;
        p[u] = i < n && lo < 32 ? pr[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint64_t k = key64(du[u], p[u]);
        const bool on = i0 + u * NT + tid < n &&
                        (hi == 64 || (k >> hi) == (prefix >> hi));
        const unsigned v = (unsigned)(k >> lo) & (bins - 1);
        const unsigned m = peers(v, hi - lo, on);
        if (on && lane == __ffs(m) - 1) atomicAdd(&hist[v], __popc(m));
      }
    }
    __syncthreads();
    // the bucket holding the need-th matching entry: bins / NT a thread
    const int per = (bins + NT - 1) / NT, v0 = tid * per;
    int sum = 0;
    for (int v = v0; v < min(v0 + per, bins); ++v) sum += hist[v];
    int total;
    int before = block_exclusive(sum, misc, &total);
    for (int v = v0; v < min(v0 + per, bins); ++v) {
      if (before < need && need <= before + hist[v]) {
        misc[NW + 1] = v;
        misc[NW + 2] = before;
        misc[NW + 3] = hist[v];
      }
      before += hist[v];
    }
    __syncthreads();
    const int v = misc[NW + 1], below = misc[NW + 2], eq = misc[NW + 3];
    __syncthreads();
    prefix |= (uint64_t)v << lo;
    need -= below;
    hi = lo;
    if (eq == need) break;
  }

  // 2. compaction, in row order, of the c survivors; the bits that differ
  // between their keys tell the sort which digits to skip
  const int c = all ? n : fetch;
  int less_base = 0, eq_base = 0;
  uint64_t k_or = 0, k_and = ~0ull;
  const uint64_t ph = hi == 64 ? 0 : prefix >> hi;
  for (int i0 = 0; i0 < n; i0 += U * NT) {
    // thread t takes entries i0 + t * U + [0, U), so row order is thread
    // order; one block scan of (kept below, kept equal) counts a chunk
    uint32_t du[U];
    int p[U];
    bool lt[U], eq[U];
    int nl = 0, ne = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + tid * U + u;
      du[u] = i < n ? dr[i] : 0;
      p[u] = i < n ? pr[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = i0 + tid * U + u < n;
      const uint64_t kh = all ? 0 : key64(du[u], p[u]) >> hi;
      lt[u] = in && (all || kh < ph);
      eq[u] = in && !all && kh == ph;
      nl += lt[u];
      ne += eq[u];
    }
    int tot;
    const int pre = block_exclusive(nl | (ne << 16), misc, &tot);
    int l_pre = pre & 0xffff, e_pre = pre >> 16;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e_rank = eq_base + e_pre;
      if (lt[u] || (eq[u] && e_rank < need)) {
        const int o = less_base + l_pre + min(e_rank, need);
        keys[o] = make_uint2(du[u], (uint32_t)p[u]);
        sid[o] = row_id[base + i0 + tid * U + u];
        const uint64_t k = key64(du[u], p[u]);
        k_or |= k;
        k_and &= k;
      }
      l_pre += lt[u];
      e_pre += eq[u];
    }
    less_base += tot & 0xffff;
    eq_base += tot >> 16;
  }

  // 3. LSD radix sort of the survivors' permutation, 8 bits a pass
  unsigned long long* diff = reinterpret_cast<unsigned long long*>(misc);
  if (tid == 0) {
    diff[0] = 0;
    diff[1] = ~0ull;
  }
  __syncthreads();
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    k_or |= __shfl_xor_sync(FULL, k_or, o);
    k_and &= __shfl_xor_sync(FULL, k_and, o);
  }
  if (lane == 0) {
    atomicOr(&diff[0], (unsigned long long)k_or);
    atomicAnd(&diff[1], (unsigned long long)k_and);
  }
  for (int i = tid; i < c; i += NT) pa[i] = (P)i;
  __syncthreads();
  const uint64_t varies = diff[0] ^ diff[1];
  const int seg = (c + NW - 1) / NW;
  const int w0 = min(c, warp * seg), w1 = min(c, w0 + seg);
  const unsigned below_me = (1u << lane) - 1u;
  for (int pass = 0; pass < 8; ++pass) {
    const int sh = 8 * pass;
    if (((varies >> sh) & 0xffu) == 0) continue;  // the same for all
    for (int j = tid; j < HIST; j += NT) hist[j] = 0;
    __syncthreads();
    // count: warp w's histogram of its segment, hist[w * SORT_BINS + digit]
    for (int i0 = w0; i0 < w1; i0 += 32) {
      const int i = i0 + lane;
      unsigned v = 0;
      if (i < w1) {
        const uint2 kv = keys[pa[i]];
        v = (unsigned)(key64(kv.x, (int)kv.y) >> sh) & (SORT_BINS - 1);
      }
      const unsigned m = peers(v, 8, i < w1);
      if (i < w1 && lane == __ffs(m) - 1)
        hist[warp * SORT_BINS + v] += __popc(m);
      __syncwarp();
    }
    __syncthreads();
    // exclusive offsets in (digit, warp) order: a thread per digit
    int sum = 0;
    if (tid < SORT_BINS)
      for (int w = 0; w < NW; ++w) sum += hist[w * SORT_BINS + tid];
    int total;
    int run = block_exclusive(sum, misc, &total);
    if (tid < SORT_BINS)
      for (int w = 0; w < NW; ++w) {
        const int h = hist[w * SORT_BINS + tid];
        hist[w * SORT_BINS + tid] = run;
        run += h;
      }
    __syncthreads();
    // scatter, in the count's order: stable
    for (int i0 = w0; i0 < w1; i0 += 32) {
      const int i = i0 + lane;
      unsigned v = 0;
      P src = 0;
      if (i < w1) {
        src = pa[i];
        const uint2 kv = keys[src];
        v = (unsigned)(key64(kv.x, (int)kv.y) >> sh) & (SORT_BINS - 1);
      }
      const unsigned m = peers(v, 8, i < w1);
      int off = 0;
      if (i < w1) off = hist[warp * SORT_BINS + v];
      __syncwarp();
      if (i < w1) {
        pb[off + __popc(m & below_me)] = src;
        if (lane == __ffs(m) - 1) hist[warp * SORT_BINS + v] = off + __popc(m);
      }
      __syncwarp();
    }
    __syncthreads();
    P* t = pa;
    pa = pb;
    pb = t;
  }

  // 4. output: the survivors in order, then pads
  const size_t ob = (size_t)b * fetch;
  for (int i = tid; i < fetch; i += NT) {
    if (i < c) {
      const P j = pa[i];
      const uint2 kv = keys[j];
      out_d[ob + i] = __uint_as_float(kv.x);
      out_pos[ob + i] = (int32_t)kv.y;
      out_id[ob + i] = sid[j];
    } else {
      out_d[ob + i] = __uint_as_float(0x7f800000u);
      out_pos[ob + i] = PAD_POS;
      out_id[ob + i] = -1;
    }
  }
}

// Shared memory of a select CTA: histograms, scan partials and, unless
// they live in the scratch tensor, fetch keys and two 16-bit permutations.
size_t smem_bytes(int fetch, bool global) {
  return sizeof(int) * (HIST + MISC) +
         (global ? 0 : (size_t)fetch * (sizeof(uint2) + 2 * sizeof(uint16_t)));
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one select CTA; the wrapper takes the global
// form (global = 1) when the shared one passes a CTA's limit.
size_t topk_select_smem_bytes(int fetch, int global) {
  return smem_bytes(fetch, global != 0);
}

// int32 words of scratch a row needs: the survivors' ids and, in the
// global form, their keys and two 32-bit permutations (an even count, so
// every row's keys stay 8-byte aligned).
size_t topk_select_scratch_words(int fetch, int global) {
  const size_t f = (size_t)fetch;
  return global ? 5 * f + (f & 1) : f + (f & 1);
}

// row_d / row_pos / row_id (B, W); row_n (B,) i32 or NULL (every row full);
// out_d / out_pos / out_id (B, fetch); scratch B *
// topk_select_scratch_words(fetch, global) i32.  fetch >= 1; in the shared
// form fetch < 65,536.
int topk_select_launch(const void* row_d, const void* row_pos,
                       const void* row_id, const void* row_n, void* out_d,
                       void* out_pos, void* out_id, void* scratch, int B,
                       int W, int fetch, int global, void* stream) {
  if (fetch < 1 || W < 0 || (!global && fetch >= 65536))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(fetch, global != 0);
  auto kern = global ? topk_select<uint32_t, true>
                     : topk_select<uint16_t, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(B), dim3(NT), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(row_d), static_cast<const int32_t*>(row_pos),
      static_cast<const int32_t*>(row_id),
      static_cast<const int32_t*>(row_n), static_cast<float*>(out_d),
      static_cast<int32_t*>(out_pos), static_cast<int32_t*>(out_id),
      static_cast<int*>(scratch), W, fetch,
      topk_select_scratch_words(fetch, global));
  return (int)cudaGetLastError();
}

}  // extern "C"
