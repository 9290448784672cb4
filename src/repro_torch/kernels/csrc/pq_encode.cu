// PQ encoding: each row's nearest centroid in every subquantizer, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the reference's pq_encode
// (src/repro/core/pq.py::pq_encode) is plain JAX, a vmap over the
// subquantizers that XLA fuses.  It takes the place of the port's plain
// version on the card (core/pq.py::pq_encode's loop over the M
// subquantizers, a distance matmul, argmin, cast and strided store each:
// about 12 launches a subquantizer, 800 a call at M 64, whatever n).  The
// stream's insert encodes a few dozen rows a call, so those launches, not
// the arithmetic, were its cost.  And a library matmul picks its algorithm
// (and so its rounding) by shape: a row encoded in a batch of 38 could get
// another code than in the build's 65,536.  Here every code is computed in
// one fixed order that depends on the row and the codebook alone, so
// insert, build and compaction agree bitwise on the card.
//
// What it computes (the plain version's formula).  Codebook (M, K, dsub)
// f32, rows x (n, M * dsub) f32.  For row r and subquantizer m, with
// x = x[r, m * dsub:(m + 1) * dsub] and c_k = codebook[m, k]:
//   x2 = sum_d x[d] * x[d],  c2[k] = sum_d c_k[d] * c_k[d],
//   xc[k] = sum_d x[d] * c_k[d]   (each an fmaf chain over ascending d),
//   dist[k] = max((x2 - 2 * xc[k]) + c2[k], 0)   (each step rounded once),
//   code[r, m] = the first k of least dist over ascending k (argmin's rule:
//   a tie keeps the lower code).
// The plain version sums in the order its matmul and reductions choose, so
// the two differ only where two centroids' distances are an f32 tie.
//
// What bounds it on this card: bytes, n * M * dsub * 4 read once and n * M
// written (the codebook, 8 KB at SIFT's PQ64x4 and 128 KB at PQ64x8, stays
// in shared memory and L2) at K 16; at K 256 the arithmetic, n * M * K *
// dsub fmafs and about eight more instructions a centroid, bounds it.  At
// the stream's insert sizes (tens of rows) one launch's latency is all
// there is.  The design:
//   * Grid (row CTAs, chunks of MS subquantizers).  A CTA stages its chunk's
//     books in shared memory and computes their c2 once, then walks tiles of
//     32 rows (grid-stride: the wrapper sizes the grid to one wave,
//     kernels/pq_scan.py::encode_plan).  MS is all M where the CTA's shared
//     memory stays within a quarter of an SM's, so that four CTAs (32
//     warps) hide each centroid's chain of dependent steps (SIFT PQ64x4:
//     31 KB), else the fewest equal chunks that do (PQ64x8: 4 of 16,
//     PQ256x8 at dsub 1: 10 of 26).
//   * A tile's rows are copied into shared memory, a warp a row and
//     coalesced, at an odd row stride so that the 32 lanes' reads below hit
//     32 banks.
//   * A lane is a row and a warp takes every eighth subquantizer of the
//     chunk: the warp's 32 lanes read the same centroid at the same time
//     (a broadcast), each against its own row's slice held in registers
//     (dsub 1, 2, 4 and 8 are compiled in; any other dsub reads the slice
//     from shared memory).  No atomics, no warp collectives.
//   * Codes go to shared memory first (odd word stride) and leave as
//     contiguous row segments of MS bytes.
// One launch a call for any n; the wrapper allocates the output by shape
// alone, so CUDA graphs capture it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;     // threads of a CTA
constexpr int NW = NT / 32;
constexpr int TILE = 32;    // rows of a tile: one a lane

// Row stride (floats) of the staged tile: odd, so that lane r's reads at
// r * stride + j fall in 32 banks.
__host__ __device__ __forceinline__ int row_stride(int MS, int ds) {
  return (MS * ds) | 1;
}

// Code stride (bytes) of the staged codes: an odd number of words.
__host__ __device__ __forceinline__ int code_stride(int MS) {
  return 4 * (((MS + 3) / 4) | 1);
}

__host__ __device__ __forceinline__ size_t smem_bytes(int MS, int K, int ds) {
  return 4 * ((size_t)MS * K * ds + (size_t)MS * K +
              (size_t)TILE * row_stride(MS, ds)) +
         (size_t)TILE * code_stride(MS);
}

// One centroid's dsub floats from shared memory, in 16- or 8-byte reads
// where dsub allows (a centroid starts at a multiple of dsub floats).
template <int DS>
__device__ __forceinline__ void load_centroid(const float* p, float* c) {
  if constexpr (DS % 4 == 0) {
#pragma unroll
    for (int q = 0; q < DS / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      c[4 * q] = v.x;
      c[4 * q + 1] = v.y;
      c[4 * q + 2] = v.z;
      c[4 * q + 3] = v.w;
    }
  } else if constexpr (DS == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    c[0] = v.x;
    c[1] = v.y;
  } else {
#pragma unroll
    for (int d = 0; d < DS; ++d) c[d] = p[d];
  }
}

// The code of one (row, subquantizer): xs the row's slice, book the
// subquantizer's K centroids, c2 their squared norms (DS 0: dsub ds at run
// time, the slice read from shared memory).
template <int DS>
__device__ __forceinline__ int nearest(const float* xs, const float* book,
                                       const float* c2, int K, int ds) {
  float xv[DS > 0 ? DS : 1];
  float x2 = 0.f;
  if constexpr (DS > 0) {
#pragma unroll
    for (int d = 0; d < DS; ++d) {
      xv[d] = xs[d];
      x2 = fmaf(xv[d], xv[d], x2);
    }
  } else {
    for (int d = 0; d < ds; ++d) x2 = fmaf(xs[d], xs[d], x2);
  }
  float best = __int_as_float(0x7f800000);  // +inf
  int code = 0;
  for (int k = 0; k < K; ++k) {
    float xc = 0.f;
    if constexpr (DS > 0) {
      float c[DS];
      load_centroid<DS>(book + k * DS, c);
#pragma unroll
      for (int d = 0; d < DS; ++d) xc = fmaf(xv[d], c[d], xc);
    } else {
      const float* c = book + (size_t)k * ds;
      for (int d = 0; d < ds; ++d) xc = fmaf(xs[d], c[d], xc);
    }
    const float dist =
        fmaxf(__fadd_rn(__fsub_rn(x2, __fmul_rn(2.f, xc)), c2[k]), 0.f);
    if (dist < best) {
      best = dist;
      code = k;
    }
  }
  return code;
}

template <int DS>
__global__ void __launch_bounds__(NT) pq_encode(
    const float* __restrict__ x, const float* __restrict__ books,
    uint8_t* __restrict__ out, int n, int M, int K, int dsub, int MS) {
  extern __shared__ __align__(16) float smem[];
  const int ds = DS > 0 ? DS : dsub;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * MS, ms = min(MS, M - m0);
  const int cols = ms * ds, rstride = row_stride(MS, ds);
  const int cstride = code_stride(MS);
  const size_t D = (size_t)M * ds;
  float* book = smem;                          // (MS, K, ds)
  float* c2 = book + (size_t)MS * K * ds;      // (MS, K)
  float* rows = c2 + (size_t)MS * K;           // (TILE, rstride)
  uint8_t* codes = reinterpret_cast<uint8_t*>(rows + TILE * rstride);

  const float* gbook = books + (size_t)m0 * K * ds;
  for (int i = tid; i < ms * K * ds; i += NT) book[i] = gbook[i];
  __syncthreads();
  for (int i = tid; i < ms * K; i += NT) {
    const float* c = book + (size_t)i * ds;
    float s = 0.f;
    for (int d = 0; d < ds; ++d) s = fmaf(c[d], c[d], s);
    c2[i] = s;
  }
  // c2 is first read after the first tile's barrier below

  const int tiles = (n + TILE - 1) / TILE;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const size_t r0 = (size_t)t * TILE;
    const int nr = min(TILE, n - t * TILE);
    for (int r = warp; r < nr; r += NW) {
      const float* src = x + (r0 + r) * D + (size_t)m0 * ds;
      for (int j = lane; j < cols; j += 32) rows[r * rstride + j] = src[j];
    }
    __syncthreads();
    if (lane < nr) {
      const float* xr = rows + lane * rstride;
      for (int j = warp; j < ms; j += NW)
        codes[lane * cstride + j] = (uint8_t)nearest<DS>(
            xr + j * ds, book + (size_t)j * K * ds, c2 + j * K, K, ds);
    }
    __syncthreads();
    // the next tile's rows may be staged while these codes are copied out:
    // its codes are written only after its own first barrier
    for (int r = warp; r < nr; r += NW) {
      uint8_t* dst = out + (r0 + r) * M + m0;
      for (int j = lane; j < ms; j += 32) dst[j] = codes[r * cstride + j];
    }
  }
}

using EncodeKernel = void (*)(const float*, const float*, uint8_t*, int, int,
                              int, int, int);

EncodeKernel kernel_for(int dsub) {
  switch (dsub) {
    case 1: return pq_encode<1>;
    case 2: return pq_encode<2>;
    case 4: return pq_encode<4>;
    case 8: return pq_encode<8>;
    default: return pq_encode<0>;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory of one CTA that encodes MS subquantizers of K
// centroids of dsub floats (kernels/pq_scan.py::encode_plan picks MS).
size_t pq_encode_smem_bytes(int MS, int K, int dsub) {
  return smem_bytes(MS, K, dsub);
}

// CTAs of the dsub instantiation with `smem` bytes of shared memory that
// one SM holds at once (the current device); negative on a CUDA error.
int pq_encode_ctas_per_sm(int dsub, size_t smem) {
  const EncodeKernel kern = kernel_for(dsub);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, NT, smem);
  return err == cudaSuccess ? n : -(int)err;
}

// x (n, M * dsub) f32, books (M, K, dsub) f32, out (n, M) u8; K <= 256.
// Grid (grid_x, ceil(M / MS)): a CTA encodes subquantizers [y * MS,
// min(M, (y + 1) * MS)) of the tiles blockIdx.x, blockIdx.x + grid_x, ...
int pq_encode_launch(const void* x, const void* books, void* out, int n,
                     int M, int K, int dsub, int MS, int grid_x,
                     void* stream) {
  if (n < 0 || M < 1 || K < 1 || K > 256 || dsub < 1 || MS < 1 || MS > M ||
      grid_x < 1 || (M + MS - 1) / MS > 65535)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const size_t smem = smem_bytes(MS, K, dsub);
  const EncodeKernel kern = kernel_for(dsub);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(grid_x, (M + MS - 1) / MS), dim3(NT), smem,
         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(books),
      static_cast<uint8_t*>(out), n, M, K, dsub, MS);
  return (int)cudaGetLastError();
}

}  // extern "C"
