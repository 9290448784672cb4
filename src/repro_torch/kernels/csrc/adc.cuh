// ADC distance of one code row: the summation rule shared by K1
// (pq_scan.cu) and K3 (pq_scan_topk.cu).
//
// Both kernels sum lut[m][code_m] over ascending m in f32, one add at a
// time, and so does the plain PyTorch version (kernels/ref.py).  Keeping
// the one definition here is what makes the two kernels, and each kernel
// and its plain version, agree bitwise.
#pragma once

#include <cstdint>

// Add the table entries of code byte `c` of a row.  Packed: the lo nibble
// is subquantizer 2c, the hi nibble 2c + 1.
template <bool PACKED>
__device__ __forceinline__ float add_byte(float acc, const float* ql, int K,
                                          uint32_t byte, int c) {
  if (PACKED) {
    acc = acc + ql[(2 * c) * K + (byte & 15u)];
    acc = acc + ql[(2 * c + 1) * K + (byte >> 4)];
  } else {
    acc = acc + ql[c * K + byte];
  }
  return acc;
}

// sum_m ql[m][code_m] over the MB code bytes of `row`; `vec16` reads the
// row with 16-byte loads (MB % 16 == 0 and a 16-byte aligned row).
template <bool PACKED>
__device__ __forceinline__ float score_row(const uint8_t* __restrict__ row,
                                           const float* ql, int K, int MB,
                                           bool vec16) {
  float acc = 0.f;
  if (vec16) {
    for (int c = 0; c < MB; c += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + c);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 16; ++j)
        acc = add_byte<PACKED>(acc, ql, K, (w[j >> 2] >> (8 * (j & 3))) & 255u,
                               c + j);
    }
  } else {
    for (int c = 0; c < MB; ++c) acc = add_byte<PACKED>(acc, ql, K, row[c], c);
  }
  return acc;
}
