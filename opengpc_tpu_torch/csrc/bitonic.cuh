// Block-level bitonic network over rows held in shared memory: the port's
// counterpart of opengpc_tpu/ops/sort.py::bitonic_network, which the
// bitonic row-sort kernel and the fused match kernel both call.
//
// The network is the Pallas one, stage for stage: for size = 2, 4, .., n
// and j = size/2, .., 1, lane i meets lane i ^ j; the pair sorts ascending
// when (i & size) == 0 and descending otherwise; keys alone decide, and
// equal keys never swap.  So the result (keys AND payloads) is a fixed
// function of the input, equal to the Pallas kernel's and to the plain
// version's bit for bit, not only a consistent permutation.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ogpc {

// Sort each of `rows` rows of n = 2^log2n int32 keys, at key + r*n, with
// the payload at pay + r*n permuted alongside.  All nthreads threads of the
// block call it; each stage ends with a barrier, so the rows are sorted
// and visible to every thread on return.
__device__ __forceinline__ void bitonic_rows(int32_t* key, int32_t* pay,
                                             int rows, int log2n, int tid,
                                             int nthreads) {
  const int n = 1 << log2n;
  const int half_bits = log2n - 1;
  const int pairs = rows << half_bits;
  for (int size = 2; size <= n; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < pairs; p += nthreads) {
        const int q = p & ((1 << half_bits) - 1);
        // the q-th low lane: q with a 0 inserted at bit log2(j)
        const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
        const int a = ((p >> half_bits) << log2n) + lo;
        const int b = a + j;
        const int32_t ka = key[a], kb = key[b];
        if ((lo & size) == 0 ? kb < ka : kb > ka) {
          key[a] = kb;
          key[b] = ka;
          const int32_t pa = pay[a];
          pay[a] = pay[b];
          pay[b] = pa;
        }
      }
      __syncthreads();
    }
  }
}

}  // namespace ogpc
