// Bitonic row sort: each row of an (R, N) int32 key array sorted ascending
// by key, an int32 payload permuted alongside.
//
// Replaces the TPU kernel opengpc_tpu/ops/sort.py::_kernel (wrapper
// bitonic_sort_rows, network bitonic_network), the sort_impl="bitonic"
// branch of match._match_epipolar_packed.  N is a power of two from 256 to
// 16384.  The network is fixed (bitonic.cuh), so keys and payloads equal
// the Pallas kernel's and the plain version's bit for bit.
//
// Design.  One block per row.  The block loads the row's keys and payloads
// into dynamic shared memory (8N bytes: 16 KB at N = 2048, 128 KB at
// N = 16384, above 48 KB after cudaFuncSetAttribute), runs the
// log2(N)(log2(N)+1)/2 compare-exchange stages there (66 at N = 2048), one
// barrier after each, and writes the row back.  Each thread owns N/2/threads
// compare-exchanges per stage.  Rows are independent, so any row count
// runs, one wave of blocks after another.
//
// Bound on the H100.  Device memory sees 16 bytes per element (key and
// payload, in and out): 13 MB for the (410, 2048) matcher rows of a
// 436x1024 pair, ~4 us at 3.35 TB/s.  The stages cost 2N log2(N)^2 / 2
// shared-memory loads per row and a block-wide barrier each, so shared
// memory and barrier latency bound the kernel, not device memory.  Keeping
// the row resident in shared memory for all stages is what the design does
// about it; warp-shuffle stages for j < 32 and register-held sub-sorts are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinLog2 = 8;   // N >= 256
constexpr int kMaxLog2 = 14;  // N <= 16384

__global__ void __launch_bounds__(kMaxThreads)
bitonic_sort_rows_kernel(const int32_t* __restrict__ key_in,
                         const int32_t* __restrict__ pay_in,
                         int32_t* __restrict__ key_out,
                         int32_t* __restrict__ pay_out, int log2n) {
  extern __shared__ int32_t smem[];
  const int n = 1 << log2n;
  int32_t* key = smem;
  int32_t* pay = smem + n;
  const size_t row = static_cast<size_t>(blockIdx.x) << log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    key[i] = key_in[row + i];
    pay[i] = pay_in[row + i];
  }
  __syncthreads();
  ogpc::bitonic_rows(key, pay, 1, log2n, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    key_out[row + i] = key[i];
    pay_out[row + i] = pay[i];
  }
}

}  // namespace

// Sort the rows of the contiguous (rows, n) int32 key_in into key_out,
// pay_in permuted alongside into pay_out.  n must be a power of two in
// [256, 16384].  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ogpc_bitonic_sort_rows(const void* key_in, const void* pay_in,
                                      void* key_out, void* pay_out, int rows,
                                      int n, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (rows < 0 || n != (1 << log2n) || log2n < kMinLog2 || log2n > kMaxLog2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const int smem = 2 * n * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_sort_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = n / 2 < kMaxThreads ? n / 2 : kMaxThreads;
  bitonic_sort_rows_kernel<<<rows, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(key_in), static_cast<const int32_t*>(pay_in),
      static_cast<int32_t*>(key_out), static_cast<int32_t*>(pay_out), log2n);
  return static_cast<int>(cudaGetLastError());
}
