// Bitonic row sort: each row of an (R, N) int32 key array sorted ascending
// by key, an int32 payload permuted alongside.
//
// Replaces the TPU kernel opengpc_tpu/ops/sort.py::_kernel (wrapper
// bitonic_sort_rows, network bitonic_network), the sort_impl="bitonic"
// branch of match._match_epipolar_packed.  N is a power of two from 256 to
// 16384.  The network is fixed (bitonic.cuh), so keys and payloads equal
// the Pallas kernel's and the plain version's bit for bit.
//
// Bound on the H100.  Device memory sees 16 bytes an element (key and
// payload, in and out): 13.4 MB for the (410, 2048) matcher rows of a
// 436x1024 pair, 4.0 us at 3.35 TB/s.  The network makes N log2(N)
// (log2(N)+1) / 4 compare-exchanges a row, 27.7 M for those rows, ~5
// integer operations each: ~8 us at the card's INT32 instruction rate.
// So the compare-exchanges bound it, and what costs beyond them is moving
// the data between stages.
//
// Design.  Each thread holds E = 16 lanes of a row in registers, keys and
// payloads, loaded and stored as 16-byte vectors; a block holds max(2048,
// N) lanes (several rows below N = 2048, 128 threads; 256, 512 and 1024
// threads from N = 4096).  Two layouts of a warp's 512 lanes:
//   A  register r of thread t holds lane 16 t + r: distances 1 .. 8 are
//      register pairs, no memory and no barrier;
//   B  register r of warp lane l holds lane 512 w + 32 r + l: distances
//      32 .. 256 are register pairs.
// A size's stages (bitonic.cuh's bitonic_sort_block, which the fused match
// kernel runs too) run: distances >= 512 in shared memory (one barrier a
// stage; N = 16384 keeps its 128 KB in dynamic shared memory), read back
// as layout B, or A re-laid as B through the warp's own shared memory
// (__syncwarp only); 32 .. 256 in B's registers; 16 across lanes
// (__shfl_xor_sync, l ^ 16); re-laid as A; 8 .. 1 in A's registers.  The
// shared-memory words are XOR-swizzled so that both layouts' accesses are
// free of bank conflicts.  Every stage of a size runs ascending on keys
// XORed with -1 in the lanes whose pairs descend (bitonic.cuh), so a
// compare-exchange is a min, a max and two selects.  At N = 2048 that is
// 5 block barriers and 7 shuffle stages of the 66 stages, where the
// shared-memory network has a barrier after every stage.  This layout
// rather than shuffles for every distance from E to 16E: a shuffle stage
// costs two shuffles and ~5 operations an element, a register stage ~2.5
// operations, and a re-lay ~4 shared-memory accesses an element.  On the
// (410, 2048) matcher rows of a 436x1024 pair it takes 22.5 us on an
// H100 (chip_smoke.py, PERF.md), against 80 us for the shared-memory
// network, 8.3 us of bound and 36.8 us for torch.sort.
// Rows are independent, so any row count runs, one wave of blocks after
// another; lanes past the last row sort zeros and are not stored.
// ptxas: 61-63 registers, no spills, at every block size.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMinLog2 = 8;   // N >= 256
constexpr int kMaxLog2 = 14;  // N <= 16384
constexpr int kLanes = 16;    // E: lanes a thread holds

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
bitonic_sort_rows_kernel(const int32_t* __restrict__ key_in,
                         const int32_t* __restrict__ pay_in,
                         int32_t* __restrict__ key_out,
                         int32_t* __restrict__ pay_out, long long total,
                         int log2n) {
  constexpr int E = kLanes;
  constexpr int kElems = E * kThreads;
  extern __shared__ int4 smem4[];  // keys, then payloads
  int32_t* key = reinterpret_cast<int32_t*>(smem4);
  int32_t* pay = key + kElems;
  const int n = 1 << log2n;
  const long long first =
      static_cast<long long>(blockIdx.x) * kElems + threadIdx.x * E;
  const bool live = first < total;  // a thread's lanes share one row

  int32_t k[E], v[E];
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    int4 a = make_int4(0, 0, 0, 0), b = a;
    if (live) {
      a = reinterpret_cast<const int4*>(key_in + first)[q];
      b = reinterpret_cast<const int4*>(pay_in + first)[q];
    }
    k[4 * q] = a.x; k[4 * q + 1] = a.y; k[4 * q + 2] = a.z; k[4 * q + 3] = a.w;
    v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z; v[4 * q + 3] = b.w;
  }

  ogpc::bitonic_sort_block<E, kThreads>(k, v, key, pay, n);

  if (live) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      reinterpret_cast<int4*>(key_out + first)[q] =
          make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
      reinterpret_cast<int4*>(pay_out + first)[q] =
          make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  }
}

template <int kThreads>
int launch(const void* key_in, const void* pay_in, void* key_out,
           void* pay_out, int rows, int log2n, cudaStream_t stream) {
  constexpr int kElems = kLanes * kThreads;
  const long long total = static_cast<long long>(rows) << log2n;
  const long long blocks = (total + kElems - 1) / kElems;
  // the block's keys and payloads: 16 KB, 128 KB at N = 16384
  constexpr int smem = 2 * kElems * static_cast<int>(sizeof(int32_t));
  auto kernel = bitonic_sort_rows_kernel<kThreads>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(key_in), static_cast<const int32_t*>(pay_in),
      static_cast<int32_t*>(key_out), static_cast<int32_t*>(pay_out), total,
      log2n);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Sort the rows of the contiguous (rows, n) int32 key_in into key_out,
// pay_in permuted alongside into pay_out.  n must be a power of two in
// [256, 16384] and every pointer 16-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ogpc_bitonic_sort_rows(const void* key_in, const void* pay_in,
                                      void* key_out, void* pay_out, int rows,
                                      int n, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (rows < 0 || n != (1 << log2n) || log2n < kMinLog2 || log2n > kMaxLog2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(key_in) && aligned16(pay_in) && aligned16(key_out) &&
        aligned16(pay_out)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (rows == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  // a block holds max(2048, N) lanes: 128 .. 1024 threads of 16
  switch (log2n) {
    case 12:
      return launch<256>(key_in, pay_in, key_out, pay_out, rows, log2n, s);
    case 13:
      return launch<512>(key_in, pay_in, key_out, pay_out, rows, log2n, s);
    case 14:
      return launch<1024>(key_in, pay_in, key_out, pay_out, rows, log2n, s);
    default:
      return launch<128>(key_in, pay_in, key_out, pay_out, rows, log2n, s);
  }
}
