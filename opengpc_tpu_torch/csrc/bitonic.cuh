// Bitonic networks over int32 rows with an int32 payload: the port's
// counterpart of opengpc_tpu/ops/sort.py::bitonic_network.  Two forms of
// one network:
//   bitonic_rows            rows held in shared memory, one barrier a stage;
//                           the fused match kernel (fused_match.cu) calls it;
//   bitonic_thread_sort .. rows held in registers, re-laid through shared
//   bitonic_smem_stage      memory between runs of stages; the bitonic
//                           row-sort kernel (bitonic_sort.cu) calls them.
//
// The network is the Pallas one, stage for stage: for size = 2, 4, .., n
// and j = size/2, .., 1, lane i meets lane i ^ j; the pair sorts ascending
// when (i & size) == 0 and descending otherwise; keys alone decide, and
// equal keys never swap.  So the result (keys AND payloads) is a fixed
// function of the input, equal to the Pallas kernel's and to the plain
// version's bit for bit, not only a consistent permutation.  Where the two
// lanes of a pair sit in two threads, both threads decide with the same
// roles (see bitonic_lane_stage), so a tie swaps on neither side.

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

// The register form runs every stage ascending on keys XORed with -1 in
// the lanes whose pair descends: ~x reverses the order of int32 exactly,
// so "swap iff kb < ka" on the flipped keys is the network's "swap iff
// kb > ka" on the keys, ties included.  A lane's flip for one size is
// -((lane >> log2(size)) & 1); both lanes of a pair share it.

// XOR every key with the flip of its thread's lanes for size `from` and
// for size `to` (0 for none): the switch from one size's flips to the
// next's, for sizes of at least E, where all E lanes of a thread share
// their flip.
template <int E>
__device__ __forceinline__ void bitonic_reflip(int32_t (&k)[E], int i0,
                                               int from, int to) {
  const int32_t m = -(((i0 & from) != 0) ^ ((i0 & to) != 0));
#pragma unroll
  for (int r = 0; r < E; ++r) k[r] ^= m;
}

// The stages j < min(E, size) of one size, ascending on flipped keys, on
// the E consecutive lanes that one thread holds in k (keys) and v
// (payloads).
template <int E>
__device__ __forceinline__ void bitonic_thread_stages(int32_t (&k)[E],
                                                      int32_t (&v)[E],
                                                      int size) {
#pragma unroll
  for (int j = E / 2; j > 0; j >>= 1) {
    if (j < size) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & j) continue;
        const int32_t ka = k[r], kb = k[r + j], pa = v[r], pb = v[r + j];
        const bool s = kb < ka;
        k[r] = min(ka, kb);
        k[r + j] = max(ka, kb);
        v[r] = s ? pb : pa;
        v[r + j] = s ? pa : pb;
      }
    }
  }
}

// Sizes 2 .. E, all inside a thread, on the lanes i0 .. i0 + E - 1: the
// flips of sizes below E follow the register index, those of size E the
// thread.  Ends with the keys flipped for size E.
template <int E>
__device__ __forceinline__ void bitonic_thread_sort(int32_t (&k)[E],
                                                    int32_t (&v)[E], int i0) {
#pragma unroll
  for (int size = 2; size <= E; size <<= 1) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const bool was = size > 2 && (r & (size >> 1)) != 0;
      const bool now = size < E ? (r & size) != 0 : (i0 & E) != 0;
      k[r] ^= -static_cast<int32_t>(was != now);
    }
    bitonic_thread_stages<E>(k, v, size);
  }
}

// One stage whose pairs sit in two lanes of a warp, lane l with lane
// l ^ m, register r with register r, ascending on flipped keys.  Both
// threads decide alone, with the same roles: the lower lane (upper ==
// false) keeps the smaller key, the upper the larger, and equal keys stay.
// All 32 lanes of the warp call it.
template <int E>
__device__ __forceinline__ void bitonic_lane_stage(int32_t (&k)[E],
                                                   int32_t (&v)[E],
                                                   bool upper, int m) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int32_t ko = __shfl_xor_sync(0xffffffffu, k[r], m);
    const int32_t vo = __shfl_xor_sync(0xffffffffu, v[r], m);
    const int32_t kn = upper ? max(k[r], ko) : min(k[r], ko);
    v[r] = kn != k[r] ? vo : v[r];
    k[r] = kn;
  }
}

// Shared-memory word of block lane u: the 16-byte chunks of each 32-word
// row XOR-swizzled by the row, so that a warp's 16-byte stores of
// consecutive lanes (layout A) and its scalar loads of lanes 32 apart
// (layout B) are both free of bank conflicts.
__device__ __forceinline__ int bitonic_swz(int u) {
  return u ^ (((u >> 5) & 7) << 2);
}

// Layout A <-> shared memory: the thread's E consecutive lanes e0 ..
template <int E>
__device__ __forceinline__ void bitonic_store_a(int32_t* key, int32_t* pay,
                                                int e0, const int32_t (&k)[E],
                                                const int32_t (&v)[E]) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int a = bitonic_swz(e0 + 4 * q);
    *reinterpret_cast<int4*>(key + a) =
        make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
    *reinterpret_cast<int4*>(pay + a) =
        make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
}

template <int E>
__device__ __forceinline__ void bitonic_load_a(const int32_t* key,
                                               const int32_t* pay, int e0,
                                               int32_t (&k)[E],
                                               int32_t (&v)[E]) {
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int a = bitonic_swz(e0 + 4 * q);
    const int4 x = *reinterpret_cast<const int4*>(key + a);
    const int4 y = *reinterpret_cast<const int4*>(pay + a);
    k[4 * q] = x.x; k[4 * q + 1] = x.y; k[4 * q + 2] = x.z; k[4 * q + 3] = x.w;
    v[4 * q] = y.x; v[4 * q + 1] = y.y; v[4 * q + 2] = y.z; v[4 * q + 3] = y.w;
  }
}

// Layout B <-> shared memory: register r of warp lane l holds lane
// seg + 32 r + l of the warp's segment of 32E lanes.
template <int E>
__device__ __forceinline__ void bitonic_store_b(int32_t* key, int32_t* pay,
                                                int seg, int l,
                                                const int32_t (&k)[E],
                                                const int32_t (&v)[E]) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int a = bitonic_swz(seg + 32 * r + l);
    key[a] = k[r];
    pay[a] = v[r];
  }
}

template <int E>
__device__ __forceinline__ void bitonic_load_b(const int32_t* key,
                                               const int32_t* pay, int seg,
                                               int l, int32_t (&k)[E],
                                               int32_t (&v)[E]) {
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int a = bitonic_swz(seg + 32 * r + l);
    k[r] = key[a];
    v[r] = pay[a];
  }
}

// One stage j >= 32E, ascending on flipped keys, on the block's elems
// lanes in shared memory (whole rows, one after another, at
// bitonic_swz), ending with a barrier.
__device__ __forceinline__ void bitonic_smem_stage(int32_t* key, int32_t* pay,
                                                   int elems, int j, int tid,
                                                   int nthreads) {
  for (int q = tid; q < elems / 2; q += nthreads) {
    const int lo = bitonic_swz(((q & ~(j - 1)) << 1) | (q & (j - 1)));
    const int hi = lo + j;  // j >= 256 leaves the swizzle's row bits
    const int32_t ka = key[lo], kb = key[hi];
    if (kb < ka) {
      key[lo] = kb;
      key[hi] = ka;
      const int32_t pa = pay[lo];
      pay[lo] = pay[hi];
      pay[hi] = pa;
    }
  }
  __syncthreads();
}

}  // namespace ogpc
