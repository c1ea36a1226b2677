// Bitonic network over int32 rows with an int32 payload: the port's
// counterpart of opengpc_tpu/ops/sort.py::bitonic_network.  The rows are
// held in registers, 16 lanes a thread, and re-laid through shared memory
// between runs of stages (bitonic_sort_block); the bitonic row-sort kernel
// (bitonic_sort.cu) and the fused match kernel (fused_match.cu) call it.
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

// Every stage runs ascending on keys XORed with -1 in
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

// The whole network on the block's rows of n = 2^k lanes (256 <= n),
// rows one after another in the block's E * kThreads lanes, held in
// layout A: register r of thread t holds block lane E t + r, keys in k and
// payloads in v.  key and pay are the block's 2 x E * kThreads words of
// shared memory, used for the re-lays and the stages past a warp.  Each
// size runs ascending on keys flipped in its descending lanes (the last
// size, n, flips none), in layout A unless noted: distances >= 32E through
// the block's shared memory and read back as layout B, or A re-laid as B
// through the warp's own shared memory; 32 .. 16E/2 in B's registers; 16
// across lanes l ^ 16; re-laid as A; E/2 .. 1 in A's registers.  Every
// thread of the block calls it; it returns the rows sorted in layout A.
template <int E, int kThreads>
__device__ __forceinline__ void bitonic_sort_block(int32_t (&k)[E],
                                                   int32_t (&v)[E],
                                                   int32_t* key, int32_t* pay,
                                                   int n) {
  constexpr int kElems = E * kThreads;
  constexpr int kSeg = 32 * E;  // a warp's lanes
  const int l = threadIdx.x % 32;
  const int seg = threadIdx.x / 32 * kSeg;
  const int e0 = threadIdx.x * E;
  const int i0 = e0 & (n - 1);  // row lane of register 0 in layout A

  bitonic_thread_sort<E>(k, v, i0);
  for (int size = 2 * E, prev = E; size <= n; prev = size, size <<= 1) {
    bitonic_reflip<E>(k, i0, prev, size);
    int j = size >> 1;
    bool b_layout = false;
    if (j >= kSeg) {  // distances past a warp: the block, in shared memory
      __syncwarp();
      bitonic_store_a<E>(key, pay, e0, k, v);
      __syncthreads();
      for (; j >= kSeg; j >>= 1)
        bitonic_smem_stage(key, pay, kElems, j, threadIdx.x, kThreads);
      bitonic_load_b<E>(key, pay, seg, l, k, v);
      b_layout = true;
    } else if (j >= 32) {  // re-lay the warp's lanes as layout B
      __syncwarp();
      bitonic_store_a<E>(key, pay, e0, k, v);
      __syncwarp();
      bitonic_load_b<E>(key, pay, seg, l, k, v);
      b_layout = true;
    }
    if (b_layout) {
      // distances 32 .. j in registers, 16 across lanes l ^ 16, back to A
      bitonic_thread_stages<E>(k, v, j / 16);
      bitonic_lane_stage<E>(k, v, (l & 16) != 0, 16);
      __syncwarp();
      bitonic_store_b<E>(key, pay, seg, l, k, v);
      __syncwarp();
      bitonic_load_a<E>(key, pay, e0, k, v);
    } else {  // size 32: distance 16 across lanes l ^ 1
      bitonic_lane_stage<E>(k, v, (i0 & 16) != 0, 1);
    }
    bitonic_thread_stages<E>(k, v, size);
  }
}

}  // namespace ogpc
