// Matcher row sort: each row of an (R, N) int32 key image sorted by
// (key, column), written out as int32 keys and int32 columns.
//
// Replaces no TPU kernel.  It stands in for XLA's lax.sort row sort of
// opengpc_tpu/match.py::_sort_key_pos, which the port first ran as
// torch.sort: on the matcher's rows of a 30-test forest a key-value radix
// sort that carries an int64 index through every pass (radixSortKVInPlace
// on 2,048-wide rows, cub's segmented sort on 7,680-wide ones), then casts
// the index to int32.  Callers: match._sort_key_pos (ops.sort.row_sort),
// for rows of at most 16,384 keys.
//
// What a row holds.  A candidate pixel's key is its leaf code, below
// SENTINEL_BASE (match.py); every other pixel's is SENTINEL_BASE + its
// column, so those keys are already in (key, column) order, above every
// code, and never pair.  On the benchmark's scenes about 15 % of a row is
// candidates.  The kernel checks that layout itself: a row holding a key
// >= SENTINEL_BASE other than SENTINEL_BASE + its column is sorted whole,
// so any int32 row comes out in exact (key, column) order.
//
// Bound on the H100.  Device memory sees 12 bytes an element: the key
// read, the key and the column written.  The (2,134, 7,680) interior rows
// of a 4K frame are 197 MB, 59 us at 3.35 TB/s; the (13,120, 2,048) rows
// of 32 Sintel pairs 322 MB, 96 us.  The network on the candidates alone,
// a row padded to P = max(256, pow2 >= its count), makes P log2(P)
// (log2(P) + 1) / 4 compare-exchanges of 64-bit words, ~6 integer
// operations each: ~52 us at 4K (P = 2,048 at 1,150 candidates) and ~54 us
// in Sintel (P = 512 at 300) at the card's INT32 rate.  So the bytes bound
// it, and the design reads each key once, writes each output once, and
// keeps the network on the candidates only.
//
// Design.  One block a row, T = max(128, pow2 >= N / 16) threads, each
// loading 4 vectors of 4 keys (16-byte loads, vector v of thread t is
// keys 4 (v T + t) .., so a warp's loads are contiguous).
//   1. Classify: candidate (key < SENTINEL_BASE), or a key off its
//      column's sentinel; __syncthreads_or tells the block whether the
//      row is sorted whole.  The selected keys (the candidates, or all)
//      get their ranks in column order by one block scan: bytewise in a
//      warp (4 vectors' counts in one word), 16-bit halves across warps.
//   2. Each selected key goes to shared memory at its rank as one 64-bit
//      word, ((key ^ 0x80000000) << 14) | column: unique in the row and
//      ordered as (key, column), so the network needs no payload and its
//      result is the one exact order.  Pads of ~0 fill up to P.
//   3. Bitonic network over the P words.  Warp passes hold 256 words, 8
//      consecutive words a lane (layout A): distances 1-4 in registers,
//      8-128 by __shfl_xor_sync, each lane deciding alone (the words are
//      unique, so both lanes of a pair agree).  A first pass sorts sizes
//      2-256; each larger size runs its distances >= 256 in shared memory
//      (one barrier a distance) and then one warp pass.  Shared words are
//      XOR-swizzled by 16-byte chunk, so layout A's 16-byte accesses are
//      free of bank conflicts.  The last pass writes the keys and columns
//      of ranks [0, n) from registers, 32 bytes a lane.
//   4. The row's other keys take ranks [n, N) in column order: each
//      thread puts its non-candidates' columns at their index among them
//      (column - candidates before it) in the now free shared memory, and
//      the block writes SENTINEL_BASE + column and column coalesced.
// Shared memory is P_max = max(256, pow2 >= N) words, a dense row's: 16
// KB at N = 2,048, 64 KB at 7,680, 128 KB at 16,384.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t kSentinelBase = 0x40000000;  // match.SENTINEL_BASE
constexpr int kColBits = 14;
constexpr int kMaxN = 1 << kColBits;  // columns fit a word's low 14 bits
constexpr int kVec = 4;               // 4-key vectors a thread loads
constexpr int kE = 8;                 // words a lane holds in a warp pass
constexpr int kSeg = 32 * kE;         // a warp pass's words
constexpr uint64_t kPad = ~0ull;      // above every word
constexpr unsigned kFull = 0xffffffffu;

// Shared-memory word of rank u: the 16-byte chunks of each 128-byte row
// XOR-swizzled by the row.  Distances >= 128 leave the swizzle unchanged.
__device__ __forceinline__ int swz(int u) {
  return u ^ (((u >> 4) & 7) << 1);
}

__device__ __forceinline__ uint64_t make_word(int32_t key, int col) {
  return (static_cast<uint64_t>(static_cast<uint32_t>(key) ^ 0x80000000u)
          << kColBits) | static_cast<uint32_t>(col);
}

__device__ __forceinline__ int32_t word_key(uint64_t w) {
  return static_cast<int32_t>(static_cast<uint32_t>(w >> kColBits) ^
                              0x80000000u);
}

__device__ __forceinline__ int32_t word_col(uint64_t w) {
  return static_cast<int32_t>(w & (kMaxN - 1));
}

// One pair of a stage: ascending leaves the smaller word in a.
__device__ __forceinline__ void exchange(uint64_t& a, uint64_t& b, bool asc) {
  const bool s = asc ? (b < a) : (a < b);
  const uint64_t x = a;
  a = s ? b : a;
  b = s ? x : b;
}

// The stages j = kJtop .. 1 of bitonic size `size` on a lane's words,
// w[r] the row's word i0 + r (i0 a multiple of kE).  A pair ascends when
// (i & size) == 0.  j >= kE pairs lane l with lane l ^ (j / kE), the
// lower element keeping the smaller word of an ascending pair; j < kE
// pairs registers.
template <int kJtop>
__device__ __forceinline__ void warp_stages(uint64_t (&w)[kE], int i0,
                                            int size) {
  const bool asc = (i0 & size) == 0;  // every lane's words share it here
#pragma unroll
  for (int j = kJtop; j >= kE; j >>= 1) {
    const bool keep_min = ((i0 & j) == 0) == asc;
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const uint64_t o = __shfl_xor_sync(kFull, w[r], j / kE);
      w[r] = keep_min == (o < w[r]) ? o : w[r];
    }
  }
#pragma unroll
  for (int j = kE / 2; j > 0; j >>= 1) {
    if (j > kJtop) continue;
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      if (r & j) continue;
      exchange(w[r], w[r + j], ((i0 + r) & size) == 0);
    }
  }
}

// Sizes 2 .. kSize of the network on a lane's words.
template <int kSize>
__device__ __forceinline__ void warp_sort(uint64_t (&w)[kE], int i0) {
  if constexpr (kSize > 2) warp_sort<kSize / 2>(w, i0);
  warp_stages<kSize / 2>(w, i0, kSize);
}

__device__ __forceinline__ void load_a(const uint64_t* buf, int i0,
                                       uint64_t (&w)[kE]) {
#pragma unroll
  for (int q = 0; q < kE / 2; ++q) {
    const ulonglong2 v =
        *reinterpret_cast<const ulonglong2*>(buf + swz(i0 + 2 * q));
    w[2 * q] = v.x;
    w[2 * q + 1] = v.y;
  }
}

__device__ __forceinline__ void store_a(uint64_t* buf, int i0,
                                        const uint64_t (&w)[kE]) {
#pragma unroll
  for (int q = 0; q < kE / 2; ++q)
    *reinterpret_cast<ulonglong2*>(buf + swz(i0 + 2 * q)) =
        make_ulonglong2(w[2 * q], w[2 * q + 1]);
}

// Ranks i0 .. i0 + 7 of the sorted words, those below n, to the row's
// keys and columns.
__device__ __forceinline__ void write_sorted(const uint64_t (&w)[kE], int i0,
                                             int n, int32_t* key_row,
                                             int32_t* pos_row, bool vec) {
#pragma unroll
  for (int q = 0; q < kE / 4; ++q) {
    const int i = i0 + 4 * q;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<int4*>(key_row + i) =
          make_int4(word_key(w[4 * q]), word_key(w[4 * q + 1]),
                    word_key(w[4 * q + 2]), word_key(w[4 * q + 3]));
      *reinterpret_cast<int4*>(pos_row + i) =
          make_int4(word_col(w[4 * q]), word_col(w[4 * q + 1]),
                    word_col(w[4 * q + 2]), word_col(w[4 * q + 3]));
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (i + p < n) {
          key_row[i + p] = word_key(w[4 * q + p]);
          pos_row[i + p] = word_col(w[4 * q + p]);
        }
      }
    }
  }
}

// Inclusive scan of v over a warp's lanes.
__device__ __forceinline__ uint32_t warp_scan(uint32_t v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t up = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += up;
  }
  return v;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
row_sort_kernel(const int32_t* __restrict__ key_in,
                int32_t* __restrict__ key_out, int32_t* __restrict__ pos_out,
                int n_cols, bool vec) {
  constexpr int kWarps = kThreads / 32;
  extern __shared__ ulonglong2 smem2[];
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem2);
  __shared__ uint32_t warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * n_cols;
  const int32_t* in = key_in + row;
  int32_t* key_row = key_out + row;
  int32_t* pos_row = pos_out + row;

  // 1. load and classify: bit 4 v + p of a mask is key p of vector v
  int32_t k[kVec][4];
  uint32_t valid = 0, cand = 0;
  bool odd = false;  // a key >= SENTINEL_BASE off its column's sentinel
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int e = 4 * (v * kThreads + tid);
    if (vec && e < n_cols) {
      const int4 x = *reinterpret_cast<const int4*>(in + e);
      k[v][0] = x.x; k[v][1] = x.y; k[v][2] = x.z; k[v][3] = x.w;
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) k[v][p] = e + p < n_cols ? in[e + p] : 0;
    }
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (e + p >= n_cols) continue;
      valid |= 1u << (4 * v + p);
      if (k[v][p] < kSentinelBase)
        cand |= 1u << (4 * v + p);
      else
        odd |= k[v][p] != kSentinelBase + e + p;
    }
  }
  const bool whole = __syncthreads_or(odd);
  const uint32_t sel = whole ? valid : cand;

  // ranks in column order: byte v of cnt counts vector v's selected keys
  // (<= 128 over a warp), 16-bit halves the warps' sums (<= 16,384)
  uint32_t cnt = 0;
#pragma unroll
  for (int v = 0; v < kVec; ++v)
    cnt |= static_cast<uint32_t>(__popc((sel >> (4 * v)) & 15u)) << (8 * v);
  const uint32_t incl = warp_scan(cnt, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  const uint32_t ws = lane < kWarps ? warp_sums[lane] : 0u;
  const uint32_t h01 = warp_scan((ws & 0xffu) | ((ws >> 8) & 0xffu) << 16,
                                 lane);
  const uint32_t h23 = warp_scan(((ws >> 16) & 0xffu) | (ws >> 24) << 16,
                                 lane);
  const uint32_t t01 = __shfl_sync(kFull, h01, 31);
  const uint32_t t23 = __shfl_sync(kFull, h23, 31);
  uint32_t e01 = __shfl_sync(kFull, h01, warp > 0 ? warp - 1 : 0);
  uint32_t e23 = __shfl_sync(kFull, h23, warp > 0 ? warp - 1 : 0);
  if (warp == 0) e01 = e23 = 0;
  const int tot[kVec] = {static_cast<int>(t01 & 0xffffu),
                         static_cast<int>(t01 >> 16),
                         static_cast<int>(t23 & 0xffffu),
                         static_cast<int>(t23 >> 16)};
  const int before[kVec] = {static_cast<int>(e01 & 0xffffu),
                            static_cast<int>(e01 >> 16),
                            static_cast<int>(e23 & 0xffffu),
                            static_cast<int>(e23 >> 16)};
  const int n = tot[0] + tot[1] + tot[2] + tot[3];  // selected keys
  int rank[kVec];  // selected keys before vector v
#pragma unroll
  for (int v = 0, base = 0; v < kVec; base += tot[v], ++v)
    rank[v] = base + before[v] + static_cast<int>(((incl - cnt) >> (8 * v)) &
                                                  0xffu);

  // 2. the selected keys to shared memory at their ranks, pads up to P
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int e = 4 * (v * kThreads + tid);
    int r = rank[v];
#pragma unroll
    for (int p = 0; p < 4; ++p)
      if (sel >> (4 * v + p) & 1u) buf[swz(r++)] = make_word(k[v][p], e + p);
  }
  const int P = n <= kSeg ? kSeg : 1 << (32 - __clz(n - 1));
  if (n > 0)
    for (int u = n + tid; u < P; u += kThreads) buf[swz(u)] = kPad;
  __syncthreads();

  // 3. the network; its last pass writes ranks [0, n)
  if (n > 0) {
    for (int seg = warp; seg < P / kSeg; seg += kWarps) {
      const int i0 = seg * kSeg + lane * kE;
      uint64_t w[kE];
      load_a(buf, i0, w);
      warp_sort<kSeg>(w, i0);
      if (P == kSeg)
        write_sorted(w, i0, n, key_row, pos_row, vec);
      else
        store_a(buf, i0, w);
    }
    for (int size = 2 * kSeg; size <= P; size <<= 1) {
      __syncthreads();
      for (int j = size / 2; j >= kSeg; j >>= 1) {
        for (int q = tid; q < P / 2; q += kThreads) {
          const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const int a = swz(lo), b = a + j;
          uint64_t x = buf[a], y = buf[b];
          const uint64_t x0 = x;
          exchange(x, y, (lo & size) == 0);
          if (x != x0) {
            buf[a] = x;
            buf[b] = y;
          }
        }
        __syncthreads();
      }
      for (int seg = warp; seg < P / kSeg; seg += kWarps) {
        const int i0 = seg * kSeg + lane * kE;
        uint64_t w[kE];
        load_a(buf, i0, w);
        warp_stages<kSeg / 2>(w, i0, size);
        if (size == P)
          write_sorted(w, i0, n, key_row, pos_row, vec);
        else
          store_a(buf, i0, w);
      }
    }
  }

  // 4. the other keys, sentinels in column order, to ranks [n, N)
  if (n < n_cols) {  // implies !whole
    __syncthreads();  // the network's reads of buf are done
    int32_t* cols = reinterpret_cast<int32_t*>(buf);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const int e = 4 * (v * kThreads + tid);
      int r = rank[v];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const uint32_t bit = 1u << (4 * v + p);
        if (sel & bit)
          ++r;
        else if (valid & bit)
          cols[e + p - r] = e + p;
      }
    }
    __syncthreads();
    for (int u = tid; u < n_cols - n; u += kThreads) {
      const int c = cols[u];
      key_row[n + u] = kSentinelBase + c;
      pos_row[n + u] = c;
    }
  }
}

template <int kThreads>
int launch(const void* key_in, void* key_out, void* pos_out, int rows,
           int n, bool vec, cudaStream_t stream) {
  int words = kSeg;
  while (words < n) words <<= 1;
  const int smem = words * static_cast<int>(sizeof(uint64_t));
  auto kernel = row_sort_kernel<kThreads>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      static_cast<const int32_t*>(key_in), static_cast<int32_t*>(key_out),
      static_cast<int32_t*>(pos_out), n, vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Sort each row of the contiguous (rows, n) int32 key_in by (key, column)
// into key_out (keys) and pos_out (columns), both contiguous (rows, n).
// 1 <= n <= 16384.  Rows of n % 4 == 0 with 16-byte aligned pointers take
// 16-byte loads and stores.  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int ogpc_row_sort(const void* key_in, void* key_out, void* pos_out,
                             int rows, int n, void* stream) {
  if (rows < 0 || n < 1 || n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  const bool vec = n % 4 == 0 && aligned16(key_in) && aligned16(key_out) &&
                   aligned16(pos_out);
  const auto s = static_cast<cudaStream_t>(stream);
  // 16 keys a thread: 128 threads up to N = 2,048, then 256, 512, 1,024
  if (n <= 2048) return launch<128>(key_in, key_out, pos_out, rows, n, vec, s);
  if (n <= 4096) return launch<256>(key_in, key_out, pos_out, rows, n, vec, s);
  if (n <= 8192) return launch<512>(key_in, key_out, pos_out, rows, n, vec, s);
  return launch<1024>(key_in, key_out, pos_out, rows, n, vec, s);
}
