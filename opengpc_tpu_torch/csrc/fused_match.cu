// Fused epipolar match kernel: codes, candidates, sentinel keys, a per-row
// bitonic sort and unique-pair detection in one pass, from the two raw
// uint8 images to per-row (keep, src_x, d).
//
// Replaces the TPU kernel opengpc_tpu/ops/fused_match.py::_kernel (wrapper
// fused_sparsematch_rows), the fused_match=True branch of
// infer._sparsematch_impl.  For output row y:
//   key[x]     = cand ? code : 0x40000000 + x         (left,  x in [0, W))
//   key[W+x]   = cand ? code : 0x40000000 + W + x     (right)
//   key[lane]  = 0x7F000000 + lane                    (pad,   lane >= 2W)
// over N2 = max(256, pow2 >= 2W) lanes with pos = lane as payload; the row
// is sorted by key alone (the fixed bitonic network), and lane i keeps when
// keys i and i+1 form a run of exactly two, one from each image, with
// |d| <= disp_high: src_x = lo, d = lo - (hi - W) for the lo/hi of the two
// positions.  keep, src_x and d are (H, N2); the last lane never keeps.
//
// Bound on the H100.  Device memory sees the two images once and 9 bytes a
// lane written (2HW + 9 H N2: 8.9 MB at 436x1024, 2.7 us at 3.35 TB/s).
// The operations are the key kernel's code math (chip_smoke.py's
// code_ops), the network's compare-exchanges (network_ops, 5 each) and ~10
// a lane for detection: 13.0 us at the card's INT32 rate on the dense
// 436x1024 pair with the zero forest.  So integer instructions bound it.
//
// Design.  A block sorts kRows whole rows, 16 lanes a thread (kThreads =
// kRows N2 / 16), and kCluster such blocks, a thread block cluster, share
// a band of kCluster x kRows output rows.  At N2 = 2048 (W 513..1024)
// that is 2 rows a block of 256 threads and clusters of 4, bands of 8
// rows; the table in ogpc_fused_sparsematch_rows gives the other row
// lengths.
//   Keys.  The band's (image, column tile) units are dealt round its
//     blocks.  A block stages each of its units through tile_codes.cuh's
//     StripTile<band rows, kTileW> (kTileW = N2 / 4 up to 512 columns),
//     the key kernel's tile math, so the box halo of 26 rows is paid once
//     per band of 8 rows (4.25 rows blurred a row emitted, not 14 at 2
//     rows a block): strips of 4 pixels, the Sobel first, the tests (two
//     16-bit lanes a word) only for strips with a candidate, and each
//     strip's 4 keys as one 16-byte store (scalar where the right image's
//     columns do not align) into the shared memory of the block that
//     sorts its row: for 3 rows in 4 another block's, through the
//     cluster's distributed shared memory.  Two cluster barriers frame
//     it.  The tile shares its shared memory with the sort's payload
//     words, which are free until the keys are in.
//   Sort.  Each thread loads its 16 lanes of the rows (layout A; pad keys
//     and positions made in registers) and runs bitonic.cuh's
//     bitonic_sort_block, the row-sort kernel's register network: distances
//     1-8 and 32-256 in registers, 16 a warp shuffle, >= 512 through the
//     block's shared memory, re-lays through the warp's own words.
//   Detection.  On the sorted registers: lane i needs keys i-1 .. i+2 and
//     positions i, i+1.  The thread's own registers hold most; the
//     neighbouring threads' first two and last keys come by __shfl_sync,
//     and across a warp boundary through shared memory.  Runs may cross
//     16- and 512-lane boundaries; a row's first lane has no left
//     neighbour and its last never keeps.  keep, src_x and d leave as
//     16-byte stores: a thread's 16 lanes are 16 bytes of keep and 64 of
//     src_x and of d.
// At 436x1024 that is 55 clusters of 4 blocks of 256 threads, two blocks
// an SM, one wave, in 40.9 us on an H100 (3.1x the bound; the register
// sort alone takes 22.7 us on the same padded rows); at 1080x1920 (N2 =
// 4096: 2 rows a block of 512 threads, clusters of 2) 211 us against 72
// us of bound (chip_smoke.py's kernel_times; PERF.md, which also lists
// the block layouts measured against these).  ptxas: 92 registers at 256
// threads and fewer, no spills; 64 registers and 32 bytes of stack at 512
// and 1024 threads.  The kernel allocates nothing and runs on the
// caller's stream.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "tile_codes.cuh"

namespace {

namespace cg = cooperative_groups;
using ogpc::StripTests;

constexpr int kLanes = 16;  // E: lanes a thread holds
constexpr int32_t kPadKeyBase = 0x7F000000;
constexpr int kMinLog2 = 8;   // N2 >= 256
constexpr int kMaxLog2 = 14;  // N2 <= 16384

// The column tile of a block of kThreads threads and kRows rows of
// N2 = 16 kThreads / kRows lanes: N2 / 4 columns, at most 512, so that a
// tile's strips of kRows rows are one a thread.
constexpr int tile_width(int threads, int rows) {
  return 4 * threads / rows < 512 ? 4 * threads / rows : 512;
}

// A band of kCluster x kRows output rows: kCluster blocks (a thread block
// cluster when kCluster > 1), each sorting kRows rows of kThreads x 16
// lanes, share the band's tiles.
template <int kThreads, int kRows, int kCluster>
struct Band {
  static constexpr int kElems = kLanes * kThreads;  // kRows rows of N2
  static constexpr int kBand = kRows * kCluster;
  static constexpr int kTileW = tile_width(kThreads, kRows);
  using Tile = ogpc::StripTile<kBand, kTileW>;
  // dynamic shared memory: the keys, then the payloads or the tile
  static constexpr int kKeyBytes = kElems * static_cast<int>(sizeof(int32_t));
  static constexpr int kSmem =
      kKeyBytes + (kKeyBytes > static_cast<int>(sizeof(Tile))
                       ? kKeyBytes : static_cast<int>(sizeof(Tile)));
};

template <int kThreads, int kRows, int kCluster>
__global__ void __launch_bounds__(kThreads, kThreads <= 512 ? 2 : 1)
fused_match_kernel(const uint8_t* __restrict__ left,
                   const uint8_t* __restrict__ right,
                   uint8_t* __restrict__ keep_out,
                   int32_t* __restrict__ srcx_out,
                   int32_t* __restrict__ d_out, int h, int w, int log2n,
                   bool vec_in, const __grid_constant__ StripTests tests,
                   int thr2, int disp_high) {
  constexpr int E = kLanes;
  using B = Band<kThreads, kRows, kCluster>;
  constexpr int kBand = B::kBand;
  constexpr int kTileW = B::kTileW;
  constexpr int kStrips = kTileW / 4;  // strips a tile row
  constexpr int kWarps = kThreads / 32;
  extern __shared__ int4 smem4[];
  int32_t* key = reinterpret_cast<int32_t*>(smem4);  // [kRows][N2], swizzled
  int32_t* pay = key + B::kElems;
  auto& tile = *reinterpret_cast<typename B::Tile*>(pay);
  __shared__ int32_t edge[kWarps][4];  // a warp's k[0], k[1], v[0], k[E-1]
  const int n = 1 << log2n;
  const int tid = threadIdx.x;
  int rank = 0;  // the block's place in its band
  if constexpr (kCluster > 1) {
    rank = static_cast<int>(cg::this_cluster().block_rank());
    cg::this_cluster().sync();  // every block of the band runs
  }
  const int band0 = blockIdx.x / kCluster * kBand;  // the band's first row
  const int y0 = band0 + rank * kRows;              // the block's first row

  // the band's keys: unit (image, column tile) by unit, the units dealt
  // round the band's blocks; a key goes to the block that sorts its row
  const int tiles = (w + kTileW - 1) / kTileW;
  for (int unit = rank; unit < 2 * tiles; unit += kCluster) {
    const int side = unit / tiles, x0 = unit % tiles * kTileW;
    tile.stage(side ? right : left, h, w, band0, x0, vec_in, tid, kThreads);
    for (int s = tid; s < kBand * kStrips; s += kThreads) {
      const int ty = s / kStrips, sx = s % kStrips;
      const int x = x0 + 4 * sx;
      if (x >= w) continue;
      const unsigned cand = tile.cands(ty, sx, band0 + ty, x, h, w, thr2);
      uint32_t code[4] = {0, 0, 0, 0};
      if (cand) tile.codes(tile.base(ty, sx), tests, code);
      const int lane = side * w + x;
      int32_t kk[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        kk[p] = (cand >> p & 1) ? static_cast<int32_t>(code[p])
                                : ogpc::kSentinelBase + lane + p;
      int32_t* dst = key;
      if constexpr (kCluster > 1)
        dst = cg::this_cluster().map_shared_rank(key, ty / kRows);
      const int u = ((ty % kRows) << log2n) + lane;
      if ((lane & 3) == 0 && x + 4 <= w) {
        *reinterpret_cast<int4*>(dst + ogpc::bitonic_swz(u)) =
            make_int4(kk[0], kk[1], kk[2], kk[3]);
      } else {
#pragma unroll
        for (int p = 0; p < 4; ++p)
          if (x + p < w) dst[ogpc::bitonic_swz(u + p)] = kk[p];
      }
    }
    __syncthreads();  // the next stage() overwrites the tile
  }
  if constexpr (kCluster > 1) cg::this_cluster().sync();  // keys all in

  // layout A: register r of thread t holds block lane 16 t + r
  const int e0 = tid * E;
  const int i0 = e0 & (n - 1);
  int32_t k[E], v[E];
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const int4 a =
        *reinterpret_cast<const int4*>(key + ogpc::bitonic_swz(e0 + 4 * q));
    k[4 * q] = a.x; k[4 * q + 1] = a.y; k[4 * q + 2] = a.z; k[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    v[r] = i0 + r;
    if (i0 + r >= 2 * w) k[r] = kPadKeyBase + i0 + r;
  }

  ogpc::bitonic_sort_block<E, kThreads>(k, v, key, pay, n);

  // neighbours: key i0-1 from the thread before, keys i0+16, i0+17 and
  // position i0+16 from the thread after; across warps through `edge`
  const int l = tid % 32, wp = tid / 32;
  int32_t kprev = __shfl_up_sync(0xffffffffu, k[E - 1], 1);
  int32_t knext0 = __shfl_down_sync(0xffffffffu, k[0], 1);
  int32_t knext1 = __shfl_down_sync(0xffffffffu, k[1], 1);
  int32_t vnext0 = __shfl_down_sync(0xffffffffu, v[0], 1);
  if (l == 0) {
    edge[wp][0] = k[0];
    edge[wp][1] = k[1];
    edge[wp][2] = v[0];
  }
  if (l == 31) edge[wp][3] = k[E - 1];
  __syncthreads();
  if (l == 31 && wp + 1 < kWarps) {
    knext0 = edge[wp + 1][0];
    knext1 = edge[wp + 1][1];
    vnext0 = edge[wp + 1][2];
  }
  if (l == 0 && wp > 0) kprev = edge[wp - 1][3];

  const int y = y0 + (e0 >> log2n);
  if (y >= h) return;
  const bool row_first = i0 == 0, row_last = i0 + E == n;
  // eq[r + 1] = (key i0+r == key i0+r+1), r = -1 .. E
  bool eq[E + 2];
  eq[0] = !row_first && kprev == k[0];
#pragma unroll
  for (int r = 0; r < E - 1; ++r) eq[r + 1] = k[r] == k[r + 1];
  eq[E] = !row_last && k[E - 1] == knext0;
  eq[E + 1] = !row_last && knext0 == knext1;
  uint32_t kb[E / 4] = {};
  int32_t sx[E], dd[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int32_t a = v[r], b = r + 1 < E ? v[r + 1] : vnext0;
    const int32_t lo = min(a, b), hi = max(a, b);
    const int32_t d = lo - (hi - w);
    const bool keep = eq[r + 1] && !eq[r] && !eq[r + 2] && lo < w &&
                      hi >= w && hi < 2 * w && d >= -disp_high &&
                      d <= disp_high;
    kb[r / 4] |= static_cast<uint32_t>(keep) << (8 * (r % 4));
    sx[r] = keep ? lo : 0;
    dd[r] = keep ? d : 0;
  }
  const size_t o = (static_cast<size_t>(y) << log2n) + i0;
  *reinterpret_cast<uint4*>(keep_out + o) =
      make_uint4(kb[0], kb[1], kb[2], kb[3]);
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    reinterpret_cast<int4*>(srcx_out + o)[q] =
        make_int4(sx[4 * q], sx[4 * q + 1], sx[4 * q + 2], sx[4 * q + 3]);
    reinterpret_cast<int4*>(d_out + o)[q] =
        make_int4(dd[4 * q], dd[4 * q + 1], dd[4 * q + 2], dd[4 * q + 3]);
  }
}

struct Args {
  const uint8_t* left;
  const uint8_t* right;
  uint8_t* keep;
  int32_t* srcx;
  int32_t* d;
  int h, w, log2n;
  bool vec_in;
  ogpc::Tests tests;
  int thr2, disp_high;
};

template <int kThreads, int kRows, int kCluster>
int launch(const Args& a, cudaStream_t stream) {
  using B = Band<kThreads, kRows, kCluster>;
  static_assert(B::kSmem <= 227 * 1024, "shared memory of a block");
  if ((kRows << a.log2n) != B::kElems)  // the rows fill the block
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fused_match_kernel<kThreads, kRows, kCluster>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.h + B::kBand - 1) / B::kBand * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = B::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a.left, a.right, a.keep, a.srcx,
                           a.d, a.h, a.w, a.log2n, a.vec_in,
                           B::Tile::strip_tests(a.tests), a.thr2,
                           a.disp_high);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// (keep, src_x, d), each a contiguous (h, n2) array (uint8, int32, int32),
// for the contiguous (h, w) uint8 images left and right.  n2 must be
// max(256, pow2 >= 2w) and at most 16384; tests: host array of
// n_tests * (iy, ix, jy, jx, tau), at most 30 tests.  Output pointers
// 16-byte aligned.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ogpc_fused_sparsematch_rows(
    const void* left, const void* right, void* keep, void* srcx, void* d,
    int h, int w, int n2, const void* tests, int n_tests, int thr2,
    int disp_high, void* stream) {
  ogpc::Tests t;
  int log2n = 0;
  while ((1 << log2n) < n2) ++log2n;
  if (!ogpc::load_tests(tests, n_tests, &t) || n_tests > 30 || h < 0 ||
      w < 1 || disp_high < 0 || n2 != (1 << log2n) || log2n < kMinLog2 ||
      log2n > kMaxLog2 || n2 < 2 * w || (n2 > 256 && n2 / 2 >= 2 * w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!(aligned16(keep) && aligned16(srcx) && aligned16(d)))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (h == 0) return 0;
  const Args a{static_cast<const uint8_t*>(left),
               static_cast<const uint8_t*>(right),
               static_cast<uint8_t*>(keep), static_cast<int32_t*>(srcx),
               static_cast<int32_t*>(d), h, w, log2n,
               w % 16 == 0 && aligned16(left) && aligned16(right),
               t, thr2, disp_high};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // log2 n2 -> <threads, block rows, cluster>; at n2 = 2048 and 4096 the
  // fastest of the layouts measured (PERF.md)
  switch (log2n) {
    case 8: return launch<256, 16, 1>(a, s);
    case 9: return launch<256, 8, 1>(a, s);
    case 10: return launch<256, 4, 1>(a, s);
    case 11: return launch<256, 2, 4>(a, s);
    case 12: return launch<512, 2, 2>(a, s);
    case 13: return launch<512, 1, 1>(a, s);
    default: return launch<1024, 1, 1>(a, s);
  }
}
