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
// Design.  One block handles kRows output rows: 4, 2 or 1, as many as keep
// the rows' keys and positions (8 N2 bytes a row) within 32 KB, so 4 up to
// N2 = 1024, 2 at N2 = 2048 and 1 from N2 = 4096 on.  For each image and
// each 128-column tile, the block stages the tile through tile_codes.cuh's
// CodeTile, the code kernels' tile math, and writes each pixel's key
// straight into its row in shared memory; the codes never reach device
// memory.  Then the shared bitonic network
// (bitonic.cuh, as the row-sort kernel) sorts the rows in place, and the
// detection reads the sorted rows from shared memory.  Shared memory is
// 8 kRows N2 bytes of rows plus ~9 KB of tile, so the design holds up to
// N2 = 16384 (W <= 8192, 128 KB of rows, as dynamic shared memory); the
// wrapper raises beyond that.
//
// Bound on the H100.  Device memory traffic is small (2 bytes read per
// pixel pair, 9 N2 bytes written per row: ~8 MB at 436x1024).  Per row the
// block does 2W x 2T shared loads for the tests, the box over a (kRows+26)
// row band (the halo is recomputed for each block of rows: the price of
// keeping whole sorted rows resident), and N2/2 log2(N2)^2 / 2
// compare-exchanges with a barrier per stage.  So shared-memory issue and
// barrier latency bound it.

#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "tile_codes.cuh"

namespace {

using ogpc::CodeTile;
using ogpc::Tests;

constexpr int kThreads = 256;
constexpr int kTileW = 128;
constexpr int32_t kPadKeyBase = 0x7F000000;
constexpr int kMinLog2 = 8;   // N2 >= 256
constexpr int kMaxLog2 = 14;  // N2 <= 16384
constexpr int kRowBytesBudget = 32 * 1024;

template <int kRows>
__global__ void __launch_bounds__(kThreads)
fused_match_kernel(const uint8_t* __restrict__ left,
                   const uint8_t* __restrict__ right,
                   uint8_t* __restrict__ keep_out,
                   int32_t* __restrict__ srcx_out,
                   int32_t* __restrict__ d_out, int h, int w, int log2n,
                   const __grid_constant__ Tests tests, int thr2,
                   int disp_high) {
  extern __shared__ int32_t smem[];
  __shared__ CodeTile<kRows, kTileW> tile;
  const int n = 1 << log2n;
  int32_t* key = smem;              // [kRows][n]
  int32_t* pos = smem + kRows * n;  // [kRows][n]
  const int tid = threadIdx.x;
  const int y0 = blockIdx.x * kRows;

  for (int i = tid; i < kRows * n; i += kThreads) {
    const int lane = i & (n - 1);
    pos[i] = lane;
    if (lane >= 2 * w) key[i] = kPadKeyBase + lane;
  }
  for (int side = 0; side < 2; ++side) {
    const uint8_t* src = side ? right : left;
    for (int x0 = 0; x0 < w; x0 += kTileW) {
      tile.stage(src, 0, h, h, w, y0, x0, tid, kThreads);
      for (int p = tid; p < kRows * kTileW; p += kThreads) {
        const int ty = p / kTileW, tx = p % kTileW;
        const int x = x0 + tx;
        if (x >= w) continue;
        const int lane = side * w + x;
        key[ty * n + lane] =
            tile.cand(ty, tx, y0 + ty, x, h, w, thr2)
                ? static_cast<int32_t>(tile.code(ty, tx, tests))
                : ogpc::kSentinelBase + lane;
      }
      __syncthreads();  // the next stage() overwrites the tile
    }
  }

  ogpc::bitonic_rows(key, pos, kRows, log2n, tid, kThreads);

  for (int i = tid; i < kRows * n; i += kThreads) {
    const int r = i >> log2n, lane = i & (n - 1);
    const int y = y0 + r;
    if (y >= h) continue;
    const int32_t* k = key + (r << log2n);
    const int32_t* p = pos + (r << log2n);
    bool keep = false;
    int lo = 0, d = 0;
    if (lane < n - 1 && k[lane] == k[lane + 1] &&
        !(lane >= 1 && k[lane - 1] == k[lane]) &&
        !(lane < n - 2 && k[lane + 1] == k[lane + 2])) {
      const int a = p[lane], b = p[lane + 1];
      lo = a < b ? a : b;
      const int hi = a < b ? b : a;
      d = lo - (hi - w);
      keep = lo < w && hi >= w && hi < 2 * w && d >= -disp_high &&
             d <= disp_high;
    }
    const size_t o = (static_cast<size_t>(y) << log2n) + lane;
    keep_out[o] = keep ? 1 : 0;
    srcx_out[o] = keep ? lo : 0;
    d_out[o] = keep ? d : 0;
  }
}

template <int kRows>
int launch(const void* left, const void* right, void* keep, void* srcx,
           void* d, int h, int w, int log2n, const Tests& t, int thr2,
           int disp_high, cudaStream_t stream) {
  const int smem = kRows * (2 << log2n) * static_cast<int>(sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      fused_match_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (h + kRows - 1) / kRows;
  fused_match_kernel<kRows><<<blocks, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(left), static_cast<const uint8_t*>(right),
      static_cast<uint8_t*>(keep), static_cast<int32_t*>(srcx),
      static_cast<int32_t*>(d), h, w, log2n, t, thr2, disp_high);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (keep, src_x, d), each a contiguous (h, n2) array (uint8, int32, int32),
// for the contiguous (h, w) uint8 images left and right.  n2 must be
// max(256, pow2 >= 2w) and at most 16384; tests: host array of
// n_tests * (iy, ix, jy, jx, tau), at most 30 tests.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ogpc_fused_sparsematch_rows(
    const void* left, const void* right, void* keep, void* srcx, void* d,
    int h, int w, int n2, const void* tests, int n_tests, int thr2,
    int disp_high, void* stream) {
  Tests t;
  int log2n = 0;
  while ((1 << log2n) < n2) ++log2n;
  if (!ogpc::load_tests(tests, n_tests, &t) || n_tests > 30 || h < 0 ||
      w < 1 || disp_high < 0 || n2 != (1 << log2n) || log2n < kMinLog2 ||
      log2n > kMaxLog2 || n2 < 2 * w || (n2 > 256 && n2 / 2 >= 2 * w))
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_bytes = 2 * n2 * static_cast<int>(sizeof(int32_t));
  if (4 * row_bytes <= kRowBytesBudget)
    return launch<4>(left, right, keep, srcx, d, h, w, log2n, t, thr2,
                     disp_high, s);
  if (2 * row_bytes <= kRowBytesBudget)
    return launch<2>(left, right, keep, srcx, d, h, w, log2n, t, thr2,
                     disp_high, s);
  return launch<1>(left, right, keep, srcx, d, h, w, log2n, t, thr2,
                   disp_high, s);
}
