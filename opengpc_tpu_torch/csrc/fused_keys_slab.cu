// Slab key kernel: the fused key kernel's sentinel-packed sort keys for a
// row slab of a larger image, the per-shard kernel of the row-sharded
// single frame.
//
// Replaces the TPU kernel opengpc_tpu/ops/fused.py::_kernel_keys_slab
// (wrapper fused_keys_slab).  The (sh + 28) x W uint8 slab holds image rows
// [y0 - 14, y0 + sh + 14) of an h_total-row image (zeros outside the
// image: the top and bottom shards get zero halos).  For output row
// r in [0, sh), image row y = y0 + r:
//   key = cand ? code : sentinel_base + pos_base + x
// with the box border (1 <= y <= h_total-3) and the 13-px candidate margin
// taken in image rows, so the keys equal rows [y0, y0 + sh) of the key
// kernel on the whole image.  y0 is a kernel argument: the host knows each
// shard's offset (rank * sh), as the Pallas kernel reads it from SMEM.
//
// Design.  The key kernel's: one block per 32x64 output tile stages its
// (60, 92) uint8 window and the blurred (58, 90) region through
// tile_codes.cuh's CodeTile, whose source window here is the slab
// (src_row0 = y0 - 14, src_rows = sh + 28): reads past the slab, which only
// the last partial tile makes and only for rows it does not write, are
// zeros.  Keys go into columns [col_offset, col_offset + W) of an int32
// output of row stride out_row_stride, so both images of a pair fill one
// (sh, 2W) key image.  The kernel allocates nothing and runs on the
// caller's stream.
//
// Bound on the H100.  As the key kernel: ~1 byte read and 4 written per
// pixel, against 2T shared-memory loads per pixel for the tests plus the
// box and Sobel; shared-memory loads and integer instructions bound it.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_codes.cuh"

namespace {

using ogpc::CodeTile;
using ogpc::Tests;

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreadsY = 8;  // block = (kTileW, kThreadsY)

__global__ void __launch_bounds__(kTileW * kThreadsY)
fused_keys_slab_kernel(const uint8_t* __restrict__ slab,
                       int32_t* __restrict__ out, int sh, int w,
                       int out_row_stride, int col_offset,
                       const __grid_constant__ Tests tests, int thr2,
                       int pos_base, int sentinel_base, int y0, int h_total) {
  __shared__ CodeTile<kTileH, kTileW> tile;

  const int r0 = blockIdx.y * kTileH;  // first output row of the tile
  const int x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  tile.stage(slab, y0 - ogpc::kPad, sh + 2 * ogpc::kPad, h_total, w, y0 + r0,
             x0, tid, kTileW * kThreadsY);

  const int tx = threadIdx.x;
  const int x = x0 + tx;
  if (x >= w) return;
  for (int ty = threadIdx.y; ty < kTileH; ty += kThreadsY) {
    const int r = r0 + ty;
    if (r >= sh) break;
    const int32_t key =
        tile.cand(ty, tx, y0 + r, x, h_total, w, thr2)
            ? static_cast<int32_t>(tile.code(ty, tx, tests))
            : sentinel_base + pos_base + x;
    out[static_cast<size_t>(r) * out_row_stride + col_offset + x] = key;
  }
}

}  // namespace

// Keys of the (sh + 28, w) uint8 slab at image row y0 of an h_total-row
// image into columns [col_offset, col_offset + w) of an int32 output with
// row stride out_row_stride.  tests: host array of n_tests * (iy, ix, jy,
// jx, tau).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ogpc_fused_keys_slab(const void* slab, void* out, int sh,
                                    int w, int out_row_stride, int col_offset,
                                    const void* tests, int n_tests, int thr2,
                                    int pos_base, int sentinel_base, int y0,
                                    int h_total, void* stream) {
  Tests t;
  if (!ogpc::load_tests(tests, n_tests, &t) || sh < 0 || w < 0 || y0 < 0 ||
      y0 + sh > h_total || col_offset < 0 ||
      col_offset + w > out_row_stride)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sh == 0 || w == 0) return 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (sh + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kThreadsY);
  fused_keys_slab_kernel<<<grid, block, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(slab), static_cast<int32_t*>(out), sh, w,
      out_row_stride, col_offset, t, thr2, pos_base, sentinel_base, y0,
      h_total);
  return static_cast<int>(cudaGetLastError());
}
