// Fused key kernel: box blur, leaf codes and Sobel candidates in one pass,
// emitting the epipolar matcher's sentinel-packed sort keys.
//
// Replaces the TPU kernel opengpc_tpu/ops/fused.py::_kernel_keys (wrapper
// fused_keys, math tile_codes_and_cand).  For each pixel (y, x) of an
// (H, W) uint8 image:
//   smooth  = floor(box3x3 / 9), zero outside 1 <= y <= h-3, 2 <= x <= w-2
//   code    = T <= 32 tests smooth[p+i] > smooth[p+j] - tau, MSB-first
//   cand    = (sx^2 + sy^2 > thr^2) with C-truncating Sobel / 9, inside the
//             13-px margin
//   key     = cand ? code : sentinel_base + pos_base + x
//             (cand ? (code << pack_bits) | (pos_base + x) when pack_bits > 0)
//
// Design.  One block computes a 32x64 output tile.  It stages the tile's
// (32+28) x (64+28) uint8 window in shared memory (zeros outside the image),
// box-blurs the (32+26) x (64+26) code-support region into a second shared
// array, zeroing by global coordinates (tile_codes.cuh's CodeTile, shared
// with the other code kernels), and after a barrier each thread evaluates
// the tests and the Sobel for its pixels from shared memory.  The
// blurred image never reaches device memory.  Tests arrive by value in the
// kernel's parameter space (no device allocation, no per-call copy); every
// thread reads the same test at once, which the constant bank broadcasts.
// Ragged tiles are masked, so any H and W work.  The kernel allocates
// nothing and runs on the caller's stream.
//
// Bound on the H100.  Device memory traffic is about 1 byte read and 4
// written per pixel (5 MB for a 436x1024 pair: ~1.5 us at 3.35 TB/s).  The
// work per pixel is 2T shared-memory loads for the tests plus ~9 for the box
// and 8 for the Sobel, so at T = 30 the kernel is bound by shared-memory load
// issue and integer instructions, not by device memory.  The design keeps
// every reused byte in shared memory (each input byte is read ~60 times)
// and keeps warps reading consecutive bytes, so the loads are
// conflict-free.  Making it faster (register tiling of the test loop,
// wider loads, one launch for both images) is later work.

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
fused_keys_kernel(const uint8_t* __restrict__ img, int32_t* __restrict__ out,
                  int h, int w, int out_row_stride, int out_batch_stride,
                  int col_offset, const __grid_constant__ Tests tests,
                  int thr2, int pos_base,
                  int sentinel_base, int pack_bits) {
  __shared__ CodeTile<kTileH, kTileW> tile;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  tile.stage(img + static_cast<size_t>(b) * h * w, 0, h, h, w, y0, x0, tid,
             kTileW * kThreadsY);

  const int tx = threadIdx.x;
  const int x = x0 + tx;
  if (x >= w) return;
  int32_t* dst = out + static_cast<size_t>(b) * out_batch_stride + col_offset;
  for (int ty = threadIdx.y; ty < kTileH; ty += kThreadsY) {
    const int y = y0 + ty;
    if (y >= h) break;
    const uint32_t code = tile.code(ty, tx, tests);
    const int pos = pos_base + x;
    int32_t key;
    if (!tile.cand(ty, tx, y, x, h, w, thr2))
      key = sentinel_base + pos;
    else if (pack_bits)
      key = static_cast<int32_t>((code << pack_bits) |
                                 static_cast<uint32_t>(pos));
    else
      key = static_cast<int32_t>(code);
    dst[static_cast<size_t>(y) * out_row_stride + x] = key;
  }
}

}  // namespace

// Keys of a (batch, h, w) uint8 image stack into columns
// [col_offset, col_offset + w) of an int32 output with the given row and
// batch strides.  tests: host array of n_tests * (iy, ix, jy, jx, tau).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ogpc_fused_keys(const void* img, void* out, int batch, int h,
                               int w, int out_row_stride, int out_batch_stride,
                               int col_offset, const void* tests, int n_tests,
                               int thr2, int pos_base, int sentinel_base,
                               int pack_bits, void* stream) {
  Tests t;
  if (!ogpc::load_tests(tests, n_tests, &t) || batch < 0 || h < 0 || w < 0 ||
      pack_bits < 0 || pack_bits > 30 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  const dim3 block(kTileW, kThreadsY);
  fused_keys_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int32_t*>(out), h, w,
      out_row_stride, out_batch_stride, col_offset, t, thr2, pos_base,
      sentinel_base, pack_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ogpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
