// Fused code kernel: box blur, leaf codes and Sobel candidates in one pass,
// emitting codes and candidates as two images.
//
// Replaces the TPU kernel opengpc_tpu/ops/fused.py::_kernel (wrapper
// fused_codes, math tile_codes_and_cand).  For each pixel (y, x) of an
// (H, W) uint8 image it writes the int32 leaf code (all 32 bits at 32 tests,
// wrapping as JAX's int32 does) and the uint8 candidate flag (0 or 1; the
// wrapper views it as bool).  The flat and global matchers read these when
// the codes cannot share an int32 key with a sentinel (more than 30 tests,
// or global mode), and extract_descriptors reads them directly.
//
// Design.  The key kernel's, through the same CodeTile (tile_codes.cuh):
// one block per 32x64 output tile of one image of the batch stages the
// (60, 92) uint8 window and its blurred (58, 90) code-support region in
// shared memory; each thread then evaluates the tests and the Sobel for its
// pixels.  Ragged tiles are masked.  The kernel allocates nothing and runs
// on the caller's stream.
//
// Bound on the H100.  As the key kernel: 1 byte read and 5 written per pixel
// of device memory traffic (~2.2 MB per 436x1024 image, under a
// microsecond at 3.35 TB/s), against 2T shared-memory loads per pixel for
// the tests plus the box and Sobel; shared-memory load issue and integer
// instructions bound it.  The design keeps each reused byte in shared
// memory and keeps a warp on consecutive bytes, so loads are conflict-free.

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
fused_codes_kernel(const uint8_t* __restrict__ img,
                   int32_t* __restrict__ codes, uint8_t* __restrict__ cand,
                   int h, int w, const __grid_constant__ Tests tests,
                   int thr2) {
  __shared__ CodeTile<kTileH, kTileW> tile;

  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  tile.stage(img + base, 0, h, h, w, y0, x0, tid, kTileW * kThreadsY);

  const int tx = threadIdx.x;
  const int x = x0 + tx;
  if (x >= w) return;
  for (int ty = threadIdx.y; ty < kTileH; ty += kThreadsY) {
    const int y = y0 + ty;
    if (y >= h) break;
    const size_t i = base + static_cast<size_t>(y) * w + x;
    codes[i] = static_cast<int32_t>(tile.code(ty, tx, tests));
    cand[i] = tile.cand(ty, tx, y, x, h, w, thr2) ? 1 : 0;
  }
}

}  // namespace

// Codes and candidates of a (batch, h, w) uint8 image stack into the
// contiguous (batch, h, w) int32 codes and uint8 cand.  tests: host array
// of n_tests * (iy, ix, jy, jx, tau).  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int ogpc_fused_codes(const void* img, void* codes, void* cand,
                                int batch, int h, int w, const void* tests,
                                int n_tests, int thr2, void* stream) {
  Tests t;
  if (!ogpc::load_tests(tests, n_tests, &t) || batch < 0 || h < 0 || w < 0 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || w == 0) return 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  const dim3 block(kTileW, kThreadsY);
  fused_codes_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int32_t*>(codes),
      static_cast<uint8_t*>(cand), h, w, t, thr2);
  return static_cast<int>(cudaGetLastError());
}
