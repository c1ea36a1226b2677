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
// array, zeroing by global coordinates, and after a barrier each thread
// evaluates the tests and the Sobel for its pixels from shared memory.  The
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

namespace {

constexpr int kMaxTests = 32;
constexpr int kHalo = 13;                 // code offsets reach +-13 px
constexpr int kPad = kHalo + 1;           // plus the box/Sobel 1-px halo
constexpr int kMargin = 13;               // candidate interior margin
constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kThreadsY = 8;              // block = (kTileW, kThreadsY)
constexpr int kRawH = kTileH + 2 * kPad;  // 60
constexpr int kRawW = kTileW + 2 * kPad;  // 92
constexpr int kBoxH = kTileH + 2 * kHalo; // 58
constexpr int kBoxW = kTileW + 2 * kHalo; // 90

struct Tests {
  int n;
  int iy[kMaxTests];
  int ix[kMaxTests];
  int jy[kMaxTests];
  int jx[kMaxTests];
  int tau[kMaxTests];
};

__global__ void __launch_bounds__(kTileW * kThreadsY)
fused_keys_kernel(const uint8_t* __restrict__ img, int32_t* __restrict__ out,
                  int h, int w, int out_row_stride, int out_batch_stride,
                  int col_offset, const __grid_constant__ Tests tests,
                  int thr2, int pos_base,
                  int sentinel_base, int pack_bits) {
  __shared__ uint8_t raw[kRawH][kRawW];       // image (y0-14 .., x0-14 ..)
  __shared__ uint8_t smooth[kBoxH][kBoxW];    // image (y0-13 .., x0-13 ..)

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const uint8_t* src = img + static_cast<size_t>(b) * h * w;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  constexpr int kThreads = kTileW * kThreadsY;

  for (int i = tid; i < kRawH * kRawW; i += kThreads) {
    const int r = i / kRawW, c = i % kRawW;
    const int gy = y0 + r - kPad, gx = x0 + c - kPad;
    raw[r][c] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                    ? src[static_cast<size_t>(gy) * w + gx] : 0;
  }
  __syncthreads();

  for (int i = tid; i < kBoxH * kBoxW; i += kThreads) {
    const int r = i / kBoxW, c = i % kBoxW;
    const int gy = y0 + r - kHalo, gx = x0 + c - kHalo;
    int v = 0;
    if (gy >= 1 && gy <= h - 3 && gx >= 2 && gx <= w - 2) {
      int s = 0;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) s += raw[r + dy][c + dx];
      v = s / 9;  // s >= 0: truncation is the floor
    }
    smooth[r][c] = static_cast<uint8_t>(v);
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int x = x0 + tx;
  if (x >= w) return;
  int32_t* dst = out + static_cast<size_t>(b) * out_batch_stride + col_offset;
  for (int ty = threadIdx.y; ty < kTileH; ty += kThreadsY) {
    const int y = y0 + ty;
    if (y >= h) break;
    uint32_t code = 0;
    // unrolled, so every test field is an immediate constant-bank operand
#pragma unroll
    for (int t = 0; t < kMaxTests; ++t) {
      if (t < tests.n) {
        const int a = smooth[ty + kHalo + tests.iy[t]][tx + kHalo + tests.ix[t]];
        const int bb = smooth[ty + kHalo + tests.jy[t]][tx + kHalo + tests.jx[t]];
        code = code * 2u + (a > bb - tests.tau[t] ? 1u : 0u);
      }
    }
    // Sobel on the raw tile: raw row ty + kPad + dy is image row y + dy
    auto px = [&](int dy, int dx) {
      return static_cast<int>(raw[ty + kPad + dy][tx + kPad + dx]);
    };
    const int sx_num = px(-1, -1) + px(1, -1) + 2 * px(0, -1)
                       - px(-1, 1) - 2 * px(0, 1) - px(1, 1);
    const int sy_num = px(-1, -1) + px(-1, 1) + 2 * px(-1, 0)
                       - px(1, -1) - 2 * px(1, 0) - px(1, 1);
    const int sx = sx_num / 9, sy = sy_num / 9;  // C truncation, as wanted
    const bool cand = sx * sx + sy * sy > thr2 && y >= kMargin &&
                      y < h - kMargin && x >= kMargin && x < w - kMargin;
    const int pos = pos_base + x;
    int32_t key;
    if (!cand)
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
  if (n_tests < 1 || n_tests > kMaxTests || batch < 0 || h < 0 || w < 0 ||
      pack_bits < 0 || pack_bits > 30 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || w == 0) return 0;
  Tests t{};
  t.n = n_tests;
  const int* src = static_cast<const int*>(tests);
  for (int i = 0; i < n_tests; ++i) {
    t.iy[i] = src[5 * i + 0];
    t.ix[i] = src[5 * i + 1];
    t.jy[i] = src[5 * i + 2];
    t.jx[i] = src[5 * i + 3];
    t.tau[i] = src[5 * i + 4];
    if (t.iy[i] < -kHalo || t.iy[i] > kHalo || t.ix[i] < -kHalo ||
        t.ix[i] > kHalo || t.jy[i] < -kHalo || t.jy[i] > kHalo ||
        t.jx[i] < -kHalo || t.jx[i] > kHalo)
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
