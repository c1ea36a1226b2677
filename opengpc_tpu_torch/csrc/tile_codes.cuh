// Shared tile math of the code kernels: the port's counterpart of
// opengpc_tpu/ops/fused.py::tile_codes_and_cand, which every Pallas kernel
// of that module and ops/fused_match.py calls.
//
// A CodeTile<kTileH, kTileW> lives in shared memory.  stage() copies the
// tile's (kTileH+28) x (kTileW+28) uint8 window from a source buffer that
// holds image rows [src_row0, src_row0 + src_rows) (the whole image, or a
// row slab with its halo; zeros outside the buffer and the columns) and
// box-blurs its (kTileH+26) x (kTileW+26) code-support region, zeroing by
// image coordinates of the h-row image:
//   smooth = floor(box3x3 / 9), zero outside 1 <= y <= h-3, 2 <= x <= w-2.
// Then, for the pixel at tile (ty, tx) = image (y, x):
//   code() = T <= 32 tests smooth[p+i] > smooth[p+j] - tau, MSB-first,
//            accumulated in uint32 so that 32 tests wrap as JAX's int32 does;
//   cand() = (sx^2 + sy^2 > thr^2) with C-truncating Sobel / 9 on the raw
//            image, inside the 13-px candidate margin.
// Tests arrive by value as a __grid_constant__ kernel parameter; the test
// loop is unrolled over 32, so every field is a constant-bank operand.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ogpc {

constexpr int kMaxTests = 32;
constexpr int kHalo = 13;          // code offsets reach +-13 px
constexpr int kPad = kHalo + 1;    // plus the box/Sobel 1-px halo
constexpr int kMargin = 13;        // candidate interior margin
constexpr int32_t kSentinelBase = 0x40000000;  // match.SENTINEL_BASE

struct Tests {
  int n;
  int iy[kMaxTests];
  int ix[kMaxTests];
  int jy[kMaxTests];
  int jx[kMaxTests];
  int tau[kMaxTests];
};

// Host side: n_tests rows of (iy, ix, jy, jx, tau) into *t.  False on a
// test count outside 1..32 or an offset beyond +-13 px.
inline bool load_tests(const void* src, int n_tests, Tests* t) {
  if (n_tests < 1 || n_tests > kMaxTests) return false;
  *t = Tests{};
  t->n = n_tests;
  const int* s = static_cast<const int*>(src);
  for (int i = 0; i < n_tests; ++i) {
    t->iy[i] = s[5 * i + 0];
    t->ix[i] = s[5 * i + 1];
    t->jy[i] = s[5 * i + 2];
    t->jx[i] = s[5 * i + 3];
    t->tau[i] = s[5 * i + 4];
    const int off[4] = {t->iy[i], t->ix[i], t->jy[i], t->jx[i]};
    for (int o : off)
      if (o < -kHalo || o > kHalo) return false;
  }
  return true;
}

template <int kTileH, int kTileW>
struct CodeTile {
  static constexpr int kRawH = kTileH + 2 * kPad;
  static constexpr int kRawW = kTileW + 2 * kPad;
  static constexpr int kBoxH = kTileH + 2 * kHalo;
  static constexpr int kBoxW = kTileW + 2 * kHalo;

  uint8_t raw[kRawH][kRawW];     // image (y0-14 .., x0-14 ..)
  uint8_t smooth[kBoxH][kBoxW];  // image (y0-13 .., x0-13 ..)

  // Stage the tile whose first output pixel is image (y0, x0) of an h x w
  // image, with nthreads threads; ends with a barrier.  src holds the
  // image rows [src_row0, src_row0 + src_rows), w bytes each: the whole
  // image (src_row0 = 0, src_rows = h) or a slab.  The caller puts a
  // barrier between the last read of one tile and the next stage().
  __device__ __forceinline__ void stage(const uint8_t* __restrict__ src,
                                        int src_row0, int src_rows, int h,
                                        int w, int y0, int x0, int tid,
                                        int nthreads) {
    for (int i = tid; i < kRawH * kRawW; i += nthreads) {
      const int r = i / kRawW, c = i % kRawW;
      const int sy = y0 + r - kPad - src_row0, gx = x0 + c - kPad;
      raw[r][c] = (sy >= 0 && sy < src_rows && gx >= 0 && gx < w)
                      ? src[static_cast<size_t>(sy) * w + gx] : 0;
    }
    __syncthreads();
    for (int i = tid; i < kBoxH * kBoxW; i += nthreads) {
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
  }

  __device__ __forceinline__ uint32_t code(int ty, int tx,
                                           const Tests& tests) const {
    uint32_t c = 0;
#pragma unroll
    for (int t = 0; t < kMaxTests; ++t) {
      if (t < tests.n) {
        const int a = smooth[ty + kHalo + tests.iy[t]][tx + kHalo + tests.ix[t]];
        const int b = smooth[ty + kHalo + tests.jy[t]][tx + kHalo + tests.jx[t]];
        c = c * 2u + (a > b - tests.tau[t] ? 1u : 0u);
      }
    }
    return c;
  }

  __device__ __forceinline__ bool cand(int ty, int tx, int y, int x, int h,
                                       int w, int thr2) const {
    // raw row ty + kPad + dy is image row y + dy
    auto px = [&](int dy, int dx) {
      return static_cast<int>(raw[ty + kPad + dy][tx + kPad + dx]);
    };
    const int sx_num = px(-1, -1) + px(1, -1) + 2 * px(0, -1)
                       - px(-1, 1) - 2 * px(0, 1) - px(1, 1);
    const int sy_num = px(-1, -1) + px(-1, 1) + 2 * px(-1, 0)
                       - px(1, -1) - 2 * px(1, 0) - px(1, 1);
    const int sx = sx_num / 9, sy = sy_num / 9;  // C truncation, as wanted
    return sx * sx + sy * sy > thr2 && y >= kMargin && y < h - kMargin &&
           x >= kMargin && x < w - kMargin;
  }
};

}  // namespace ogpc
