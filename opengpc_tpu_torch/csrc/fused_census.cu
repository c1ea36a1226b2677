// Census kernel: the dense 5x5 census transform in one pass, two pixels a
// word.
//
// Replaces the TPU kernel opengpc_tpu/ops/fused.py::_kernel_census (wrapper
// fused_census).  For each pixel (y, x) of an (H, W) uint8 image, bit i of
// the int32 code is set iff the i-th neighbour is strictly brighter than the
// centre, the neighbours walked x-major (px = -2..2, then py = -2..2) and
// the centre skipped: 24 bits.  Codes are zero outside the asymmetric box
// 2 <= y <= h-4, 2 <= x <= w-3 (ops/census.py).  The Pallas kernel builds
// the same code MSB-first over the reversed walk.
//
// The compare on two 16-bit lanes at once.  For bytes nb and c and a bit
// position k in 8..15, the lane value 2^k - 1 + nb - c lies in [2^k - 256,
// 2^k + 254]: never negative, below 2^(k+1), and at least 2^k iff nb > c.
// So bit k of the lane is the compare, the bits above it are zero, and on
// a word of two lanes A + C_k - B (C_k = two lanes of 2^k - 1) neither lane
// borrows from nor carries into the other.  Neighbour i takes k = 8 + i %
// 8 in accumulator i / 8, merged as acc | (r & bit k of both lanes): one
// three-input add and one logic op a word of two pixels, and each lane of
// the three accumulators holds its 8 census bits in its high byte, in the
// census order.  Two byte permutes gather a pixel's three high bytes into
// its code (neighbour i in bit i, no bit reversal).
//
// Design.  One block of 128 threads makes a 16x128 output tile: it stages
// the (20, 160) raw window, column 0 at x0 - 16, as aligned 16-byte
// vectors (tile_codes.cuh's stage_raw; zeros outside the image).  After
// one barrier each thread owns a strip of 4 pixels for 4 consecutive rows:
// it reads the 8 raw rows they need as 3 words a row (a warp reads 32
// consecutive words, conflict-free), widens each into 7 words of two
// 16-bit lanes in registers (4 byte permutes for the even column pairs, 3
// funnel shifts for the odd ones), so that every neighbour of the strip is
// two words, and makes the 24 compares a row of each of its two words.  A
// row outside the box skips its compares.  A strip leaves as one 16-byte
// store where the output row allows (W % 4 == 0), else scalar stores.
//
// Bound on the H100.  1 byte read and 4 written a pixel: 2.2 MB at
// 436x1024 (0.67 us at 3.35 TB/s) and 41.5 MB at 2160x3840 (12.4 us).
// The operations of this form (chip_smoke.py's CENSUS_OPS) are 28.75 a
// pixel: 24 for the compares, 1.75 to widen, 2 to assemble, 1 to mask, so
// ~12.8 M at 436x1024 (0.77 us at the card's INT32 instruction rate) and
// ~238 M at 2160x3840 (14.3 us): integer operations bound it, at both
// sizes.  On an H100 it takes 2.9 us at 436x1024 (3.7x the bound: 224
// blocks, near the launch floor) and 23.4 us at 2160x3840 (1.6x)
// (chip_smoke.py's slab_census_times, PERF.md).  ptxas: 64 registers,
// 3,200 bytes of shared memory, no spills.  The kernel allocates nothing
// and runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_codes.cuh"

namespace {

constexpr int kStrips = 32;               // strips of 4 pixels a tile row
constexpr int kTileW = 4 * kStrips;       // 128
constexpr int kRun = 4;                   // output rows a thread
constexpr int kThreadRows = 4;
constexpr int kTileH = kRun * kThreadRows;  // 16
constexpr int kThreads = kStrips * kThreadRows;
constexpr int kR = 2;                     // census radius
constexpr int kRawOff = 16;               // raw column 0 is image x0 - 16
constexpr int kRawH = kTileH + 2 * kR;
constexpr int kRawW = kTileW + 2 * kRawOff;
constexpr int kRawWords = kRawW / 4;
constexpr int kRows = kRun + 2 * kR;      // raw rows a thread reads
constexpr int kCentre = kR * (2 * kR + 1) + kR;  // the centre's walk index

// The 7 words of two 16-bit lanes of one raw row around a strip at x:
// e[j] holds columns (x - 2 + 2j, x - 1 + 2j), o[j] (x - 1 + 2j, x + 2j).
struct Lanes {
  uint32_t e[4];
  uint32_t o[3];
};

__device__ __forceinline__ Lanes widen(const uint32_t* p) {
  const uint32_t r0 = p[0], r1 = p[1], r2 = p[2];  // columns x-4 .. x+7
  Lanes l;
  l.e[0] = __byte_perm(r0, 0, 0x4342);
  l.e[1] = __byte_perm(r1, 0, 0x4140);
  l.e[2] = __byte_perm(r1, 0, 0x4342);
  l.e[3] = __byte_perm(r2, 0, 0x4140);
#pragma unroll
  for (int j = 0; j < 3; ++j)
    l.o[j] = __funnelshift_r(l.e[j], l.e[j + 1], 16);
  return l;
}

// The word of pixels (x + 2q + dx, x + 2q + dx + 1).
__device__ __forceinline__ uint32_t word(const Lanes& l, int dx, int q) {
  return (dx & 1) ? l.o[q + (dx + 1) / 2] : l.e[q + (dx + 2) / 2];
}

__global__ void __launch_bounds__(kThreads)
fused_census_kernel(const uint8_t* __restrict__ img,
                    int32_t* __restrict__ out, int h, int w, bool vec_in,
                    bool vec_out) {
  __shared__ uint4 raw4[kRawH * kRawW / 16];

  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  ogpc::stage_raw<kRawH, kRawW>(raw4, img, 0, h, w, y0 - kR, x0 - kRawOff,
                                vec_in, threadIdx.x, kThreads);
  __syncthreads();

  const int sx = threadIdx.x % kStrips;
  const int tr = threadIdx.x / kStrips;
  const int x = x0 + 4 * sx;
  const int ya = y0 + kRun * tr;  // the first of the thread's rows
  if (x >= w || ya >= h) return;
  // raw row kRun * tr + j is image row ya - 2 + j; word x-4 .. x-1 of it
  const uint32_t* rw = reinterpret_cast<const uint32_t*>(raw4) +
                       kRun * tr * kRawWords + (4 * sx + kRawOff - 4) / 4;
  Lanes rows[kRows];
#pragma unroll
  for (int j = 0; j < kRows; ++j) rows[j] = widen(rw + j * kRawWords);

  bool col_ok[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) col_ok[p] = x + p >= 2 && x + p <= w - 3;
  int32_t* dst = out + static_cast<size_t>(ya) * w + x;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int y = ya + j;
    if (y >= h) break;
    uint32_t code[4] = {0, 0, 0, 0};
    if (y >= 2 && y <= h - 4) {
      uint32_t acc[3][2] = {{0, 0}, {0, 0}, {0, 0}};  // [i / 8][pair]
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t centre = word(rows[j + kR], 0, q);
#pragma unroll
        for (int px = -kR; px <= kR; ++px)
#pragma unroll
          for (int py = -kR; py <= kR; ++py) {
            const int n = (px + kR) * (2 * kR + 1) + py + kR;  // walk index
            if (n == kCentre) continue;
            const int i = n < kCentre ? n : n - 1;  // census bit
            const uint32_t bit = 0x10001u << (8 + i % 8);
            const uint32_t r =
                word(rows[j + kR + py], px, q) + (bit - 0x10001u) - centre;
            acc[i / 8][q] |= r & bit;
          }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        // lane 0's bits are byte 1 of each accumulator, lane 1's byte 3;
        // bytes 0 and 2 are zero and fill byte 3 of a code
        code[2 * q] = __byte_perm(
            __byte_perm(acc[0][q], acc[1][q], 0x0051), acc[2][q], 0x2510);
        code[2 * q + 1] = __byte_perm(
            __byte_perm(acc[0][q], acc[1][q], 0x0073), acc[2][q], 0x2710);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (!col_ok[p]) code[p] = 0;
    }
    if (vec_out && x + 4 <= w) {
      *reinterpret_cast<int4*>(dst) = make_int4(code[0], code[1], code[2],
                                                code[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (x + p < w) dst[p] = static_cast<int32_t>(code[p]);
    }
    dst += w;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Census codes of the contiguous (h, w) uint8 image into the contiguous
// (h, w) int32 out.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ogpc_fused_census(const void* img, void* out, int h, int w,
                                 void* stream) {
  if (h < 0 || w < 0 || !img || !out || (h + kTileH - 1) / kTileH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (h == 0 || w == 0) return 0;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  fused_census_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(img), static_cast<int32_t*>(out), h, w,
      w % 16 == 0 && aligned16(img), w % 4 == 0 && aligned16(out));
  return static_cast<int>(cudaGetLastError());
}
