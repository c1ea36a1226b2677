// Shared tile math of the code kernels: the port's counterpart of
// opengpc_tpu/ops/fused.py::tile_codes_and_cand, which every Pallas kernel
// of that module and ops/fused_match.py calls.  For the pixel (y, x) of an
// h-row, w-column image:
//   smooth = floor(box3x3 / 9), zero outside 1 <= y <= h-3, 2 <= x <= w-2;
//   code   = T <= 32 tests smooth[p+i] > smooth[p+j] - tau, MSB-first,
//            accumulated in uint32 so that 32 tests wrap as JAX's int32 does;
//   cand   = (sx^2 + sy^2 > thr^2) with C-truncating Sobel / 9 on the raw
//            image, inside the 13-px candidate margin.
// StripTile (below) holds a tile of it in shared memory; stage_raw copies
// a raw window from a source buffer that holds image rows [src_row0,
// src_row0 + src_rows), the whole image or a row slab with its halo, as
// aligned 16-byte vectors (the census kernel stages through it too).
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

// Stage the kRows x kCols uint8 window whose first pixel is image (gy0,
// gx0) into raw4, row after row (kCols % 16 == 0, gx0 % 16 == 0), without
// a barrier.  src holds image rows [src_row0, src_row0 + src_rows), w
// bytes each; pixels outside those rows or the w columns are zeros.  vec:
// src rows are 16-byte aligned (w % 16 == 0 and src aligned), so a chunk
// inside the row loads as one vector; else its bytes load one by one.
template <int kRows, int kCols>
__device__ __forceinline__ void stage_raw(uint4* __restrict__ raw4,
                                          const uint8_t* __restrict__ src,
                                          int src_row0, int src_rows, int w,
                                          int gy0, int gx0, bool vec,
                                          int tid, int nthreads) {
  static_assert(kCols % 16 == 0, "whole 16-byte chunks");
  constexpr int kChunks = kCols / 16;
  for (int i = tid; i < kRows * kChunks; i += nthreads) {
    const int sy = gy0 + i / kChunks - src_row0;
    const int gx = gx0 + 16 * (i % kChunks);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (sy >= 0 && sy < src_rows) {
      const uint8_t* row = src + static_cast<size_t>(sy) * w;
      if (vec && gx >= 0 && gx + 16 <= w) {
        v = *reinterpret_cast<const uint4*>(row + gx);
      } else {
        uint32_t b[4] = {0, 0, 0, 0};
#pragma unroll
        for (int k = 0; k < 16; ++k)
          if (gx + k >= 0 && gx + k < w)
            b[k / 4] |= static_cast<uint32_t>(row[gx + k]) << (8 * (k % 4));
        v = make_uint4(b[0], b[1], b[2], b[3]);
      }
    }
    raw4[i] = v;
  }
}

// StripTile: the tile of the key, code and fused match kernels, for strips
// of 4 horizontally adjacent pixels, with the blurred region held as
// 16-bit lanes, two pixels to a word.
//
//   raw      the (kTileH+28) x (kTileW+32) uint8 window, column 0 at image
//            x0 - 16 so that rows stage as aligned 16-byte vectors;
//   sm[k]    the blurred region, sm[k] u16 index c + k holding smooth
//            column c (image x0 - 13 + c), in rows of an odd number of
//            words.  Copy k = 1 is copy 0 shifted by one lane, so that any
//            4 consecutive smooth columns are two aligned words of one
//            copy, and a warp's two rows of strips hit disjoint banks.
//
// A test a > b - tau on two lanes at once: with tau clamped to [-255, 256]
// (which changes no result, since a and b are in [0, 255]),
//   0x8000 + a - b + tau - 1  lies in [0x7e01, 0x81fe]
// and has bit 15 set iff a - b + tau - 1 >= 0, i.e. iff a > b - tau.  So
// A + C - B on words of two lanes, C = two lanes of 0x8000 + tau - 1, is
// exact for every int tau: no lane borrows from or carries into the other.
// Bit 15 of each lane is shifted into an accumulator word, 16 tests to a
// word, and reversed into the MSB-first code at the end.

// A forest's tests as StripTile offsets: the word offsets of the two taps
// from a strip's base word, and the two-lane constant.
struct StripTests {
  int n;
  int off_a[kMaxTests];
  int off_b[kMaxTests];
  uint32_t c[kMaxTests];
};

template <int kTileH, int kTileW>
struct StripTile {
  static constexpr int kRawOff = 16;  // raw column 0 is image x0 - 16
  static constexpr int kRawH = kTileH + 2 * kPad;
  static constexpr int kRawW = kTileW + 2 * kRawOff;
  static constexpr int kBoxH = kTileH + 2 * kHalo;
  static constexpr int kGroups = (kTileW + 2 * kHalo + 3) / 4;  // 4 columns
  static constexpr int kBoxW = 4 * kGroups;
  static constexpr int kWords = ((kBoxW + 2) / 2) | 1;  // odd row stride
  static constexpr int kSegRows = 6;  // box rows per staging task
  static constexpr int kSegs = (kBoxH + kSegRows - 1) / kSegRows;
  static_assert(kTileW % 64 == 0 && kRawW % 16 == 0, "aligned raw rows");
  static_assert(kBoxW + 4 <= kRawW, "box reads stay in the raw row");

  uint4 raw4[kRawH * kRawW / 16];
  uint32_t sm[2][kBoxH][kWords];

  // Host side: the tests as word offsets from a strip's base word (see
  // base()) and two-lane constants.
  static StripTests strip_tests(const Tests& t) {
    StripTests s{};
    s.n = t.n;
    auto off = [](int iy, int ix) {
      const int k = (kHalo + ix) & 1;  // the copy whose words align
      return k * kBoxH * kWords + (kHalo + iy) * kWords + (kHalo + ix + k) / 2;
    };
    for (int i = 0; i < t.n; ++i) {
      s.off_a[i] = off(t.iy[i], t.ix[i]);
      s.off_b[i] = off(t.jy[i], t.jx[i]);
      const int tau = t.tau[i] < -255 ? -255
                      : (t.tau[i] > 256 ? 256 : t.tau[i]);
      const uint32_t lane = static_cast<uint32_t>(0x8000 + tau - 1);
      s.c[i] = lane | (lane << 16);
    }
    return s;
  }

  __device__ __forceinline__ const uint8_t* raw() const {
    return reinterpret_cast<const uint8_t*>(raw4);
  }

  // Stage the tile whose first output pixel is (y0, x0) of an h x w image;
  // ends with a barrier.  src holds image rows [src_row0, src_row0 +
  // src_rows) (see stage_raw): the whole image (0, h), or a row slab with
  // its halo, of a frame of h rows.  The box border stays in rows of that
  // h-row image.
  __device__ __forceinline__ void stage(const uint8_t* __restrict__ src,
                                        int src_row0, int src_rows, int h,
                                        int w, int y0, int x0, bool vec,
                                        int tid, int nthreads) {
    stage_raw<kRawH, kRawW>(raw4, src, src_row0, src_rows, w, y0 - kPad,
                            x0 - kRawOff, vec, tid, nthreads);
    __syncthreads();
    // box: each task blurs 4 columns over kSegRows rows, a horizontal
    // 3-sum per raw row (two lanes a word) rolled into vertical 3-sums
    const uint8_t* rb = raw();
    for (int task = tid; task < kGroups * kSegs; task += nthreads) {
      const int c = 4 * (task % kGroups);
      const int r0 = (task / kGroups) * kSegRows;
      const int r1 = r0 + kSegRows < kBoxH ? r0 + kSegRows : kBoxH;
      auto col_ok = [&](int j) {  // 2 <= x <= w-2
        const int gx = x0 - kHalo + c + j;
        return gx >= 2 && gx <= w - 2;
      };
      const uint32_t m01 = (col_ok(0) ? 0xffffu : 0u) |
                           (col_ok(1) ? 0xffff0000u : 0u);
      const uint32_t m23 = (col_ok(2) ? 0xffffu : 0u) |
                           (col_ok(3) ? 0xffff0000u : 0u);
      // smooth column c + j sums raw columns c+2+j .. c+4+j
      auto hsum = [&](int r, uint32_t& a, uint32_t& b) {
        const uint32_t* rw =
            reinterpret_cast<const uint32_t*>(rb + r * kRawW + c);
        const uint32_t w0 = rw[0], w1 = rw[1];
        const uint32_t e23 = __byte_perm(w0, 0, 0x4342);
        const uint32_t e45 = __byte_perm(w1, 0, 0x4140);
        const uint32_t e67 = __byte_perm(w1, 0, 0x4342);
        a = e23 + __funnelshift_r(e23, e45, 16) + e45;
        b = e45 + __funnelshift_r(e45, e67, 16) + e67;
      };
      uint32_t a0, b0, a1, b1;
      hsum(r0, a0, b0);
      hsum(r0 + 1, a1, b1);
      for (int r = r0; r < r1; ++r) {
        uint32_t a2, b2;
        hsum(r + 2, a2, b2);
        const int gy = y0 - kHalo + r;
        uint32_t q01 = 0, q23 = 0;
        if (gy >= 1 && gy <= h - 3) {  // lanes <= 2295: floor(v/9) exact
          q01 = div9_lanes(a0 + a1 + a2) & m01;
          q23 = div9_lanes(b0 + b1 + b2) & m23;
        }
        uint32_t* s0 = &sm[0][r][c / 2];
        s0[0] = q01;
        s0[1] = q23;
        uint32_t* s1 = &sm[1][r][c / 2];
        reinterpret_cast<uint16_t*>(s1)[1] = static_cast<uint16_t>(q01);
        s1[1] = __funnelshift_r(q01, q23, 16);
        reinterpret_cast<uint16_t*>(s1 + 2)[0] =
            static_cast<uint16_t>(q23 >> 16);
        a0 = a1;
        a1 = a2;
        b0 = b1;
        b1 = b2;
      }
    }
    __syncthreads();
  }

  // The whole h x w image at src.
  __device__ __forceinline__ void stage(const uint8_t* __restrict__ src,
                                        int h, int w, int y0, int x0,
                                        bool vec, int tid, int nthreads) {
    stage(src, 0, h, h, w, y0, x0, vec, tid, nthreads);
  }

  static __device__ __forceinline__ uint32_t div9_lanes(uint32_t v) {
    return (((v & 0xffffu) * 7282u) >> 16) |
           (((v >> 16) * 7282u) & 0xffff0000u);
  }

  // The word of sm[0] at which the strip of tile row ty, strip sx starts.
  __device__ __forceinline__ const uint32_t* base(int ty, int sx) const {
    return &sm[0][ty][2 * sx];
  }

  // Codes of the 4 pixels of the strip at base b, MSB-first (uint32, so
  // 32 tests wrap as JAX's int32).
  __device__ __forceinline__ void codes(const uint32_t* b,
                                        const StripTests& t,
                                        uint32_t code[4]) const {
    uint32_t acc[2][2] = {{0, 0}, {0, 0}};  // [tests / 16][pixels / 2]
#pragma unroll
    for (int i = 0; i < kMaxTests; ++i) {
      if (i < t.n) {
        const uint32_t* pa = b + t.off_a[i];
        const uint32_t* pb = b + t.off_b[i];
        const uint32_t r0 = pa[0] + t.c[i] - pb[0];
        const uint32_t r1 = pa[1] + t.c[i] - pb[1];
        acc[i / 16][0] = (acc[i / 16][0] >> 1) | (r0 & 0x80008000u);
        acc[i / 16][1] = (acc[i / 16][1] >> 1) | (r1 & 0x80008000u);
      }
    }
    // tests 0..15 (16 or t.n of them) end in bits 16-n1 .. 15 of a lane,
    // the first lowest; tests 16.. likewise in the second accumulator
    const int n2 = t.n > 16 ? t.n - 16 : 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int sh = 16 * (p & 1);
      const uint32_t la = (acc[0][p / 2] >> sh) & 0xffffu;
      const uint32_t lb = (acc[1][p / 2] >> sh) & 0xffffu;
      code[p] = (__brev(la) >> (16 - n2)) | (__brev(lb) >> 16);
    }
  }

  // Candidate bits (bit p for pixel x + p) of the strip at tile row ty,
  // strip sx, image row y, first column x.
  __device__ __forceinline__ unsigned cands(int ty, int sx, int y, int x,
                                            int h, int w, int thr2) const {
    if (y < kMargin || y >= h - kMargin) return 0;
    const uint8_t* rp = raw() + (ty + kPad) * kRawW + 4 * sx + kRawOff;
    int cs[6], rd[6];  // columns x-1 .. x+4: (1,2,1) column sums, top-bottom
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int t = rp[j - 1 - kRawW], m = rp[j - 1], b = rp[j - 1 + kRawW];
      cs[j] = t + 2 * m + b;
      rd[j] = t - b;
    }
    unsigned bits = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int sx9 = (cs[p] - cs[p + 2]) / 9;  // C truncation, as wanted
      const int sy9 = (rd[p] + 2 * rd[p + 1] + rd[p + 2]) / 9;
      const int xp = x + p;
      if (sx9 * sx9 + sy9 * sy9 > thr2 && xp >= kMargin && xp < w - kMargin)
        bits |= 1u << p;
    }
    return bits;
  }
};

}  // namespace ogpc
