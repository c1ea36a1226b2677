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
// One launch writes one or two sides of a batch: grid z runs over (image,
// side), side s reading image s and writing its own codes and candidates,
// so both images of a pair take one launch.
//
// Bound on the H100.  Device memory sees 1 byte read and 5 written a pixel:
// 5.4 MB for a 436x1024 pair, 1.6 us at 3.35 TB/s.  The math, counted in
// StripTile's two-lane form (chip_smoke.py's code_ops), is ~29 integer
// operations a pixel for the box, the Sobel and the output, and for every
// pixel 1.5 a test and 7 to assemble its code: ~74 M for a pair at 32
// tests, 4.4 us at the card's INT32 instruction rate.  So integer
// instructions bound it.
//
// Design: the key kernel's (fused_keys.cu), on tile_codes.cuh's
// StripTile<32, 64>.  One block of 256 threads makes a 32x64 output tile:
// it stages the (60, 96) raw window with 16-byte loads, blurs the (58, 92)
// code-support region separably into two lane-shifted copies of 16-bit
// lanes, and after one barrier each thread makes two strips of 4 pixels
// (rows ty and ty + 16): the Sobel for the candidate bits, and the codes
// of all 4 pixels, each test one add on a word of two pixels (exact for
// every tau, see StripTile).  A strip leaves as one 16-byte store of codes
// and one 4-byte store of candidates where the row aligns (W % 4 == 0),
// else scalar stores.  Both images of a 436x1024 pair at 32 tests are 448
// blocks, one wave, in 13.2 us on an H100, 3.0x the bound
// (chip_smoke.py's kernel_times, PERF.md).  ptxas: 32 registers, 27,568
// bytes of shared memory, no spills.  The kernel allocates nothing and
// runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_codes.cuh"

namespace {

using ogpc::StripTests;
using Tile = ogpc::StripTile<32, 64>;

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kStrips = kTileW / 4;     // strips a tile row
constexpr int kThreads = kStrips * 16;  // two tile rows a thread
constexpr int kMaxSides = 2;

struct Sides {
  const uint8_t* img[kMaxSides];
  int32_t* codes[kMaxSides];
  uint8_t* cand[kMaxSides];
};

__global__ void __launch_bounds__(kThreads)
fused_codes_kernel(const __grid_constant__ Sides sides, int nsides, int h,
                   int w, bool vec_in, bool vec_out,
                   const __grid_constant__ StripTests tests, int thr2) {
  __shared__ Tile tile;

  const int s = blockIdx.z % nsides;
  const size_t base = static_cast<size_t>(blockIdx.z / nsides) * h * w;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  tile.stage(sides.img[s] + base, h, w, y0, x0, vec_in, threadIdx.x,
             kThreads);

  const int sx = threadIdx.x % kStrips;
  const int x = x0 + 4 * sx;
  if (x >= w) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ty = threadIdx.x / kStrips + 16 * half;
    const int y = y0 + ty;
    if (y >= h) break;
    const unsigned cand = tile.cands(ty, sx, y, x, h, w, thr2);
    uint32_t code[4];
    tile.codes(tile.base(ty, sx), tests, code);
    const size_t o = base + static_cast<size_t>(y) * w + x;
    int32_t* dc = sides.codes[s] + o;
    uint8_t* dv = sides.cand[s] + o;
    if (vec_out && x + 4 <= w) {
      *reinterpret_cast<uint4*>(dc) =
          make_uint4(code[0], code[1], code[2], code[3]);
      // candidate bit p to byte p
      *reinterpret_cast<uint32_t*>(dv) = (cand & 1u) | (cand & 2u) << 7 |
                                         (cand & 4u) << 14 | (cand & 8u) << 21;
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if (x + p < w) {
          dc[p] = static_cast<int32_t>(code[p]);
          dv[p] = static_cast<uint8_t>(cand >> p & 1);
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Codes and candidates of one or two (batch, h, w) uint8 image stacks: side
// s (img1 == nullptr for one side) into the contiguous (batch, h, w) int32
// codes_s and uint8 cand_s.  tests: host array of n_tests * (iy, ix, jy,
// jx, tau).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ogpc_fused_codes(const void* img0, const void* img1,
                                void* codes0, void* cand0, void* codes1,
                                void* cand1, int batch, int h, int w,
                                const void* tests, int n_tests, int thr2,
                                void* stream) {
  ogpc::Tests t;
  const int nsides = img1 ? 2 : 1;
  if (!ogpc::load_tests(tests, n_tests, &t) || !img0 || !codes0 || !cand0 ||
      (img1 && !(codes1 && cand1)) || batch < 0 || h < 0 || w < 0 ||
      batch * nsides > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || h == 0 || w == 0) return 0;
  Sides sd{};
  const void* imgs[kMaxSides] = {img0, img1};
  void* codes[kMaxSides] = {codes0, codes1};
  void* cands[kMaxSides] = {cand0, cand1};
  bool vec_in = w % 16 == 0, vec_out = w % 4 == 0;
  for (int s = 0; s < nsides; ++s) {
    sd.img[s] = static_cast<const uint8_t*>(imgs[s]);
    sd.codes[s] = static_cast<int32_t*>(codes[s]);
    sd.cand[s] = static_cast<uint8_t*>(cands[s]);
    vec_in = vec_in && aligned16(imgs[s]);
    vec_out = vec_out && aligned16(codes[s]) && aligned16(cands[s]);
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH,
                  batch * nsides);
  fused_codes_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sd, nsides, h, w, vec_in, vec_out, Tile::strip_tests(t), thr2);
  return static_cast<int>(cudaGetLastError());
}
