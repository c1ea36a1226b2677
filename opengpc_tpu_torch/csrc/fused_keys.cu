// Fused key kernel: box blur, leaf codes and Sobel candidates in one pass,
// emitting the epipolar matcher's sentinel-packed sort keys, of whole
// images or of row slabs of a larger frame (slab mode).
//
// Replaces two TPU kernels: opengpc_tpu/ops/fused.py::_kernel_keys
// (wrapper fused_keys, math tile_codes_and_cand) and, in slab mode,
// ::_kernel_keys_slab (wrapper fused_keys_slab, the row-sharded frame's
// per-shard kernel).  For each pixel (y, x) of an (H, W) uint8 image:
//   smooth  = floor(box3x3 / 9), zero outside 1 <= y <= h-3, 2 <= x <= w-2
//   code    = T <= 32 tests smooth[p+i] > smooth[p+j] - tau, MSB-first
//   cand    = (sx^2 + sy^2 > thr^2) with C-truncating Sobel / 9, inside the
//             13-px margin
//   key     = cand ? code : sentinel_base + pos_base + x
//             (cand ? (code << pack_bits) | (pos_base + x) when pack_bits > 0)
//
// One launch writes both images of a batch of pairs: grid z runs over
// (pair, side), side s reading image s of the pair and writing columns
// [col[s], col[s] + W) of the (B, rows, Wout) key image with positions
// from pos[s]; a single image is the same launch with one side.
//
// Slab mode.  The output rows are frame rows [y0, y0 + rows) of an
// h_total-row frame, and each source image holds frame rows [y0 - halo,
// y0 + rows + halo): halo = 14 for a slab of the sharded frame (the top
// and bottom shards' halos are zero rows), while a whole image is y0 = 0,
// h_total = rows, halo = 0.  The tile stages its raw rows from that source
// window (StripTile::stage's src_row0, src_rows; zeros past it, which only
// the last partial tile reads, for rows it does not write), and the box
// border and the candidate margin stay in frame rows against h_total, so
// a slab's keys equal rows [y0, y0 + rows) of the whole frame's.  Both
// slabs of a shard take one launch, as both images of a pair do.
//
// Bound on the H100.  Device memory sees 1 byte read and 4 written a pixel:
// 4.5 MB for a 436x1024 pair, 1.3 us at 3.35 TB/s.  The math, counted in
// StripTile's two-lane form (chip_smoke.py's code_ops), is ~29 integer
// operations a pixel for the box, the Sobel and the key, and for a
// candidate 1.5 a test and 7 to assemble its code: ~61 M for the dense
// pair at 30 tests, 3.7 us at the card's INT32 instruction rate.  So
// integer instructions bound it, and what the design does is cut
// operations a pixel.  A slab pair of the n = 1 frame (436 rows and 14
// zero halo rows each side) has the same bound.
//
// Design (tile_codes.cuh's StripTile).  One block of 256 threads makes a
// 32x64 output tile: it stages the (60, 96) raw window with 16-byte loads,
// blurs the (58, 92) code-support region separably (a horizontal 3-sum of
// two 16-bit lanes a word, rolled into vertical 3-sums) into two lane-shifted
// copies, and after one barrier each thread makes two strips of 4 pixels
// (rows ty and ty + 16).  A strip's Sobel runs first; only a strip with a
// candidate evaluates its tests, each as two aligned word loads a tap and
// one add a word of two pixels (exact for every tau, see StripTile).  Keys
// leave as one 16-byte store where the key image's row allows, else
// scalar stores.  At 436x1024 a pair is 448 blocks, one wave, and takes
// 12.5 us on an H100, ~3.4x its bound (chip_smoke.py, PERF.md); the slab
// pair of the n = 1 frame is the same 448 blocks in 12.7 us (its bound
// the same 3.7 us; chip_smoke.py's slab_census_times).  ptxas: 32 registers,
// 27,568 bytes of shared memory, no spills.  The kernel allocates nothing
// and runs on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

#include "tile_codes.cuh"

namespace {

using ogpc::StripTests;
using Tile = ogpc::StripTile<32, 64>;

constexpr int kTileH = 32;
constexpr int kTileW = 64;
constexpr int kStrips = kTileW / 4;        // strips a tile row
constexpr int kThreads = kStrips * 16;     // two tile rows a thread
constexpr int kMaxSides = 2;

struct Sides {
  const uint8_t* img[kMaxSides];
  int col[kMaxSides];
  int pos[kMaxSides];
  bool vec_out[kMaxSides];  // 16-byte stores land aligned
};

__global__ void __launch_bounds__(kThreads)
fused_keys_kernel(const __grid_constant__ Sides sides, int nsides,
                  int32_t* __restrict__ out, int rows, int w, int y0,
                  int h_total, int halo, int out_row_stride,
                  long long out_batch_stride, bool vec_in,
                  const __grid_constant__ StripTests tests, int thr2,
                  int sentinel_base, int pack_bits) {
  __shared__ Tile tile;

  const int s = blockIdx.z % nsides;
  const int b = blockIdx.z / nsides;
  const int r0 = blockIdx.y * kTileH;  // the tile's first output row
  const int x0 = blockIdx.x * kTileW;
  const int src_rows = rows + 2 * halo;
  tile.stage(sides.img[s] + static_cast<size_t>(b) * src_rows * w,
             y0 - halo, src_rows, h_total, w, y0 + r0, x0, vec_in,
             threadIdx.x, kThreads);

  const int sx = threadIdx.x % kStrips;
  const int x = x0 + 4 * sx;
  if (x >= w) return;
  int32_t* dst_b = out + b * out_batch_stride + sides.col[s] + x;
  const int pos = sides.pos[s] + x;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ty = threadIdx.x / kStrips + 16 * half;
    const int r = r0 + ty;
    if (r >= rows) break;
    const unsigned cand = tile.cands(ty, sx, y0 + r, x, h_total, w, thr2);
    uint32_t code[4] = {0, 0, 0, 0};
    if (cand) tile.codes(tile.base(ty, sx), tests, code);
    int32_t key[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (!(cand >> p & 1))
        key[p] = sentinel_base + pos + p;
      else if (pack_bits)
        key[p] = static_cast<int32_t>((code[p] << pack_bits) |
                                      static_cast<uint32_t>(pos + p));
      else
        key[p] = static_cast<int32_t>(code[p]);
    }
    int32_t* dst = dst_b + static_cast<size_t>(r) * out_row_stride;
    if (sides.vec_out[s] && x + 4 <= w) {
      *reinterpret_cast<int4*>(dst) = make_int4(key[0], key[1], key[2],
                                                key[3]);
    } else {
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (x + p < w) dst[p] = key[p];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// Keys of a batch of uint8 images, one or two sides: side s (img1 ==
// nullptr for one side) into columns [col_s, col_s + w) of the int32
// output with the given row and batch strides, positions pos_s + x.  The
// output rows are frame rows [y0, y0 + rows) of an h_total-row frame; each
// image of a side holds frame rows [y0 - halo, y0 + rows + halo), w bytes
// each, and the images of a batch follow one another (a whole image: y0 =
// 0, h_total = rows, halo = 0).  tests: host array of n_tests * (iy, ix,
// jy, jx, tau).  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ogpc_fused_keys(const void* img0, const void* img1, void* out,
                               int batch, int rows, int w, int y0,
                               int h_total, int halo, int out_row_stride,
                               int out_batch_stride, int col0, int col1,
                               int pos0, int pos1, const void* tests,
                               int n_tests, int thr2, int sentinel_base,
                               int pack_bits, void* stream) {
  ogpc::Tests t;
  const int nsides = img1 ? 2 : 1;
  if (!ogpc::load_tests(tests, n_tests, &t) || !img0 || batch < 0 ||
      rows < 0 || w < 0 || y0 < 0 || y0 + rows > h_total || halo < 0 ||
      pack_bits < 0 || pack_bits > 30 || batch * nsides > 65535 ||
      col0 < 0 || col0 + w > out_row_stride ||
      (img1 && (col1 < 0 || col1 + w > out_row_stride)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || rows == 0 || w == 0) return 0;
  Sides sd{};
  const void* imgs[kMaxSides] = {img0, img1};
  const int cols[kMaxSides] = {col0, col1};
  const int poss[kMaxSides] = {pos0, pos1};
  bool vec_in = w % 16 == 0;
  for (int s = 0; s < nsides; ++s) {
    sd.img[s] = static_cast<const uint8_t*>(imgs[s]);
    sd.col[s] = cols[s];
    sd.pos[s] = poss[s];
    sd.vec_out[s] = aligned16(out) && out_row_stride % 4 == 0 &&
                    out_batch_stride % 4 == 0 && cols[s] % 4 == 0;
    vec_in = vec_in && aligned16(imgs[s]);
  }
  const StripTests st = Tile::strip_tests(t);
  const dim3 grid((w + kTileW - 1) / kTileW, (rows + kTileH - 1) / kTileH,
                  batch * nsides);
  fused_keys_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      sd, nsides, static_cast<int32_t*>(out), rows, w, y0, h_total, halo,
      out_row_stride, out_batch_stride, vec_in, st, thr2, sentinel_base,
      pack_bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ogpc_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
