// FAST-9/16 corner scores of every pyramid level of a frame in one launch
// (kernel 1 of the stereo frontend).
//
// Replaces the TPU kernel iv_slam_tpu/ops/fast_pallas.py::_fast_score_kernel
// (fast_score_pallas). Same function as the plain version
// iv_slam_tpu_torch/ops/fast.py::fast_score, bit for bit, for each level:
// for each pixel the 16 Bresenham ring differences d = ring - center (ring
// order of fast.py CIRCLE), the max over the 16 circular 9-arcs of the arc
// minimum, for bright (d) and dark (-d); score = max(bright, dark) - 1, set
// to 0 below the threshold; a 3-pixel border is 0. No non-max suppression.
//
// Bound on the H100: a KITTI frame (2 images x 8 levels, 2.89 Mpx) reads
// 2.89 MB and writes 5.78 MB, 2.6 us at 3.35 TB/s. The least work we know
// is 120 two-input operations a pixel, counted from the ring bytes: the
// bright score is max over arcs of min(ring) - c, the dark one c - min over
// arcs of max(ring). The 16 circular 9-window minima take 42 operations
// (suffix and prefix runs inside ring halves 0-7 and 8-15, 26, then one
// minimum a window), and so do the maxima; then 15 maxima and 15 minima
// over the arcs, 2 differences with the center, and max, -1, compare and
// select (tests/test_torch_fast.py counts them). That is 5.2 us at 67 T/s.
// In practice the integer pipe bounds it: min/max (packed or not, two- or
// three-input), PRMT, LOP3 and IADD3 all issue on one pipe of 64 lanes an
// SM a clock; IMAD issues on another.
//
// Design, against that bound:
//  * one launch for all levels and both images: the levels' pointers,
//    shapes, first tile and tile-count reciprocals travel by value in the
//    kernel parameters (Levels); each block finds its level in the tile
//    prefix and its tile by multiply-high, not division;
//  * bright and dark differences ride as the two int16 halves of one word,
//    both biased by 0x6500 so that the low half never borrows from the
//    high one: (ring - c, c - ring) + 0x6500 is one IMAD from the pixels,
//    (c * 65535 + 0x6500 * 65537) - 65535 * ring, never a negation (CUDA
//    12.9's ptxas dropped a negation in an earlier form of the dark test).
//    The bias commutes with min and max and is taken off at the end;
//  * the 9-arc minima with Hopper's DPX three-input packed minima
//    (m3[k] = min d[k..k+2], m9[k] = min(m3[k], m3[k+3], m3[k+6])) and the
//    arc maximum as a tree of three-input packed maxima: 40 integer-pipe
//    instructions for both signs, against 79 for windows 2, 4, 8, 9 of
//    two-input ones (slower on the H100: PERF.md);
//  * a 128x8 tile: 256 threads, each scoring 4 horizontally adjacent
//    pixels from the tile plus its halo, staged once in shared memory as
//    bytes (14 rows x 136); a thread reads each ring byte with its own
//    shared byte load (a warp is one tile row: conflict-free), so the
//    bytes cost no integer-pipe extraction. Tiles clear of every edge take
//    a path with no bounds checks. Registers are capped at 32 so that 8
//    blocks fit an SM. TMA does not fit: level pitches (1241, 1034, 862,
//    ... bytes) are not multiples of 16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int PX = 4;                 // horizontally adjacent pixels a thread
constexpr int TX = 32, TY = 8;        // threads: one warp per tile row
constexpr int TW = TX * PX;           // output columns a tile
constexpr int TH = TY;                // 8 output rows a tile
constexpr int HALO = 3;
constexpr int SH = TH + 2 * HALO;     // 14 staged rows
constexpr int SWW = TW / 4 + 2;       // staged words a row: columns x0-4 .. x0+TW+3
constexpr int SWB = 4 * SWW;          // the same row in bytes
// Both halves of a difference word carry a bias of 0x6500, so they lie in
// 0x6401..0x65ff: positive as int16, and the low half never borrows from
// the high one.
constexpr uint32_t BIAS = 0x6500u;

struct Level {
  const uint8_t* img;  // (B, h, w)
  int16_t* out;        // (B, h, w)
  int h, w;
  int tiles_x, per_img;  // tiles a row, tiles an image
  uint32_t inv_x, inv_img;  // ceil(2^32 / tiles_x), ceil(2^32 / per_img)
  int tile0;           // first tile of this level
};

// t / d for d >= 1 from inv = ceil(2^32 / d): exact while t * d < 2^32
// (the entry point checks), two instructions instead of a division
__device__ __forceinline__ int div_by(int t, int d, uint32_t inv) {
  return d == 1 ? t : (int)__umulhi((uint32_t)t, inv);
}

struct Levels {
  Level l[MAX_LEVELS];
  int n;
  uint32_t keep_from;  // (threshold + BIAS + 1) << 16: a score word at or
                       // above it passes the threshold
};

// max over the 16 circular 9-arcs of the arc minimum, both halves
__device__ __forceinline__ uint32_t best_arc(const uint32_t (&d)[16]) {
  uint32_t m3[16], m9[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) m3[k] = __vimin3_s16x2(d[k], d[(k + 1) & 15], d[(k + 2) & 15]);
#pragma unroll
  for (int k = 0; k < 16; ++k) m9[k] = __vimin3_s16x2(m3[k], m3[(k + 3) & 15], m3[(k + 6) & 15]);
  // the maximum as a tree of depth 3
  uint32_t a[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) a[i] = __vimax3_s16x2(m9[3 * i], m9[3 * i + 1], m9[3 * i + 2]);
  return __vmaxs2(__vimax3_s16x2(a[0], a[1], a[2]), __vimax3_s16x2(a[3], a[4], m9[15]));
}

// ring - c and c - ring, + BIAS, in the two halves: cpack - 65535 * ring
// as one multiply-add (written in PTX: left to itself the compiler forms
// c - ring first, two instructions a ring pixel)
__device__ __forceinline__ uint32_t diff_pair(uint32_t ring, uint32_t cpack) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, 0xffff0001, %2;" : "=r"(d) : "r"(ring), "r"(cpack));
  return d;
}

// Scores the PX pixels of this thread from the staged tile: tb points at
// the thread's first ring byte of the center row (column xb - 4). kClear:
// every pixel of the tile lies in the image interior, so no checks.
template <bool kClear>
__device__ __forceinline__ void score_pixels(const uint8_t* tb, int16_t* orow, int xb, int W,
                                             bool row_in, uint32_t keep_from) {
  // the ring in the order of ops/fast.py CIRCLE, as (dy, dx)
  const int rdy[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  const int rdx[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const uint32_t c = tb[4 + p];
    const uint32_t cpack = c * 65535u + BIAS * 65537u;  // (c + BIAS, BIAS - c)
    uint32_t d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) d[k] = diff_pair(tb[rdy[k] * SWB + 4 + p + rdx[k]], cpack);
    const uint32_t best = best_arc(d);
    // max(bright, dark) + BIAS in both halves
    const uint32_t m = __vmaxs2(best, __byte_perm(best, 0u, 0x1032u));
    const int16_t score = (int16_t)(m - (BIAS + 1u));  // low half: the score
    bool keep = m >= keep_from;
    if (!kClear) {
      const int x = xb + p;
      keep = keep && row_in && x >= HALO && x < W - HALO;
      if (x < W) orow[p] = keep ? score : (int16_t)0;
    } else {
      orow[p] = keep ? score : (int16_t)0;
    }
  }
}

// 8 blocks an SM: at most 32 registers a thread
__global__ void __launch_bounds__(TX * TY, 8) fast_score_levels_kernel(const Levels L) {
  __shared__ uint32_t tile[SH][SWW];
  // this block's tile: the last level whose first tile is <= blockIdx.x,
  // the batch element, the tile's origin
  int t = (int)blockIdx.x;
  int li = 0;
  for (int i = 1; i < L.n; ++i) li = t >= L.l[i].tile0 ? i : li;
  const Level& lv = L.l[li];
  const int H = lv.h, W = lv.w;
  t -= lv.tile0;
  const int b = div_by(t, lv.per_img, lv.inv_img);
  t -= b * lv.per_img;
  const int ty0 = div_by(t, lv.tiles_x, lv.inv_x);
  const int x0 = (t - ty0 * lv.tiles_x) * TW, y0 = ty0 * TH;
  // an image has fewer than 2^31 pixels (the entry point checks), so
  // offsets within it are 32-bit
  const uint8_t* im = lv.img + (size_t)b * H * W;
  int16_t* o = lv.out + (size_t)b * H * W;

  // stage rows y0-3 .. y0+TH+2, columns x0-4 .. x0+TW+3, 4 bytes a word,
  // 0 outside the image: thread (tx, ty) stages rows ty and ty+8, words tx,
  // tx+32, ... A tile clear of every edge (then every pixel is interior)
  // skips all checks.
  const bool clear = x0 >= 4 && x0 + TW + 4 <= W && y0 >= HALO && y0 + TH + HALO <= H;
#pragma unroll
  for (int rr = 0; rr < (SH + TY - 1) / TY; ++rr) {
    const int sy = threadIdx.y + TY * rr;
    const int gy = y0 - HALO + sy;
    const uint8_t* row = im + gy * W;
#pragma unroll
    for (int ww = 0; ww < (SWW + TX - 1) / TX; ++ww) {
      const int sw = threadIdx.x + TX * ww;
      const int gx = x0 - 4 + 4 * sw;
      if (sy < SH && sw < SWW) {
        uint32_t by[4] = {0, 0, 0, 0};
        if (clear) {
#pragma unroll
          for (int j = 0; j < 4; ++j) by[j] = __ldg(row + gx + j);
        } else if (gy >= 0 && gy < H) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gx + j >= 0 && gx + j < W) by[j] = __ldg(row + gx + j);
        }
        tile[sy][sw] = __byte_perm(__byte_perm(by[0], by[1], 0x1140u),
                                   __byte_perm(by[2], by[3], 0x1140u), 0x5410u);
      }
    }
  }
  __syncthreads();

  const int y = y0 + threadIdx.y;
  const int xb = x0 + PX * threadIdx.x;
  const uint8_t* tb = reinterpret_cast<const uint8_t*>(&tile[threadIdx.y + HALO][0]) + PX * threadIdx.x;
  int16_t* orow = o + y * W + xb;
  if (clear) {
    score_pixels<true>(tb, orow, xb, W, true, L.keep_from);
  } else if (y < H && xb < W) {
    // columns past the image read staged zeros; only pixels inside are stored
    score_pixels<false>(tb, orow, xb, W, y >= HALO && y < H - HALO, L.keep_from);
  }
}

}  // namespace

// n levels of B images each: imgs[i] (B, hs[i], ws[i]) uint8 -> outs[i]
// the same shape in int16, in one launch on the given stream.
extern "C" int fast_score_levels_launch(const void* const* imgs, void* const* outs,
                                        const int* hs, const int* ws, int n, int B,
                                        int threshold, void* stream) {
  if (n < 0 || n > MAX_LEVELS || B < 0) return (int)cudaErrorInvalidValue;
  Levels L = {};
  L.n = n;
  // scores lie in -256 .. 254: thresholds outside -256 .. 255 act as the
  // nearest end of that range
  const int th = threshold < -256 ? -256 : (threshold > 255 ? 255 : threshold);
  L.keep_from = (uint32_t)(th + (int)BIAS + 1) << 16;
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    Level& lv = L.l[i];
    lv.img = (const uint8_t*)imgs[i];
    lv.out = (int16_t*)outs[i];
    lv.h = hs[i];
    lv.w = ws[i];
    const bool empty = hs[i] <= 0 || ws[i] <= 0 || B == 0;
    if (!empty && (long long)hs[i] * ws[i] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    lv.tiles_x = empty ? 0 : (ws[i] + TW - 1) / TW;
    lv.per_img = empty ? 0 : lv.tiles_x * ((hs[i] + TH - 1) / TH);
    lv.tile0 = (int)tiles;
    const long long n_lv = (long long)lv.per_img * B;
    if (n_lv * lv.per_img >= (1LL << 32)) return (int)cudaErrorInvalidValue;
    lv.inv_x = lv.tiles_x > 1 ? (uint32_t)(((1ULL << 32) + lv.tiles_x - 1) / lv.tiles_x) : 0;
    lv.inv_img = lv.per_img > 1 ? (uint32_t)(((1ULL << 32) + lv.per_img - 1) / lv.per_img) : 0;
    tiles += n_lv;
  }
  if (tiles == 0) return 0;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fast_score_levels_kernel<<<(unsigned)tiles, dim3(TX, TY), 0, (cudaStream_t)stream>>>(L);
  return (int)cudaGetLastError();
}

extern "C" const char* ivt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
