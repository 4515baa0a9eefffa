// Stereo SAD slide for sub-pixel refinement (kernel 3 of the stereo
// frontend).
//
// Replaces the TPU kernel iv_slam_tpu/ops/stereo_pallas.py::_sad_kernel
// (sad_windows_pallas). Same function as the plain version
// iv_slam_tpu_torch/ops/stereo_cuda.py::sad_windows_plain, bit for bit: for
// keypoint k with window centers (yc, xl, xr) and each inc in 0..10,
//   out[k, inc] = sum over the 11x11 window of
//                 |(IL - IL[5,5]) - (IR[:, inc:inc+11] - IR[5, 5+inc])|,
// where IL is the left patch centred at (yc, xl) and IR the 11x21 right
// strip centred at (yc, xr).
//
// Exact packed arithmetic. Each term is computed as |(a + cR) - (b + cL)|,
// with a a left pixel, b a right pixel, cL = IL[5,5] and cR = IR[5, 5+inc].
// Both operands lie in [0, 510], so two columns of a row share a word as its
// 16-bit halves (columns 0,2,..,10 in the low halves, 1,3,..,9 in the high
// ones; column 10's pair has 0 in both high halves). A DPX add-max and
// add-min give max(a + cR, b + cL) and min(...) per half, and max - min is
// |.| per half with no borrow between the halves. A slide's packed sum adds,
// per half, at most 6 columns x 11 rows x 510 = 33,660 < 2^16, so the low
// half never carries into the high one; the two halves add to at most
// 121 x 510 = 61,710 < 2^16, exact in the uint32 and in the float32 it is
// written as. No step rounds. tests/test_torch_stereo.py emulates this
// arithmetic in numpy and asserts both ceilings.
//
// What bounds it on the H100: the work is tiny. Only the windows are read,
// 0.55 MB of distinct canvas bytes at KITTI size (2000 keypoints), plus the
// centers and 2000 x 11 floats written: ~0.16 us at 3.35 TB/s; the
// 2000 x 11 x 121 terms take less at 67 T/s (chip_smoke.py computes the
// bound from the run's centers). What a launch really costs is far above
// that: the device time of a launch itself with this grid (an empty kernel;
// PERF.md gives it), one round of L2 latency for the centers and one for the
// windows (the pyramid kernels have just written the canvases, so they sit
// in L2), and ~270 integer instructions to run a window row (2000 x
// 11 rows share the 132 SMs, whose integer pipes take 64 lanes a clock).
//
// Design, against those:
//  * 16 keypoints a block, 176 threads: 2000 keypoints are 125 blocks, one
//    even wave over the 132 SMs.
//  * One round of window latency. Thread (keypoint, row) loads its
//    keypoint's centers and finds where its left row of 11 bytes and its
//    right row of 21 bytes begin; then every thread starts its 10
//    word loads before using any: the 4 and 6 aligned 4-byte words around
//    each left and right row (110 words a keypoint), neighbouring threads on
//    neighbouring words of a row. Words are aligned on the flat byte
//    address, not per row: the right canvas is a view at any byte offset
//    (canvas[1] of the (2, R, C) pyramid canvas, R*C = 3 mod 4 at KITTI
//    size) and the pitch is odd, so no row starts aligned.
//  * No load leaves the tensor. A word that reaches outside [base, base +
//    H*W) of its canvas (before the first row of a misaligned canvas, or past
//    the end of its last row) is read byte by byte, and its bytes outside
//    are 0; they are never used, since the window bytes lie inside.
//  * The words go to shared memory (rows padded to 11 words: no bank
//    conflicts). Thread (keypoint, row) funnel-shifts its row into place,
//    forms the 16-bit pairs with byte permutes, and computes the row's term
//    sums for all 11 slides from registers: 6 packed terms a slide, 3
//    integer instructions a term. Every thread of the block is busy.
//  * The 11 row sums of each slide are added in shared memory (a keypoint's
//    rows straddle warps, so not by shuffles), and thread (keypoint, slide)
//    writes out[k, slide]: a block's 176 floats are one contiguous store.
//  * Centers are clamped to the window-safe range, a no-op for the caller's
//    pre-clipped centers and memory safety for any input.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HW = 5;                  // SAD half-window
constexpr int HL = 5;                  // slide half-range
constexpr int WIN = 2 * HW + 1;        // 11 rows, 11 columns
constexpr int NINC = 2 * HL + 1;       // 11 slides
constexpr int STRIP = WIN + 2 * HL;    // 21 right columns
constexpr int LWORDS = 4;              // words around a left row (11 + 3 bytes)
constexpr int RWORDS = 6;              // words around a right row (21 + 3 bytes)
constexpr int ROW_STRIDE = LWORDS + RWORDS + 1;  // shared row pitch, odd
constexpr int KP = 16;                 // keypoints a block
constexpr int THREADS = KP * WIN;      // thread t: (keypoint, row), later (keypoint, slide)
static_assert(WIN == NINC, "thread t is (keypoint, row) and then (keypoint, slide)");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The aligned word at byte offset o of a canvas of n bytes (o may be
// negative); only its bytes inside [0, n) are read, the others are 0.
__device__ __forceinline__ uint32_t load_word(const uint8_t* base, int n, int o) {
  if ((unsigned)o <= (unsigned)(n - 4))
    return __ldg(reinterpret_cast<const uint32_t*>(base + o));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if ((unsigned)(o + j) < (unsigned)n) w |= (uint32_t)__ldg(base + o + j) << (8 * j);
  return w;
}

__global__ void __launch_bounds__(THREADS)
sad_windows_kernel(const uint8_t* __restrict__ cl, const uint8_t* __restrict__ cr,
                   int H, int W, const int* __restrict__ yc_in,
                   const int* __restrict__ xl_in, const int* __restrict__ xr_in,
                   int N, float* __restrict__ out) {
  __shared__ int first[2][THREADS];               // offset of each row's first word
  __shared__ uint32_t stage[THREADS][ROW_STRIDE];  // words 0-3 left row, 4-9 right row
  __shared__ uint32_t red[KP][NINC][WIN];          // packed row sums by slide
  const int t = threadIdx.x;
  const int k0 = blockIdx.x * KP;
  const int n = H * W;

  // thread (kp, r): its keypoint's centers (the 11 threads of a keypoint
  // read the same words), where its window rows begin, and their bytes'
  // offsets inside the first aligned word
  const int kp = t / WIN, r = t - kp * WIN;
  const int k = min(k0 + kp, N - 1);
  const int row = clampi(yc_in[k], HW, H - HW - 1) - HW + r;
  const int ol = row * W + clampi(xl_in[k], HW, W - HW - 1) - HW;
  const int orr = row * W + clampi(xr_in[k], HW + HL, W - HW - HL - 1) - HW - HL;
  const unsigned sl = (unsigned)(reinterpret_cast<uintptr_t>(cl + ol) & 3);
  const unsigned sr = (unsigned)(reinterpret_cast<uintptr_t>(cr + orr) & 3);
  first[0][t] = ol - (int)sl;
  first[1][t] = orr - (int)sr;
  __syncthreads();

  // ---- every window load of the block, all started before any is used ---
  uint32_t lwd[LWORDS], rwd[RWORDS];
#pragma unroll
  for (int i = 0; i < LWORDS; ++i) {  // item q: word q % 4 of row q / 4
    const unsigned q = t + THREADS * i;
    lwd[i] = load_word(cl, n, first[0][q / LWORDS] + 4 * (int)(q % LWORDS));
  }
#pragma unroll
  for (int i = 0; i < RWORDS; ++i) {
    const unsigned q = t + THREADS * i;
    rwd[i] = load_word(cr, n, first[1][q / RWORDS] + 4 * (int)(q % RWORDS));
  }
#pragma unroll
  for (int i = 0; i < LWORDS; ++i) {
    const unsigned q = t + THREADS * i;
    stage[q / LWORDS][q % LWORDS] = lwd[i];
  }
#pragma unroll
  for (int i = 0; i < RWORDS; ++i) {
    const unsigned q = t + THREADS * i;
    stage[q / RWORDS][LWORDS + q % RWORDS] = rwd[i];
  }
  __syncthreads();

  // ---- thread (kp, r): row r of keypoint kp, all 11 slides ---------------
  {
    // the centers: byte 5 of left row 5, bytes 5 + inc of right row 5
    const int d5 = (HW - r) * W;
    const unsigned sl5 = (unsigned)(reinterpret_cast<uintptr_t>(cl + ol + d5) & 3);
    const unsigned sr5 = (unsigned)(reinterpret_cast<uintptr_t>(cr + orr + d5) & 3);
    const uint8_t* row5 = reinterpret_cast<const uint8_t*>(stage[kp * WIN + HW]);
    const uint32_t cL = row5[sl5 + HW];
    uint32_t cR[NINC];
#pragma unroll
    for (int inc = 0; inc < NINC; ++inc) cR[inc] = row5[4 * LWORDS + sr5 + HW + inc];

    const uint32_t* st = stage[t];
    uint32_t lw[3], rw[RWORDS];  // the row's bytes from column 0, 4 a word
#pragma unroll
    for (int i = 0; i < 3; ++i) lw[i] = __funnelshift_r(st[i], st[i + 1], 8 * sl);
#pragma unroll
    for (int i = 0; i < RWORDS - 1; ++i)
      rw[i] = __funnelshift_r(st[LWORDS + i], st[LWORDS + i + 1], 8 * sr);
    rw[RWORDS - 1] = st[LWORDS + RWORDS - 1] >> (8 * sr);

    // left pairs (a_2j, a_2j+1) as 16-bit halves; pair 5 is (a_10, 0)
    uint32_t lp[6];
#pragma unroll
    for (int j = 0; j < 5; ++j) lp[j] = __byte_perm(lw[j >> 1], 0u, (j & 1) ? 0x4342u : 0x4140u);
    lp[5] = __byte_perm(lw[2], 0u, 0x4442u);
    // right pairs + cL in each half: even e[m] = (b_2m, b_2m+1), odd
    // o[m] = (b_2m+1, b_2m+2)
    const uint32_t cL2 = cL * 0x10001u;
    uint32_t e[(STRIP + 1) / 2], o[STRIP / 2];
#pragma unroll
    for (int m = 0; m < (STRIP + 1) / 2; ++m)
      e[m] = __byte_perm(rw[m >> 1], 0u, (m & 1) ? 0x4342u : 0x4140u);
#pragma unroll
    for (int m = 0; m < STRIP / 2; ++m) o[m] = __byte_perm(e[m], e[m + 1], 0x5432u) + cL2;
#pragma unroll
    for (int m = 0; m < (STRIP + 1) / 2; ++m) e[m] += cL2;

#pragma unroll
    for (int inc = 0; inc < NINC; ++inc) {
      uint32_t acc = 0;
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        // window columns 2j, 2j+1 of slide inc: strip columns inc + 2j, +1
        uint32_t y = (inc & 1) ? o[(inc >> 1) + j] : e[(inc >> 1) + j];
        uint32_t c = cR[inc] * 0x10001u;
        if (j == 5) {  // column 10 alone: both high halves 0
          y &= 0xffffu;
          c = cR[inc];
        }
        acc += __viaddmax_u16x2(lp[j], c, y) - __viaddmin_u16x2(lp[j], c, y);
      }
      red[kp][inc][r] = acc;
    }
  }
  __syncthreads();

  // ---- thread (kp, inc): the slide's 11 row sums, one float --------------
  {
    const int inc = r;
    uint32_t s = 0;
#pragma unroll
    for (int i = 0; i < WIN; ++i) s += red[kp][inc][i];
    if (k0 + kp < N) out[(size_t)k0 * NINC + t] = (float)((s & 0xffffu) + (s >> 16));
  }
}

}  // namespace

extern "C" int sad_windows_launch(const void* cl, const void* cr, int H, int W,
                                  const void* yc, const void* xl, const void* xr,
                                  int N, void* out, void* stream) {
  if (N <= 0) return 0;
  if (H < WIN || W < STRIP || (long long)H * W > 0x7fffffffLL || N > 0x7fffffff / NINC)
    return (int)cudaErrorInvalidValue;
  const int blocks = (N + KP - 1) / KP;
  sad_windows_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)cl, (const uint8_t*)cr, H, W, (const int*)yc,
      (const int*)xl, (const int*)xr, N, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" const char* ivt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
