// Fused IC orientation + rotated BRIEF per keypoint (kernel 2 of the
// stereo frontend).
//
// Replaces the TPU kernel iv_slam_tpu/ops/finish_pallas.py::_finish_kernel
// (patches_angles_pallas) together with the descriptor lookup that
// orient_brief_pallas ran after it outside the kernel
// (iv_slam_tpu/ops/brief.py::descriptors_from_patches). Same function as
// the plain versions iv_slam_tpu_torch/ops/orient.py::ic_angles_integral and
// ops/brief.py::descriptors_global_gather, bit for bit, for any keypoint
// position:
//   angle = cv fastAtan2(m01, m10) in degrees, with m10 = sum u*I and
//   m01 = sum v*I over the 31x31 circular umax patch of the raw canvas
//   (rows clamped to the canvas, columns outside it left out, as the plain
//   version's clamped prefix sums do);
//   bit i of the descriptor = blur[p(2i)] < blur[p(2i+1)], where
//   p(k) = (y + rint(px_k*sin + py_k*cos), x + rint(px_k*cos - py_k*sin)),
//   clamped to the canvas, packed LSB first into 32 bytes.
//
// Exactness: the moments are integers (|m| < 2^24, exact in f32). Every
// multiply, add and divide of fastAtan2 and of the pattern rotation is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which the compiler never contracts into an FMA, so the arithmetic is the
// same sequence of f32 roundings as the plain version's separate tensor ops.
// sincosf is the full-precision library function (never fast math: rint at
// .5 boundaries would flip bits).
//
// Bound on the H100: it reads only each keypoint's circular patch of the
// raw canvas and its 512 rotated pattern samples of the blurred one (2.38
// MB at KITTI size, where patches overlap) and writes 4000 x 36 bytes:
// ~0.7 us at 3.35 TB/s; ~5.8k operations a keypoint (23 M in all) take
// ~0.35 us at 67 T/s. chip_smoke.py computes the bound from the run's
// keypoints. The work is small; what costs is latency.
//
// Design, against latency: one warp per keypoint, 8 keypoints a block. Every global load of a keypoint is independent of the
// others and issued before any arithmetic:
//  * lane u (0..30) reads column u-15 of the raw patch, its 31 rows, into
//    registers (neighbouring lanes read neighbouring bytes); the circular
//    mask is symmetric (finish_cuda.py checks it), so lane u keeps the rows
//    |v| <= umax[|u|];
//  * the warp copies the blurred 37x37 window around the keypoint (the
//    rotated pattern reaches at most 18 px: finish_cuda.py checks the
//    pattern) into shared memory, 4 bytes a lane and step, rows and
//    columns clamped to the canvas as the plain version clamps its
//    indices; windows clear of the side edges read each word as two
//    aligned 4-byte loads and a funnel shift, without clamps. TMA
//    does not fit: the canvas pitch (1241 B) is no multiple of 16 and each
//    window starts at an arbitrary byte;
//  * the 512 pattern points are loaded once per block into shared memory as
//    floats, laid out so lane j's 16 points are conflict-free.
// Then the moments (column sums in int32, a butterfly across the warp; every
// lane computes the same angle), one sincosf, and lane j's 16 gathers from
// the shared window for descriptor byte j. Offsets are rounded half to even
// by adding 1.5 * 2^23 (exact for |v| < 2^22, the same integer as rintf),
// which keeps the rounding off the conversion pipe.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HALF_PATCH = 15;
constexpr int PATCH = 2 * HALF_PATCH + 1;  // 31
constexpr int REACH = 18;                  // |rint(rotated pattern offset)| <= 18
constexpr int WIN = 2 * REACH + 1;         // 37
constexpr int WIN_WORDS = 10;              // a window row: 40 bytes
constexpr int WIN_ITEMS = WIN * WIN_WORDS;  // 370 words a window
constexpr int WIN_STEPS = (WIN_ITEMS + 31) / 32;
constexpr int WARPS = 8;
static_assert(256 % (32 * WARPS) == 0, "threads share the 256 pattern pairs evenly");
constexpr float kRound = 12582912.0f;      // 1.5 * 2^23
constexpr int kRoundBits = 0x4B400000;     // its bit pattern

// cv::fastAtan2 coefficients (degrees) as the exact float32 values of
// ops/orient.py _P1.._P7 and _DBL_EPS, and ops/brief.py _FACTOR_PI
constexpr float kP1 = 0x1.ca44dcp+5f;       // 57.2836227
constexpr float kP3 = -0x1.2aaddcp+4f;      // -18.6674461
constexpr float kP5 = 0x1.1d3f7ep+3f;       // 8.91400051
constexpr float kP7 = -0x1.4515b2p+1f;      // -2.53972459
constexpr float kDblEps = 0x1p-52f;         // 2.22044605e-16
constexpr float kFactorPi = 0x1.1df46ap-6f;  // float32(pi / 180)

__device__ __forceinline__ float fast_atan2_deg(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float c_lo = __fdiv_rn(ay, __fadd_rn(ax, kDblEps));
  const float c_hi = __fdiv_rn(ax, __fadd_rn(ay, kDblEps));
  const float c = ax >= ay ? c_lo : c_hi;
  const float c2 = __fmul_rn(c, c);
  float poly = __fadd_rn(__fmul_rn(kP7, c2), kP5);
  poly = __fadd_rn(__fmul_rn(poly, c2), kP3);
  poly = __fadd_rn(__fmul_rn(poly, c2), kP1);
  poly = __fmul_rn(poly, c);
  float a = ax >= ay ? poly : __fsub_rn(90.0f, poly);
  if (x < 0.0f) a = __fsub_rn(180.0f, a);
  if (y < 0.0f) a = __fsub_rn(360.0f, a);
  return a;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// rint(v) for |v| < 2^22: round half to even, as rintf
__device__ __forceinline__ int rint_small(float v) {
  return __float_as_int(__fadd_rn(v, kRound)) - kRoundBits;
}

__global__ void __launch_bounds__(32 * WARPS)
orient_brief_kernel(const uint8_t* __restrict__ raw, const uint8_t* __restrict__ blur,
                    int R, int W, const int* __restrict__ yx, int N,
                    const uint32_t* __restrict__ pattern,  // 256 pairs (x0, y0, x1, y1) int8
                    const int* __restrict__ extents,       // (31,) umax[|u|], u = -15..15
                    float* __restrict__ ang_out, uint8_t* __restrict__ desc_out) {
  __shared__ float pat[8][4][32];  // pair 8j + t of lane j: [t][x0, y0, x1, y1][j]
  __shared__ int ext[PATCH];
  __shared__ uint32_t win[WARPS][WIN][WIN_WORDS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * WARPS + warp;
  const bool live = k < N;  // the same for the whole warp

  // ---- every global load first ------------------------------------------
  uint32_t pairs[256 / (32 * WARPS)];
#pragma unroll
  for (int i = 0; i < 256 / (32 * WARPS); ++i) pairs[i] = pattern[threadIdx.x + 32 * WARPS * i];
  const int e = threadIdx.x < PATCH ? extents[threadIdx.x] : 0;
  int y = 0, x = 0;
  int col[PATCH];                 // raw patch column lane - 15, rows -15..15
  uint32_t words[WIN_STEPS];      // blurred window words lane + 32 s
  if (live) {
    y = yx[2 * k];
    x = yx[2 * k + 1];
    const int cx = x + lane - HALF_PATCH;
    const bool in = lane < PATCH && cx >= 0 && cx < W;
#pragma unroll
    for (int v = 0; v < PATCH; ++v)
      col[v] = in ? raw[clampi(y + v - HALF_PATCH, 0, R - 1) * W + cx] : 0;
    // a window clear of the side edges reads each of its words as the two
    // aligned words around it: bytes c0-3 .. c0+7 of the row, inside it
    const bool clear = x >= REACH + 3 && x + 4 * WIN_WORDS - REACH + 4 <= W;
#pragma unroll
    for (int s = 0; s < WIN_STEPS; ++s) {
      const int i = lane + 32 * s;
      uint32_t word = 0;
      if (i < WIN_ITEMS) {
        const int r = i / WIN_WORDS, c0 = x - REACH + 4 * (i - r * WIN_WORDS);
        const uint8_t* row = blur + clampi(y - REACH + r, 0, R - 1) * W;
        if (clear) {
          const uintptr_t a = reinterpret_cast<uintptr_t>(row + c0);
          const uint32_t* wp = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
          word = __funnelshift_r(__ldg(wp), __ldg(wp + 1), 8 * (unsigned)(a & 3));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) word |= (uint32_t)row[clampi(c0 + j, 0, W - 1)] << (8 * j);
        }
      }
      words[s] = word;
    }
  }
#pragma unroll
  for (int i = 0; i < 256 / (32 * WARPS); ++i) {
    const int q = threadIdx.x + 32 * WARPS * i;  // pair q = 8j + t
#pragma unroll
    for (int c = 0; c < 4; ++c) pat[q & 7][c][q >> 3] = (float)(int8_t)(pairs[i] >> (8 * c));
  }
  if (threadIdx.x < PATCH) ext[threadIdx.x] = e;
  if (live) {
    uint32_t* w = &win[warp][0][0];
#pragma unroll
    for (int s = 0; s < WIN_STEPS; ++s)
      if (lane + 32 * s < WIN_ITEMS) w[lane + 32 * s] = words[s];
  }
  __syncthreads();
  if (!live) return;

  // ---- intensity-centroid moments: lane u sums column u - 15 ------------
  const int u = lane - HALF_PATCH;
  const int eu = lane < PATCH ? ext[lane] : -1;  // rows |v| <= eu of column u
  int s = 0, sv = 0;
#pragma unroll
  for (int v = 0; v < PATCH; ++v) {
    const int dv = v - HALF_PATCH;
    if ((dv < 0 ? -dv : dv) <= eu) {
      s += col[v];
      sv += dv * col[v];
    }
  }
  int m01 = sv, m10 = u * s;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m01 += __shfl_xor_sync(0xffffffffu, m01, off);
    m10 += __shfl_xor_sync(0xffffffffu, m10, off);
  }
  const float ang = fast_atan2_deg(__int2float_rn(m01), __int2float_rn(m10));
  if (lane == 0) ang_out[k] = ang;

  // ---- rBRIEF: lane j builds byte j from pattern pairs 8j .. 8j+7 -------
  float sb, ca;
  sincosf(__fmul_rn(ang, kFactorPi), &sb, &ca);
  const uint8_t* wb = reinterpret_cast<const uint8_t*>(&win[warp][0][0]);
  unsigned byte = 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    int val[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float px = pat[t][2 * h][lane], py = pat[t][2 * h + 1][lane];
      const int dr = rint_small(__fadd_rn(__fmul_rn(px, sb), __fmul_rn(py, ca)));
      const int dc = rint_small(__fsub_rn(__fmul_rn(px, ca), __fmul_rn(py, sb)));
      val[h] = wb[(REACH + dr) * (4 * WIN_WORDS) + REACH + dc];
    }
    byte |= (unsigned)(val[0] < val[1]) << t;
  }
  desc_out[k * 32 + lane] = (uint8_t)byte;
}

}  // namespace

extern "C" int orient_brief_launch(const void* raw, const void* blur, int R, int W,
                                   const void* yx, int N, const void* pattern,
                                   const void* extents, void* ang_out,
                                   void* desc_out, void* stream) {
  if (N <= 0) return 0;
  if ((long long)R * W > 0x7fffffffLL || N > 0x7fffffff / 32) return (int)cudaErrorInvalidValue;
  const int blocks = (N + WARPS - 1) / WARPS;
  orient_brief_kernel<<<blocks, 32 * WARPS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)raw, (const uint8_t*)blur, R, W, (const int*)yx, N,
      (const uint32_t*)pattern, (const int*)extents, (float*)ang_out,
      (uint8_t*)desc_out);
  return (int)cudaGetLastError();
}

extern "C" const char* ivt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
