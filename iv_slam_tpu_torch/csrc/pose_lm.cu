// The motion-only pose LM in one launch (kernel 4, the tracking step's).
//
// Replaces no TPU kernel: the reference jits the LM into its tracking step
// (iv_slam_tpu/solvers/pose_opt.py), and the port ran it as ~11,800 eager
// PyTorch operations a call. Same function as the plain version
// iv_slam_tpu_torch/solvers/pose_opt.py::pose_optimization_plain on the
// card, bit for bit: n_rounds rounds of n_iters g2o-style Levenberg-
// Marquardt iterations over SE(3) from T0, MAX_TRIALS = 10 damped trials an
// iteration, the Huber kernel with quality-scaled delta on the first
// min(3, n_rounds - 1) rounds, each round's inliers reclassified by their
// unrobust chi2 against 5.991 (mono) / 7.815 (stereo).
//
// Rounding. This source is built with -fmad=false, so every product and
// sum below rounds on its own as the twin's eager CUDA operations do, in
// the twin's order: matrix products left to right, zero products included
// (they decide signs of zero). Roots, sines, cosines and divisions by a
// constant go through float64 and are rounded once (numerics.py); a
// division by a Python number is a product with its float64 reciprocal,
// as PyTorch's CUDA kernel takes it. The float32 constants are the twin's.
// H and g keep float32 rounding in numerics.tree_sum's fixed pairwise
// tree. The cost sums and the ten 6x6 solves are float64 in their own order
// and round to the twin's float32 except where a float64 result lies within
// its rounding error of a float32 tie.
//
// What bounds it on the H100: N = 1,536 edges read 58 KB and write 7.7 KB
// (17 ns at 3.35 TB/s); the arithmetic the LM needs, ~17,000 operations an
// edge over 40 iterations that each stop at their first trial (the 42
// products of 3 rows and one trial cost an iteration; chip_smoke.py counts
// the trials the LM takes on the main path's inputs), is 0.4 us at 67 T/s.
// What bounds the kernel is the chain: 40 iterations in order,
// each a normal-equation sum, ten solves, ten exponentials, ten costs and a
// choice, every step waiting on the one before. One block of 512 threads
// (128 registers a thread) on one SM runs it, with a __syncthreads between
// phases:
//  A  each edge's residual, IRLS weight and 3x6 Jacobian at the current
//     pose, written as 3 rows of 8 floats (J, e, w);
//  B  the 42 column sums of the rows' products in the twin's tree: the rows
//     are padded with zeros to P = 2^ceil(log2 3N); thread (warp w, lane l)
//     owns slot j = l * W + w of S = min(P, 512) slots and sums its rows
//     k * S + j (k < P / S) as the tree's top levels, then the lanes' tree
//     by shuffles (strides S/2 ... W), then, in shared memory, the warps'
//     (strides W/2 ... 1). Rows are stored at k * S + w * L + l, so a warp
//     reads 32 consecutive rows, with a spare place after every 32 so that
//     A's stores spread over the banks. The 42 columns go in three passes of
//     14 (H's rows a, a + 1 and g_a, g_a+1), which keeps the tree in
//     registers;
//  C  ten damped solves, one a group of 8 lanes (a row a lane, partial
//     pivoting by shuffles), then one lane a trial forms its gain, its
//     exponential and its pose;
//  D  the cost of trial 0, where most iterations stop; only when it does
//     not, the other nine (float64 sums: a trial after the stop is never
//     read, so the result is the ten trials');
//  E  the first trial at which the reference's trial loop ends, and the
//     new pose, lambda, ni and cost.
// Rows live in shared memory up to SMEM_EDGES edges (198 KB at 2,048);
// larger tables keep them in a scratch buffer the wrapper allocates.
// Measured on the H100 (PERF.md): 0.74 ms a call at 1,536 edges, where the
// eager twin takes 16.7 ms of device time in ~11,800 launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int LOG_NT = 9;
constexpr int NT = 1 << LOG_NT;        // threads of the block
constexpr int NWARP = NT / 32;
constexpr int PASS_ROWS = 2;           // rows of H (7 columns each) a pass of B sums
constexpr int PASS_COLS = 7 * PASS_ROWS;
constexpr int TRIALS = 10;             // MAX_TRIALS
constexpr int NCOL = 42;               // 36 of H, 6 of g
constexpr int SMEM_EDGES = 2048;       // rows in shared memory up to this N
constexpr int MAX_LOGM = 14 - LOG_NT;  // rows a slot: 3N <= 16,384 rows
constexpr int MAX_EDGES = (NT << MAX_LOGM) / 3;   // 5,461
constexpr unsigned FULL = 0xffffffffu;

constexpr float DELTA_MONO_SQ = 5.991f;
constexpr float DELTA_STEREO_SQ = 7.815f;

struct Args {
  const float* T0;                 // (4, 4)
  const float* Xw;                 // (N, 3)
  const float* obs;                // (N, 3) [u, v, u_r], u_r < 0 mono
  const float* inv_s2;             // (N,)
  const float* qual;               // (N,)
  const unsigned char* valid;      // (N,) bool
  const float* K[5];               // fx, fy, cx, cy, bf: 0-d device tensors
  int n, n_rounds, n_iters;
  int n_rows;                      // 3N
  int logS, logL, logW, logm;      // the tree's shape (see B above)
  int n_pos;                       // stored row positions
  float* T_out;
  unsigned char* inlier_out;
  float* chi2_out;
  int* n_out;
  float4* scratch;                 // rows when N > SMEM_EDGES
};

struct __align__(16) Shared {
  double cost_red[NWARP][TRIALS];  // per-warp cost sums
  float4 T0[4];
  float4 T[4];                     // the round's current pose
  float4 Tn[TRIALS][4];            // the trials' poses
  float red[6][NWARP][7];          // per-warp tree sums, pass a: H[a][0..5], g_a
  float H[36];
  float g[6];
  float dx[TRIALS][6];
  float gain[TRIALS];
  float lam_t[TRIALS];             // lambda of trial k
  float lam_next[TRIALS];          // lambda after k + 1 rejections
  float ni_next[TRIALS];           // ni after k + 1 rejections
  float chi_new[TRIALS];           // the trials' costs
  float K[5];
  float chi, lam, ni;
  int n_in;
  int pending;                     // trial 0 did not stop: cost the other nine
};

struct Cam {
  float fx, fy, cx, cy, bf;
};

__device__ __forceinline__ float sqrt64(float x) { return (float)sqrt((double)x); }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// e = obs - proj(T X) (pose_opt.py::_residuals); T as 3 float4 rows
__device__ __forceinline__ void residual(float4 r0, float4 r1, float4 r2, float X0, float X1,
                                         float X2, float o0, float o1, float o2, bool stereo,
                                         const Cam& K, float& p0, float& p1, float& p2,
                                         float& e0, float& e1, float& e2) {
  p0 = ((X0 * r0.x + X1 * r0.y) + X2 * r0.z) + r0.w;
  p1 = ((X0 * r1.x + X1 * r1.y) + X2 * r1.z) + r1.w;
  p2 = ((X0 * r2.x + X1 * r2.y) + X2 * r2.z) + r2.w;
  const float invz = 1.0f / p2;
  const float u = (K.fx * p0) * invz + K.cx;
  const float v = (K.fy * p1) * invz + K.cy;
  e0 = o0 - u;
  e1 = o1 - v;
  e2 = stereo ? o2 - (u - K.bf / p2) : 0.0f;
}

__device__ __forceinline__ float chi2_of(float is2, float e0, float e1, float e2) {
  return is2 * ((e0 * e0 + e1 * e1) + e2 * e2);
}

// g2o's Huber cost rho0 (_huber_rho0)
__device__ __forceinline__ float rho0(float c2, float dsq, float delta, bool on) {
  if (!on || c2 <= dsq) return c2;
  return (2.0f * delta) * sqrt64(clamp_min(c2, 1e-12f)) - dsq;
}

// the IRLS weight rho1 (_huber_w)
__device__ __forceinline__ float huber_w(float c2, float dsq, bool on) {
  if (!on || c2 <= dsq) return 1.0f;
  return sqrt64(dsq / clamp_min(c2, 1e-12f));
}

__device__ __forceinline__ float delta_sq_of(bool stereo, float q) {
  return ((stereo ? DELTA_STEREO_SQ : DELTA_MONO_SQ) * q) * q;
}

struct Edge {
  float X0, X1, X2, o0, o1, o2, is2, q;
  bool stereo;
};

__device__ __forceinline__ Edge load_edge(const Args& a, int i) {
  Edge e;
  e.X0 = __ldg(a.Xw + 3 * i);
  e.X1 = __ldg(a.Xw + 3 * i + 1);
  e.X2 = __ldg(a.Xw + 3 * i + 2);
  e.o0 = __ldg(a.obs + 3 * i);
  e.o1 = __ldg(a.obs + 3 * i + 1);
  e.o2 = __ldg(a.obs + 3 * i + 2);
  e.is2 = __ldg(a.inv_s2 + i);
  e.q = __ldg(a.qual + i);
  e.stereo = e.o2 >= 0.0f;
  return e;
}

// position q of the tree's order -> its place in memory: one spare place
// after every 32, so that a warp's stores of rows 3i + c (A) spread over the
// banks; a warp's 32 reads (B) stay contiguous
__host__ __device__ __forceinline__ int padded(int q) { return q + (q >> 5); }

// row r -> its position: slot j = l * W + w at k * S + w * L + l
__device__ __forceinline__ int row_pos(const Args& a, int r) {
  const int k = r >> a.logS, j = r & ((1 << a.logS) - 1);
  const int l = j >> a.logW, w = j & ((1 << a.logW) - 1);
  return padded((k << a.logS) | (w << a.logL) | l);
}

// ---- A: rows of the normal equations at the current pose -------------------
__device__ void build_rows(const Args& a, Shared& sh, const unsigned char* mask, float4* rows,
                           bool on, const Cam& K) {
  const float4 r0 = sh.T[0], r1 = sh.T[1], r2 = sh.T[2];
  for (int i = threadIdx.x; i < a.n; i += NT) {
    const Edge d = load_edge(a, i);
    float p0, p1, p2, e0, e1, e2;
    residual(r0, r1, r2, d.X0, d.X1, d.X2, d.o0, d.o1, d.o2, d.stereo, K, p0, p1, p2, e0,
             e1, e2);
    const float c2 = chi2_of(d.is2, e0, e1, e2);
    const float w = mask[i] ? huber_w(c2, delta_sq_of(d.stereo, d.q), on) * d.is2 : 0.0f;
    // J = Jproj @ [hat(pc) | -I] (_jacobian, camera.proj_jacobian_stereo)
    const float invz = 1.0f / p2;
    const float invz2 = invz * invz;
    const float j02 = ((-K.fx) * p0) * invz2;
    const float Jp[3][3] = {{K.fx * invz, 0.0f, j02},
                            {0.0f, K.fy * invz, ((-K.fy) * p1) * invz2},
                            {K.fx * invz, 0.0f, j02 + K.bf * invz2}};
    const float h[3][3] = {{0.0f, -p2, p1}, {p2, 0.0f, -p0}, {-p1, p0, 0.0f}};
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float J[6];
      if (c == 2 && !d.stereo) {
#pragma unroll
        for (int b = 0; b < 6; ++b) J[b] = 0.0f;
      } else {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          J[b] = (Jp[c][0] * h[0][b] + Jp[c][1] * h[1][b]) + Jp[c][2] * h[2][b];
          J[3 + b] = -Jp[c][b];
        }
      }
      const float ec = c == 0 ? e0 : (c == 1 ? e1 : e2);
      const int q = row_pos(a, 3 * i + c);
      rows[2 * q] = make_float4(J[0], J[1], J[2], J[3]);
      rows[2 * q + 1] = make_float4(J[4], J[5], ec, w);
    }
  }
}

// ---- B: the 42 column sums in numerics.tree_sum's order --------------------
struct TreeCtx {
  const float4* rows;
  int logS, j, q0, n_rows, a;
};

__device__ __forceinline__ float component(float4 u, float4 v, int b) {
  return b == 0 ? u.x : b == 1 ? u.y : b == 2 ? u.z : b == 3 ? u.w : b == 4 ? v.x : v.y;
}

// the products of the pass's rows a = c.a .. c.a + PASS_ROWS - 1 of H for
// the row at local index k: Jw[a] * J[b] (b < 6), Jw[a] * e
template <int M>
struct LocalTree {
  // the halves tree over k, k + step, ..., k + (M - 1) step: the evens'
  // tree plus the odds' tree
  static __device__ __forceinline__ void run(float out[PASS_COLS], const TreeCtx& c, int k,
                                             int step) {
    float x[PASS_COLS], y[PASS_COLS];
    LocalTree<M / 2>::run(x, c, k, 2 * step);
    LocalTree<M / 2>::run(y, c, k + step, 2 * step);
#pragma unroll
    for (int i = 0; i < PASS_COLS; ++i) out[i] = x[i] + y[i];
  }
};

template <>
struct LocalTree<1> {
  static __device__ __forceinline__ void run(float out[PASS_COLS], const TreeCtx& c, int k,
                                             int) {
    if ((k << c.logS) + c.j >= c.n_rows) {  // zero padding
#pragma unroll
      for (int i = 0; i < PASS_COLS; ++i) out[i] = 0.0f;
      return;
    }
    const int q = padded((k << c.logS) + c.q0);
    const float4 u = c.rows[2 * q], v = c.rows[2 * q + 1];
#pragma unroll
    for (int r = 0; r < PASS_ROWS; ++r) {
      const float jw = component(u, v, c.a + r) * v.w;
      out[7 * r] = jw * u.x;
      out[7 * r + 1] = jw * u.y;
      out[7 * r + 2] = jw * u.z;
      out[7 * r + 3] = jw * u.w;
      out[7 * r + 4] = jw * v.x;
      out[7 * r + 5] = jw * v.y;
      out[7 * r + 6] = jw * v.z;
    }
  }
};

// LocalTree<2^logm>, for logm <= log2(M)
template <int M>
__device__ __forceinline__ void local_tree(int logm, float out[PASS_COLS], const TreeCtx& c) {
  if constexpr (M > 1) {
    if ((1 << logm) < M) {
      local_tree<M / 2>(logm, out, c);
      return;
    }
  }
  LocalTree<M>::run(out, c, 0, 1);
}

__device__ void normal_sums(const Args& a, Shared& sh, const float4* rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp >= (1 << a.logW)) return;
  TreeCtx c{rows, a.logS, (lane << a.logW) | warp, (warp << a.logL) | lane, a.n_rows, 0};
  for (int g = 0; g < 6; g += PASS_ROWS) {
    c.a = g;
    float s[PASS_COLS];
    local_tree<1 << MAX_LOGM>(a.logm, s, c);
    for (int o = (1 << a.logL) >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < PASS_COLS; ++i) s[i] += __shfl_down_sync(FULL, s[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < PASS_COLS; ++i) sh.red[g + i / 7][warp][i % 7] = s[i];
    }
  }
}

// the warps' levels of the tree; g = -sum
__device__ void column_sums(const Args& a, Shared& sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = 1 << a.logW;
  for (int col = warp; col < NCOL; col += NWARP) {
    const int g = col < 36 ? col / 6 : col - 36, i = col < 36 ? col % 6 : 6;
    float v = lane < W ? sh.red[g][lane][i] : 0.0f;
    for (int o = W >> 1; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
    if (lane == 0) {
      if (col < 36) sh.H[col] = v;
      else sh.g[col - 36] = -v;
    }
  }
}

// ---- C: ten damped solves, gains and trial poses ---------------------------

// SE(3) exponential of dx times T (se3.se3_exp, numerics.matmul)
__device__ void exp_times(const float dx[6], const Shared& sh, float4 out[4]) {
  const float w0 = dx[0], w1 = dx[1], w2 = dx[2];
  const float th2 = (w0 * w0 + w1 * w1) + w2 * w2;
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float W2[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      W2[i][j] = (W[i][0] * W[0][j] + W[i][1] * W[1][j]) + W[i][2] * W[2][j];
  const float theta = sqrt64(th2 + 1e-24f);
  float A, B, C;
  if (th2 < 1e-4f) {  // Taylor branches; x / c as x * (1 / c) in float64
    A = 1.0f - (float)((double)th2 * (1.0 / 6.0));
    B = 0.5f - (float)((double)th2 * (1.0 / 24.0));
    C = (float)(1.0 / 6.0) - (float)((double)th2 * (1.0 / 120.0));
  } else {
    A = (float)sin((double)theta) / theta;
    B = (1.0f - (float)cos((double)theta)) / th2;
    C = (1.0f - A) / th2;
  }
  float E[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      E[i][j] = (eye + A * W[i][j]) + B * W2[i][j];
      V[j] = (eye + B * W[i][j]) + C * W2[i][j];
    }
    E[i][3] = (V[0] * dx[3] + V[1] * dx[4]) + V[2] * dx[5];
  }
  float T[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T[i][0] = sh.T[i].x;
    T[i][1] = sh.T[i].y;
    T[i][2] = sh.T[i].z;
    T[i][3] = sh.T[i].w;
  }
  float o[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
      o[i][j] = ((E[i][0] * T[0][j] + E[i][1] * T[1][j]) + E[i][2] * T[2][j]) + E[i][3] * T[3][j];
    o[3][j] = ((0.0f * T[0][j] + 0.0f * T[1][j]) + 0.0f * T[2][j]) + 1.0f * T[3][j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
}

// threads 0..95: trial q = tid / 8 solves (H + lam_q I) dx = g with lane
// tid % 8 < 6 holding one row; LU with partial pivoting (the first row of
// largest magnitude), the right-hand side eliminated along, then back
// substitution. The group's first lane then forms the trial.
__device__ void solve_trials(Shared& sh, bool first) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int q = tid >> 3, rr = tid & 7, base = lane & ~7;
  const bool active = q < TRIALS && rr < 6;

  // the damping ladder (_damping_ladder): exact float64 products
  float lam0 = sh.lam, ni0 = sh.ni;
  if (first) {  // 1e-5 * max |diag H|, NaN kept
    float m = fabsf(sh.H[0]);
    for (int i = 1; i < 6; ++i) {
      const float v = fabsf(sh.H[7 * i]);
      m = (isnan(m) || v <= m) ? m : v;
    }
    lam0 = 1e-5f * m;
    ni0 = 2.0f;
  }
  double lamd = (double)lam0, nid = (double)ni0;
  for (int j = 0; j < q && j < TRIALS; ++j) {
    lamd *= nid;
    nid *= 2.0;
  }
  const float lam_q = (float)lamd;

  double A[6], b = 0.0, rdiag = 0.0;
  int pos = rr;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    A[j] = active ? (double)(sh.H[rr * 6 + j] + (rr == j ? lam_q : 0.0f)) : 0.0;
  if (active) b = (double)sh.g[rr];

#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const bool cand = active && pos >= k;
    double v = cand ? fabs(A[k]) : -1.0;
    int p = cand ? pos : 64;
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      const double ov = __shfl_xor_sync(FULL, v, o);
      const int op = __shfl_xor_sync(FULL, p, o);
      if (ov > v || (ov == v && op < p)) {
        v = ov;
        p = op;
      }
    }
    if (p > 5) p = k;
    if (active) {
      const int old = pos;
      if (old == k) pos = p;
      else if (old == p) pos = k;
    }
    const unsigned bal = __ballot_sync(FULL, active && pos == k);
    const int src = base + __ffs((bal >> base) & 0xffu) - 1;
    const double piv = __shfl_sync(FULL, A[k], src);
    double prow[6];
#pragma unroll
    for (int j = k + 1; j < 6; ++j) prow[j] = __shfl_sync(FULL, A[j], src);
    const double pb = __shfl_sync(FULL, b, src);
    const double rp = __drcp_rn(piv);
    if (pos == k) rdiag = rp;
    if (active && pos > k) {
      const double l = A[k] * rp;
      A[k] = l;
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[j] = fma(-l, prow[j], A[j]);
      b = fma(-l, pb, b);
    }
  }
#pragma unroll
  for (int k = 5; k >= 0; --k) {
    const unsigned bal = __ballot_sync(FULL, active && pos == k);
    const int src = base + __ffs((bal >> base) & 0xffu) - 1;
    if (active && pos == k) b = b * rdiag;
    const double xk = __shfl_sync(FULL, b, src);
    if (active && pos < k) b = fma(-A[k], xk, b);
  }
  if (active) sh.dx[q][pos] = (float)b;
  __syncwarp();

  if (q < TRIALS && rr == 0) {
    float dx[6];
    double gs = 0.0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      dx[i] = sh.dx[q][i];
      gs += (double)(dx[i] * ((lam_q * dx[i]) + sh.g[i]));
    }
    sh.gain[q] = (float)gs + 1e-3f;
    sh.lam_t[q] = lam_q;
    sh.lam_next[q] = (float)(lamd * nid);
    sh.ni_next[q] = (float)(nid * 2.0);
    exp_times(dx, sh, sh.Tn[q]);
  }
}

// ---- D: costs of nt poses, float64 sums per warp ---------------------------
__device__ void trial_costs(const Args& a, Shared& sh, const unsigned char* mask,
                            const float4 (*poses)[4], int nt, bool on, const Cam& K) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  double acc[TRIALS];
#pragma unroll
  for (int k = 0; k < TRIALS; ++k) acc[k] = 0.0;
  for (int i = threadIdx.x; i < a.n; i += NT) {
    if (!mask[i]) continue;
    const Edge d = load_edge(a, i);
    const float dsq = delta_sq_of(d.stereo, d.q);
    const float delta = on ? sqrt64(dsq) : 0.0f;
#pragma unroll
    for (int k = 0; k < TRIALS; ++k) {
      if (k < nt) {
        float p0, p1, p2, e0, e1, e2;
        residual(poses[k][0], poses[k][1], poses[k][2], d.X0, d.X1, d.X2, d.o0, d.o1, d.o2,
                 d.stereo, K, p0, p1, p2, e0, e1, e2);
        acc[k] += (double)rho0(chi2_of(d.is2, e0, e1, e2), dsq, delta, on);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < TRIALS; ++k) {
    if (k < nt) {
      double v = acc[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
      if (lane == 0) sh.cost_red[warp][k] = v;
    }
  }
}

// ---- E: the trial at which the reference's loop ends (warp 0) --------------

// the float64 cost sums of trials first .. first + nt - 1, rounded once
__device__ void sum_costs(Shared& sh, int first, int nt) {
  const int lane = threadIdx.x & 31;
  if (lane < nt) {
    double s = 0.0;
    for (int w = 0; w < NWARP; ++w) s += sh.cost_red[w][lane];
    sh.chi_new[first + lane] = (float)s;
  }
  __syncwarp();
}

// Of the first n_eval trials costed, the first at which the loop stops (or,
// all ten costed, the last) sets the new pose, lambda, ni and cost. Returns
// false while no costed trial stops: the rest must be costed first.
__device__ bool choose_trial(Shared& sh, int n_eval) {
  const int lane = threadIdx.x & 31;
  float chi_new = 0.0f, lam_good = 0.0f;
  bool good = false, stop = false;
  if (lane < n_eval) {
    chi_new = sh.chi_new[lane];
    const float rho = (sh.chi - chi_new) / sh.gain[lane];
    good = rho > 0.0f && isfinite(chi_new);
    stop = good || !(rho < 0.0f);
    const float t = 2.0f * rho - 1.0f;
    const float f = 1.0f - (t * t) * t;
    lam_good = sh.lam_t[lane] * (isnan(f) ? f : fminf(fmaxf(f, 1.0f / 3.0f), 2.0f / 3.0f));
  }
  const unsigned bal = __ballot_sync(FULL, stop);
  if (!bal && n_eval < TRIALS) return false;
  const int s = bal ? __ffs(bal) - 1 : TRIALS - 1;
  if (lane == s) {
    if (good) {
#pragma unroll
      for (int i = 0; i < 4; ++i) sh.T[i] = sh.Tn[s][i];
      sh.lam = lam_good;
      sh.ni = 2.0f;
      sh.chi = chi_new;
    } else {
      sh.lam = sh.lam_next[s];
      sh.ni = sh.ni_next[s];
    }
  }
  return true;
}

template <bool ROWS_SHARED>
__global__ void __launch_bounds__(NT, 1) pose_lm_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const size_t rows_bytes = ROWS_SHARED ? (size_t)a.n_pos * 32 : 0;
  float4* rows = ROWS_SHARED ? reinterpret_cast<float4*>(smem + sizeof(Shared)) : a.scratch;
  unsigned char* mask = smem + sizeof(Shared) + rows_bytes;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid < 4) {
    const float4 r = make_float4(a.T0[4 * tid], a.T0[4 * tid + 1], a.T0[4 * tid + 2],
                                 a.T0[4 * tid + 3]);
    sh.T0[tid] = r;
    sh.T[tid] = r;
  }
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 5; ++i) sh.K[i] = *a.K[i];
    sh.n_in = 0;
  }
  for (int i = tid; i < a.n; i += NT) mask[i] = a.valid[i] != 0;
  __syncthreads();
  const Cam K{sh.K[0], sh.K[1], sh.K[2], sh.K[3], sh.K[4]};

  for (int r = 0; r < a.n_rounds; ++r) {
    // the kernel is dropped after round min(2, n_rounds - 2)
    const bool on = r <= min(2, a.n_rounds - 2);
    if (tid < 4) sh.T[tid] = sh.T0[tid];
    __syncthreads();
    trial_costs(a, sh, mask, &sh.T, 1, on, K);
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int w = 0; w < NWARP; ++w) s += sh.cost_red[w][0];
      sh.chi = (float)s;
    }
    for (int it = 0; it < a.n_iters; ++it) {
      build_rows(a, sh, mask, rows, on, K);
      __syncthreads();
      normal_sums(a, sh, rows);
      __syncthreads();
      column_sums(a, sh);
      __syncthreads();
      if (tid < 96) solve_trials(sh, it == 0);
      __syncthreads();
      // trial 0 first: the loop stops there on most iterations, and the
      // other trials' costs are then never read
      trial_costs(a, sh, mask, sh.Tn, 1, on, K);
      __syncthreads();
      if (warp == 0) {
        sum_costs(sh, 0, 1);
        const bool done = choose_trial(sh, 1);
        if (lane == 0) sh.pending = !done;
      }
      __syncthreads();
      if (sh.pending) {
        trial_costs(a, sh, mask, sh.Tn + 1, TRIALS - 1, on, K);
        __syncthreads();
        if (warp == 0) {
          sum_costs(sh, 1, TRIALS - 1);
          choose_trial(sh, TRIALS);
        }
        __syncthreads();
      }
    }
    // reclassify every edge by its unrobust chi2 at the round's pose
    const bool last = r == a.n_rounds - 1;
    const float4 r0 = sh.T[0], r1 = sh.T[1], r2 = sh.T[2];
    int cnt = 0;
    for (int i = tid; i < a.n; i += NT) {
      const Edge d = load_edge(a, i);
      float p0, p1, p2, e0, e1, e2;
      residual(r0, r1, r2, d.X0, d.X1, d.X2, d.o0, d.o1, d.o2, d.stereo, K, p0, p1, p2, e0,
               e1, e2);
      const float c2 = chi2_of(d.is2, e0, e1, e2);
      const bool inl = a.valid[i] != 0 && c2 <= (d.stereo ? DELTA_STEREO_SQ : DELTA_MONO_SQ);
      mask[i] = inl;
      if (last) {
        a.chi2_out[i] = c2;
        a.inlier_out[i] = inl;
        cnt += inl;
      }
    }
    if (last) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(FULL, cnt, o);
      if (lane == 0 && cnt) atomicAdd(&sh.n_in, cnt);
    }
    __syncthreads();
  }
  if (a.n_rounds == 0) {  // no round: T0, the valid edges, chi2 0
    int cnt = 0;
    for (int i = tid; i < a.n; i += NT) {
      a.chi2_out[i] = 0.0f;
      a.inlier_out[i] = mask[i];
      cnt += mask[i];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(FULL, cnt, o);
    if (lane == 0 && cnt) atomicAdd(&sh.n_in, cnt);
    __syncthreads();
  }
  if (tid < 4) {
    const float4 r = sh.T[tid];
    a.T_out[4 * tid] = r.x;
    a.T_out[4 * tid + 1] = r.y;
    a.T_out[4 * tid + 2] = r.z;
    a.T_out[4 * tid + 3] = r.w;
  }
  if (tid == 0) *a.n_out = sh.n_in;
}

int ilog2(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

// row places the tree stores for n edges: min(P, ceil(3n / S) * S)
// positions, padded
int row_places(int n) {
  const int n_rows = 3 * n, logP = ilog2(n_rows);
  const int S = 1 << (logP < LOG_NT ? logP : LOG_NT);
  const int P = 1 << logP;
  const int up = (n_rows + S - 1) / S * S;
  return padded(up < P ? up : P);
}

}  // namespace

// Floats of scratch the wrapper allocates for a table of n edges: 0 while
// the rows fit in shared memory (n <= SMEM_EDGES), else 8 a row place; -1
// for a table the kernel does not take (n outside 1..MAX_EDGES).
extern "C" long long pose_lm_scratch_floats(int n) {
  if (n < 1 || n > MAX_EDGES) return -1;
  return n <= SMEM_EDGES ? 0 : 8LL * row_places(n);
}

extern "C" int pose_lm_launch(const void* T0, const void* Xw, const void* obs,
                              const void* inv_s2, const void* qual, const void* valid,
                              const void* fx, const void* fy, const void* cx, const void* cy,
                              const void* bf, int n, int n_rounds, int n_iters, void* T_out,
                              void* inlier_out, void* chi2_out, void* n_out, void* scratch,
                              long long scratch_floats, void* stream) {
  if (n < 1 || n > MAX_EDGES || n_rounds < 0 || n_iters < 1) return (int)cudaErrorInvalidValue;
  Args a;
  a.T0 = (const float*)T0;
  a.Xw = (const float*)Xw;
  a.obs = (const float*)obs;
  a.inv_s2 = (const float*)inv_s2;
  a.qual = (const float*)qual;
  a.valid = (const unsigned char*)valid;
  a.K[0] = (const float*)fx;
  a.K[1] = (const float*)fy;
  a.K[2] = (const float*)cx;
  a.K[3] = (const float*)cy;
  a.K[4] = (const float*)bf;
  a.n = n;
  a.n_rounds = n_rounds;
  a.n_iters = n_iters;
  a.n_rows = 3 * n;
  const int logP = ilog2(a.n_rows);
  a.logS = logP < LOG_NT ? logP : LOG_NT;
  a.logL = a.logS < 5 ? a.logS : 5;
  a.logW = a.logS - a.logL;
  a.logm = logP - a.logS;
  a.n_pos = row_places(n);
  a.T_out = (float*)T_out;
  a.inlier_out = (unsigned char*)inlier_out;
  a.chi2_out = (float*)chi2_out;
  a.n_out = (int*)n_out;
  a.scratch = (float4*)scratch;
  const bool in_shared = n <= SMEM_EDGES;
  if (!in_shared && (scratch == nullptr || scratch_floats < 8LL * a.n_pos))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(Shared) + (in_shared ? (size_t)a.n_pos * 32 : 0) + (size_t)n;
  void (*kern)(const Args) = in_shared ? pose_lm_kernel<true> : pose_lm_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, NT, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* ivt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
