// One block Lanczos step after its SpMM, for Hopper (sm_90a), bound to Python
// with ctypes (ops/block_mgs.py).
//
// It replaces no TPU kernel: the JAX package leaves these products to XLA
// (krylov_robustness_tpu/krylov/lanczos.py::lanczos_step, the einsums of its
// proj and _chol_qr). It was added because on the card the same products,
// left to cuBLAS as batched 2 x 2 GEMMs of depth n, ran at about 1% of the
// bytes they must move: one CTA a batch member, a 32 x 32 tile for a 2 x 2
// output, n unsplit, so a few hundred CTAs each walked n rows reading 8 bytes
// of every 400 or 2,000.
//
// What it computes. The blocks are n-major, (n, batch, bs): row r of member m
// is the bs values at ((r * batch) + m) * bs. With V_p = v_prev, V_c = v_cur
// and W = A V_c of one member, in the state's type T:
//   two MGS passes against the two-block window, each against what the pass
//   before produced:  H_p = V_p^T W,  H_c = V_c^T W,  W -= V_p H_p,
//   W -= V_c H_c, twice;
//   Cholesky QR with per-column deflation of the result: G = W^T W,
//   frob2 = trace G, ok = frob2 > eps^2, L = chol(G + (16 eps_T frob2 + eps^2) I)
//   (a pivot that is not positive, or NaN, breaks the member), keep_j =
//   L_jj^2 > 256 eps_T frob2, R = L^T with rows j not kept zeroed,
//   Q = W R^-1 with columns j not kept zeroed;
//   h = [H_p1 + H_p2; H_c1 + H_c2] (2bs x bs), zero where the member was not
//   alive; beta = R and Q zero where it is not alive after the step
//   (alive_next = alive && ok).
// ops/block_mgs.py::block_mgs_plain is the same step in torch.
//
// What bounds it on the H100: bytes. The Gram products are 2 bs^2 FMAs per
// row and member against 3 bs values read, far below the FFMA/DFMA peaks. The
// least traffic is four blocks (V_p, V_c and W read, Q written); the chain
// moves twelve: (a) reads V_p, V_c, W; (c) reads them again and rebuilds the
// first pass's W in registers; (e) reads them a third time, rebuilds both
// passes and writes W2; (g) reads W2 and writes Q over it. At Vermont's scale
// (n = 95,672) a block is 191 MB at batch 250 and 38 MB at batch 50 (f32,
// bs = 2), so no stage fits the 50 MB L2.
//
// Mapping. A CTA of 8 warps owns one slab of consecutive rows and one tile of
// 32 members; lane l owns member 32 * blockIdx.y + l, its bs values one
// vector load (float2 at bs = 2 in f32: a warp reads 256 contiguous bytes a
// row), and warp w walks rows r0 + w, r0 + w + 8, ... of the slab. The slab
// count is chosen by the wrapper so that about 4 CTAs an SM run whatever the
// batch (ops/block_mgs.py::plan). Gram sums run in f64 (DFMA; f32 values are
// widened first), are folded over the 8 warps in shared memory in warp order
// and written once a slab; a fold kernel, one warp a member, sums the slabs'
// partials lane-strided and then over the lanes by __shfl_down_sync, a fixed
// order. No atomics: two runs on one card give identical bits. Products and
// updates run in T with FFMA or DFMA; no tensor cores, TF32 or bf16.
//
// Launches of one step: (a) stream<0>, (b) fold, (c) stream<1>, (d) fold,
// (e) stream<2>, (f) factor, (g) apply_q. Every entry point launches on the
// given stream, allocates nothing and returns the first cudaGetLastError()
// that is not cudaSuccess (0 = success).
//
// Wide blocks (bs > 4: a joint edit's rescoring, the weighted objective and
// CONFIG 5 pass one member, or a few, of tens of columns) take a second
// chain with the same stages and the same arithmetic, in which the Gram
// products are true GEMMs: gram_wide splits the rows into slabs over CTAs,
// and each CTA sums one 32 x 32 tile of a member's coefficients (one warp a
// row of threads, four coefficients a thread) over its slab, 32 rows a round
// through shared memory; fold_wide sums the slabs in order, one thread a
// coefficient; rowmul_wide forms W1, W2 and Q a 32-row block and 32-column
// tile a CTA, the products over k in tiles of 32 in T; factor_wide is one
// CTA a member. W1 and W2 live in a block of the scratch. Launches: (a) gram,
// (b) fold, (c) rowmul (W1) and gram, (d) fold, (e) rowmul (W2) and gram,
// (f) factor (which folds G), (g) rowmul (Q): nine.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CHUNK = THREADS / 32;  // coefficients folded per smem round
constexpr unsigned FULL = 0xffffffffu;

// One member's bs values of a row: a vector load where bs * sizeof(T) is 8 or
// a multiple of 16 bytes (the wrapper passes 16-byte aligned blocks), scalar
// loads otherwise.
template <typename T, int BS>
struct RowIO {
  __device__ static void load(const T* p, T (&v)[BS]) {
#pragma unroll
    for (int k = 0; k < BS; ++k) v[k] = p[k];
  }
  __device__ static void store(T* p, const T (&v)[BS]) {
#pragma unroll
    for (int k = 0; k < BS; ++k) p[k] = v[k];
  }
};
template <>
struct RowIO<float, 2> {
  __device__ static void load(const float* p, float (&v)[2]) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
  __device__ static void store(float* p, const float (&v)[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <>
struct RowIO<float, 4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ static void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct RowIO<double, 2> {
  __device__ static void load(const double* p, double (&v)[2]) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x;
    v[1] = q.y;
  }
  __device__ static void store(double* p, const double (&v)[2]) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  }
};
template <>
struct RowIO<double, 4> {
  __device__ static void load(const double* p, double (&v)[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
  __device__ static void store(double* p, const double (&v)[4]) {
    reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
    reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
  }
};

__device__ __forceinline__ float madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double madd(double a, double b, double c) {
  return fma(a, b, c);
}

// x -= v C for one member's row (C is bs x bs, row k couples v_k): the
// product first, then the subtraction, as w - einsum(v, C) does.
template <typename T, int BS>
__device__ __forceinline__ void subtract(T (&x)[BS], const T (&v)[BS],
                                         T (&C)[BS][BS]) {
#pragma unroll
  for (int l = 0; l < BS; ++l) {
    T t = v[0] * C[0][l];
#pragma unroll
    for (int k = 1; k < BS; ++k) t = madd(v[k], C[k][l], t);
    x[l] = x[l] - t;
  }
}

// Gram coefficients a stage sums: 2 bs^2 for the projections ([H_p; H_c]
// row-major, as h is laid out), bs (bs + 1) / 2 for W2^T W2 (upper triangle,
// row by row).
template <int BS, int MODE>
__host__ __device__ constexpr int coefficients() {
  return MODE == 2 ? BS * (BS + 1) / 2 : 2 * BS * BS;
}

// The three streaming stages. MODE 0, (a): partials of V_p^T W and V_c^T W.
// MODE 1, (c): W1 = W - V_p H_p1 - V_c H_c1 in registers, partials of V_p^T W1
// and V_c^T W1. MODE 2, (e): W1, then W2 = W1 - V_p H_p2 - V_c H_c2, written
// to w2, partials of W2^T W2. part is (slabs, coefficients, batch) in f64.
// h1 and h2 hold each member's [H_p; H_c] in T.
template <typename T, int BS, int MODE>
__global__ void __launch_bounds__(THREADS, 4) stream_kernel(
    const T* __restrict__ vp, const T* __restrict__ vc,
    const T* __restrict__ w, T* __restrict__ w2, const T* __restrict__ h1,
    const T* __restrict__ h2, double* __restrict__ part, int n, int batch,
    int rows_per_slab) {
  constexpr int K = coefficients<BS, MODE>();
  __shared__ double red[WARPS][CHUNK][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int member = blockIdx.y * 32 + lane;
  const int slab = blockIdx.x;
  const int r0 = slab * rows_per_slab;
  const int r1 = min(n, r0 + rows_per_slab);

  double acc[K];
#pragma unroll
  for (int c = 0; c < K; ++c) acc[c] = 0.0;

  if (member < batch) {
    T c1[2][BS][BS], c2[2][BS][BS];
    if constexpr (MODE >= 1) {
#pragma unroll
      for (int i = 0; i < 2 * BS * BS; ++i)
        (&c1[0][0][0])[i] = h1[(size_t)member * 2 * BS * BS + i];
    }
    if constexpr (MODE == 2) {
#pragma unroll
      for (int i = 0; i < 2 * BS * BS; ++i)
        (&c2[0][0][0])[i] = h2[(size_t)member * 2 * BS * BS + i];
    }
#pragma unroll 4
    for (int r = r0 + warp; r < r1; r += WARPS) {
      const size_t off = ((size_t)r * batch + member) * BS;
      T a[BS], b[BS], x[BS];
      RowIO<T, BS>::load(vp + off, a);
      RowIO<T, BS>::load(vc + off, b);
      RowIO<T, BS>::load(w + off, x);
      if constexpr (MODE >= 1) {
        subtract<T, BS>(x, a, c1[0]);
        subtract<T, BS>(x, b, c1[1]);
      }
      if constexpr (MODE == 2) {
        subtract<T, BS>(x, a, c2[0]);
        subtract<T, BS>(x, b, c2[1]);
        RowIO<T, BS>::store(w2 + off, x);
        int c = 0;
#pragma unroll
        for (int k = 0; k < BS; ++k)
#pragma unroll
          for (int l = k; l < BS; ++l, ++c)
            acc[c] = fma((double)x[k], (double)x[l], acc[c]);
      } else {
#pragma unroll
        for (int k = 0; k < BS; ++k)
#pragma unroll
          for (int l = 0; l < BS; ++l) {
            acc[k * BS + l] = fma((double)a[k], (double)x[l], acc[k * BS + l]);
            acc[BS * BS + k * BS + l] =
                fma((double)b[k], (double)x[l], acc[BS * BS + k * BS + l]);
          }
      }
    }
  }

  // fold the 8 warps' sums, CHUNK coefficients a round: thread t sums
  // coefficient c0 + t / 32 of lane t % 32 over the warps in order
  const int c_of = threadIdx.x / 32;
  const int m_of = blockIdx.y * 32 + threadIdx.x % 32;
#pragma unroll
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
#pragma unroll
    for (int c = 0; c < CHUNK; ++c)
      if (c0 + c < K) red[warp][c][lane] = acc[c0 + c];
    __syncthreads();
    if (c0 + c_of < K && m_of < batch) {
      double s = red[0][c_of][threadIdx.x % 32];
#pragma unroll
      for (int v = 1; v < WARPS; ++v) s += red[v][c_of][threadIdx.x % 32];
      part[((size_t)slab * K + c0 + c_of) * batch + m_of] = s;
    }
    __syncthreads();
  }
}

// The sums over the slabs of one member's K coefficients, on lane 0: lane l
// adds slabs l, l + 32, ... in order (the K loads of a slab issued
// together), then the lanes fold by halves.
template <int K>
__device__ __forceinline__ void fold(const double* __restrict__ part,
                                     int slabs, int batch, int member,
                                     int lane, double (&s)[K]) {
#pragma unroll
  for (int c = 0; c < K; ++c) s[c] = 0.0;
#pragma unroll 4
  for (int sl = lane; sl < slabs; sl += 32) {
#pragma unroll
    for (int c = 0; c < K; ++c)
      s[c] += part[((size_t)sl * K + c) * batch + member];
  }
#pragma unroll
  for (int c = 0; c < K; ++c)
#pragma unroll
    for (int d = 16; d > 0; d /= 2) s[c] += __shfl_down_sync(FULL, s[c], d);
}

// (b), (d): one warp a member folds its 2 bs^2 projection coefficients and
// writes them in T to hk (batch, 2 bs, bs).
template <typename T, int BS>
__global__ void __launch_bounds__(THREADS) fold_kernel(
    const double* __restrict__ part, T* __restrict__ hk, int slabs,
    int batch) {
  constexpr int K = 2 * BS * BS;
  const int lane = threadIdx.x % 32;
  const int member = blockIdx.x * WARPS + threadIdx.x / 32;
  if (member >= batch) return;
  double s[K];
  fold<K>(part, slabs, batch, member, lane, s);
  if (lane != 0) return;
#pragma unroll
  for (int c = 0; c < K; ++c) hk[(size_t)member * K + c] = (T)s[c];
}

// (f): one warp a member folds G, then lane 0 factors it and writes h, beta,
// alive_next and the member's apply_q coefficients: R^-1 (bs x bs), keep (bs)
// and alive_next, in T.
template <typename T, int BS>
__global__ void __launch_bounds__(THREADS) factor_kernel(
    const double* __restrict__ part, const T* __restrict__ h1,
    const T* __restrict__ h2, const bool* __restrict__ alive,
    T* __restrict__ h, T* __restrict__ beta, bool* __restrict__ alive_next,
    T* __restrict__ qcoef, int slabs, int batch, T eps2, T c16, T c256) {
  constexpr int K = BS * (BS + 1) / 2;
  const int lane = threadIdx.x % 32;
  const int member = blockIdx.x * WARPS + threadIdx.x / 32;
  if (member >= batch) return;
  double g[K];
  fold<K>(part, slabs, batch, member, lane, g);
  if (lane != 0) return;

  T G[BS][BS];
  {
    int c = 0;
#pragma unroll
    for (int k = 0; k < BS; ++k)
#pragma unroll
      for (int l = k; l < BS; ++l, ++c) G[k][l] = G[l][k] = (T)g[c];
  }
  T frob2 = G[0][0];
#pragma unroll
  for (int k = 1; k < BS; ++k) frob2 = frob2 + G[k][k];
  bool ok = frob2 > eps2;
  const T reg = frob2 * c16 + eps2;

  // Cholesky of G + reg I, lower, column by column; a pivot that is not
  // positive (or NaN), or a NaN below it, breaks the member
  T L[BS][BS];
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) L[i][j] = T(0);
  bool bad = false;
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    T d = G[j][j] + reg;
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - L[j][k] * L[j][k];
    if (!(d > T(0))) bad = true;
    L[j][j] = sqrt(d);
#pragma unroll
    for (int i = j + 1; i < BS; ++i) {
      T s = G[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = s / L[j][j];
      if (isnan(L[i][j])) bad = true;
    }
  }
  ok = ok && !bad;
  if (!ok) {
#pragma unroll
    for (int i = 0; i < BS; ++i)
#pragma unroll
      for (int j = 0; j < BS; ++j) L[i][j] = i == j ? T(1) : T(0);
  }
  T keep[BS];
#pragma unroll
  for (int j = 0; j < BS; ++j)
    keep[j] = L[j][j] * L[j][j] > frob2 * c256 ? T(1) : T(0);

  // L^-1 (lower) by forward substitution; R^-1 = (L^-1)^T
  T Li[BS][BS];
#pragma unroll
  for (int i = 0; i < BS; ++i)
#pragma unroll
    for (int j = 0; j < BS; ++j) Li[i][j] = T(0);
#pragma unroll
  for (int j = 0; j < BS; ++j) {
    Li[j][j] = T(1) / L[j][j];
#pragma unroll
    for (int i = j + 1; i < BS; ++i) {
      T s = T(0);
#pragma unroll
      for (int k = j; k < i; ++k) s = madd(L[i][k], Li[k][j], s);
      Li[i][j] = -s / L[i][i];
    }
  }

  const bool was = alive[member];
  const bool next = was && ok;
  alive_next[member] = next;
  const size_t m = member;
#pragma unroll
  for (int i = 0; i < 2 * BS * BS; ++i)
    h[m * 2 * BS * BS + i] =
        was ? h1[m * 2 * BS * BS + i] + h2[m * 2 * BS * BS + i] : T(0);
  // beta = R with rows not kept zeroed; 0 where the member is not alive next
#pragma unroll
  for (int k = 0; k < BS; ++k)
#pragma unroll
    for (int l = 0; l < BS; ++l)
      beta[m * BS * BS + k * BS + l] = next ? L[l][k] * keep[k] : T(0);
  T* qc = qcoef + m * (BS * BS + BS + 1);
#pragma unroll
  for (int k = 0; k < BS; ++k)
#pragma unroll
    for (int l = 0; l < BS; ++l) qc[k * BS + l] = Li[l][k];
#pragma unroll
  for (int l = 0; l < BS; ++l) qc[BS * BS + l] = keep[l];
  qc[BS * BS + BS] = next ? T(1) : T(0);
}

// (g): Q = (W2 R^-1) with columns not kept zeroed, 0 where the member is not
// alive next, written over W2 in q.
template <typename T, int BS>
__global__ void __launch_bounds__(THREADS) apply_q_kernel(
    T* __restrict__ q, const T* __restrict__ qcoef, int n, int batch,
    int rows_per_slab) {
  const int member = blockIdx.y * 32 + threadIdx.x % 32;
  if (member >= batch) return;
  const int r0 = blockIdx.x * rows_per_slab;
  const int r1 = min(n, r0 + rows_per_slab);
  const T* qc = qcoef + (size_t)member * (BS * BS + BS + 1);
  T Ri[BS][BS], keep[BS];
#pragma unroll
  for (int k = 0; k < BS; ++k)
#pragma unroll
    for (int l = 0; l < BS; ++l) Ri[k][l] = qc[k * BS + l];
#pragma unroll
  for (int l = 0; l < BS; ++l) keep[l] = qc[BS * BS + l];
  const bool next = qc[BS * BS + BS] != T(0);
  // UNROLL rows loaded before any is stored: the stores go where the loads
  // come from, so the compiler would not move a later load above them
  constexpr int UNROLL = 4;
  for (int r = r0 + threadIdx.x / 32; r < r1; r += UNROLL * WARPS) {
    T x[UNROLL][BS];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (r + u * WARPS < r1)
        RowIO<T, BS>::load(q + ((size_t)(r + u * WARPS) * batch + member) * BS,
                           x[u]);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (r + u * WARPS >= r1) break;
      T y[BS];
#pragma unroll
      for (int l = 0; l < BS; ++l) {
        T t = x[u][0] * Ri[0][l];
#pragma unroll
        for (int k = 1; k <= l; ++k) t = madd(x[u][k], Ri[k][l], t);
        y[l] = next ? t * keep[l] : T(0);
      }
      RowIO<T, BS>::store(q + ((size_t)(r + u * WARPS) * batch + member) * BS,
                          y);
    }
  }
}

// -- wide blocks --------------------------------------------------------------

constexpr int TILE = 32;              // the wide stages' tile edge
constexpr int TROWS = THREADS / TILE;  // rows of threads in a CTA
constexpr int PER = TILE / TROWS;      // coefficients or rows a thread

// Partials over one slab of rows of [X1; X2]^T Y (nsrc = 2: the projections,
// laid out as h is, (2 bs, bs)) or of X1^T X1 (nsrc = 1: G = W2^T W2, bs x
// bs). CTA (slab, tile, member) sums the 32 x 32 tile (src, i0, j0) of the
// member's coefficients over the slab's rows, widened to f64; thread (ty, tx)
// owns coefficients (i0 + ty + 8 q, j0 + tx). part is (slabs, batch,
// nsrc bs^2) in f64.
template <typename T>
__global__ void __launch_bounds__(THREADS) gram_wide_kernel(
    const T* __restrict__ x1, const T* __restrict__ x2,
    const T* __restrict__ y, double* __restrict__ part, int n, int batch,
    int bs, int nsrc, int rows_per_slab) {
  __shared__ double xs[TILE][TILE + 1];
  __shared__ double ys[TILE][TILE + 1];
  const int tiles = (bs + TILE - 1) / TILE;
  const int src = blockIdx.y / (tiles * tiles);
  const int i0 = blockIdx.y / tiles % tiles * TILE;
  const int j0 = blockIdx.y % tiles * TILE;
  const int member = blockIdx.z;
  const int slab = blockIdx.x;
  const int r0 = slab * rows_per_slab;
  const int r1 = min(n, r0 + rows_per_slab);
  const T* x = src == 0 ? x1 : x2;
  const int tx = threadIdx.x % TILE;
  const int ty = threadIdx.x / TILE;

  double acc[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) acc[q] = 0.0;
  for (int rb = r0; rb < r1; rb += TILE) {
    for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
      const int rr = e / TILE, c = e % TILE, r = rb + rr;
      const size_t row = ((size_t)r * batch + member) * bs;
      xs[rr][c] = r < r1 && i0 + c < bs ? (double)x[row + i0 + c] : 0.0;
      ys[rr][c] = r < r1 && j0 + c < bs ? (double)y[row + j0 + c] : 0.0;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < TILE; ++rr) {
      const double yv = ys[rr][tx];
#pragma unroll
      for (int q = 0; q < PER; ++q)
        acc[q] = fma(xs[rr][ty + TROWS * q], yv, acc[q]);
    }
    __syncthreads();
  }
  const size_t K = (size_t)nsrc * bs * bs;
  double* out = part + ((size_t)slab * batch + member) * K;
  const int j = j0 + tx;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = i0 + ty + TROWS * q;
    if (i < bs && j < bs) out[((size_t)src * bs + i) * bs + j] = acc[q];
  }
}

// (b), (d): the sums over the slabs of each (member, coefficient), one
// thread each, slab 0 first, written in T to hk (batch, 2 bs, bs).
template <typename T>
__global__ void __launch_bounds__(THREADS) fold_wide_kernel(
    const double* __restrict__ part, T* __restrict__ hk, int slabs,
    size_t count) {
  const size_t c = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (c >= count) return;
  double s = 0.0;
  for (int sl = 0; sl < slabs; ++sl) s += part[(size_t)sl * count + c];
  hk[c] = (T)s;
}

// MODE 0, (c) and (e): out = (base - X1 C1) - X2 C2, with C1, C2 the
// member's H_p and H_c in coef (its (2 bs, bs) block); base and out may be
// one block. MODE 1, (g): out = X1 R^-1 with columns not kept zeroed, 0
// where the member is not alive next (coef: the member's R^-1, keep and
// alive_next, bs^2 + bs + 1). CTA (32-row block, 32-column tile, member);
// thread (ty, tx) owns rows ty + 8 q and column tx; each product sums over k
// in tiles of 32 through shared memory, in T.
template <typename T, int MODE>
__global__ void __launch_bounds__(THREADS) rowmul_wide_kernel(
    const T* __restrict__ x1, const T* __restrict__ x2, const T* base,
    T* out, const T* __restrict__ coef, int n, int batch, int bs) {
  __shared__ T xs[TILE][TILE + 1];
  __shared__ T cs[TILE][TILE + 1];
  const int member = blockIdx.z;
  const int rb = blockIdx.x * TILE;
  const int j0 = blockIdx.y * TILE;
  const int tx = threadIdx.x % TILE;
  const int ty = threadIdx.x / TILE;
  const size_t bb = (size_t)bs * bs;
  const T* cm = coef + (size_t)member * (MODE == 0 ? 2 * bb : bb + bs + 1);
  constexpr int PRODUCTS = MODE == 0 ? 2 : 1;

  T prod[PRODUCTS][PER];
#pragma unroll
  for (int p = 0; p < PRODUCTS; ++p) {
    const T* x = p == 0 ? x1 : x2;
    const T* C = cm + p * bb;
#pragma unroll
    for (int q = 0; q < PER; ++q) prod[p][q] = T(0);
    for (int k0 = 0; k0 < bs; k0 += TILE) {
      for (int e = threadIdx.x; e < TILE * TILE; e += THREADS) {
        const int rr = e / TILE, c = e % TILE, r = rb + rr;
        xs[rr][c] = r < n && k0 + c < bs
                        ? x[((size_t)r * batch + member) * bs + k0 + c]
                        : T(0);
        cs[rr][c] = k0 + rr < bs && j0 + c < bs
                        ? C[(size_t)(k0 + rr) * bs + j0 + c]
                        : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < TILE; ++kk) {
        const T cv = cs[kk][tx];
#pragma unroll
        for (int q = 0; q < PER; ++q)
          prod[p][q] = madd(xs[ty + TROWS * q][kk], cv, prod[p][q]);
      }
      __syncthreads();
    }
  }
  const int j = j0 + tx;
  if (j >= bs) return;
  bool next = true;
  T keep = T(1);
  if constexpr (MODE == 1) {
    keep = cm[bb + j];
    next = cm[bb + bs] != T(0);
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int r = rb + ty + TROWS * q;
    if (r >= n) continue;
    const size_t at = ((size_t)r * batch + member) * bs + j;
    if constexpr (MODE == 0)
      out[at] = (base[at] - prod[0][q]) - prod[PRODUCTS - 1][q];
    else
      out[at] = next ? prod[0][q] * keep : T(0);
  }
}

// (f), wide: CTA m folds its member's G = W2^T W2 (the slabs in order, one
// thread a coefficient) into work and factors it as factor_kernel does: the
// Cholesky column by column (the pivot on thread 0, the column below it over
// the threads), keep, and L^-1 one column a thread, stored transposed as
// R^-1. Writes h, beta, alive_next and the member's rowmul<1> coefficients
// (R^-1, keep, alive_next). work holds 2 bs^2 of T a member (G, then L).
template <typename T>
__global__ void __launch_bounds__(THREADS) factor_wide_kernel(
    const double* __restrict__ part, const T* __restrict__ h1,
    const T* __restrict__ h2, const bool* __restrict__ alive,
    T* __restrict__ h, T* __restrict__ beta, bool* __restrict__ alive_next,
    T* __restrict__ qcoef, T* __restrict__ work, int slabs, int batch, int bs,
    T eps2, T c16, T c256) {
  __shared__ T s_frob2;
  __shared__ int s_bad;
  const int m = blockIdx.x;
  const int t = threadIdx.x;
  const size_t K = (size_t)bs * bs;
  T* G = work + (size_t)m * 2 * K;
  T* L = G + K;
  T* Ri = qcoef + (size_t)m * (K + bs + 1);
  T* keep = Ri + K;

  for (size_t c = t; c < K; c += THREADS) {
    double s = 0.0;
    for (int sl = 0; sl < slabs; ++sl)
      s += part[((size_t)sl * batch + m) * K + c];
    G[c] = (T)s;
    L[c] = T(0);
    Ri[c] = T(0);
  }
  if (t == 0) s_bad = 0;
  __syncthreads();
  if (t == 0) {
    T f = G[0];
    for (int k = 1; k < bs; ++k) f = f + G[(size_t)k * bs + k];
    s_frob2 = f;
  }
  __syncthreads();
  const T frob2 = s_frob2;
  const T reg = frob2 * c16 + eps2;

  // Cholesky of G + reg I, lower, column by column; a pivot that is not
  // positive (or NaN), or a NaN below it, breaks the member
  for (int j = 0; j < bs; ++j) {
    const T* Lj = L + (size_t)j * bs;
    if (t == 0) {
      T d = G[(size_t)j * bs + j] + reg;
      for (int k = 0; k < j; ++k) d = d - Lj[k] * Lj[k];
      if (!(d > T(0))) s_bad = 1;
      L[(size_t)j * bs + j] = sqrt(d);
    }
    __syncthreads();
    const T ljj = Lj[j];
    for (int i = j + 1 + t; i < bs; i += THREADS) {
      const T* Li = L + (size_t)i * bs;
      T s = G[(size_t)i * bs + j];
      for (int k = 0; k < j; ++k) s = s - Li[k] * Lj[k];
      const T v = s / ljj;
      L[(size_t)i * bs + j] = v;
      if (isnan(v)) s_bad = 1;
    }
    __syncthreads();
  }
  const bool ok = frob2 > eps2 && !s_bad;
  if (!ok)
    for (size_t c = t; c < K; c += THREADS)
      L[c] = c / bs == c % bs ? T(1) : T(0);
  __syncthreads();

  // keep, and L^-1 (lower) by forward substitution, column j on thread j,
  // written as row j of R^-1 = (L^-1)^T
  for (int j = t; j < bs; j += THREADS) {
    const T ljj = L[(size_t)j * bs + j];
    keep[j] = ljj * ljj > frob2 * c256 ? T(1) : T(0);
    T* row = Ri + (size_t)j * bs;
    row[j] = T(1) / ljj;
    for (int i = j + 1; i < bs; ++i) {
      const T* Li = L + (size_t)i * bs;
      T s = T(0);
      for (int k = j; k < i; ++k) s = madd(Li[k], row[k], s);
      row[i] = -s / Li[i];
    }
  }
  const bool was = alive[m];
  const bool next = was && ok;
  if (t == 0) {
    alive_next[m] = next;
    Ri[K + bs] = next ? T(1) : T(0);
  }
  __syncthreads();
  const size_t H = 2 * K;
  for (size_t c = t; c < H; c += THREADS)
    h[m * H + c] = was ? h1[m * H + c] + h2[m * H + c] : T(0);
  // beta = R with rows not kept zeroed; 0 where the member is not alive next
  for (size_t c = t; c < K; c += THREADS) {
    const size_t k = c / bs, l = c % bs;
    beta[m * K + c] = next ? L[l * bs + k] * keep[k] : T(0);
  }
}

#define KRT_LAUNCHED()                                 \
  do {                                                 \
    const cudaError_t e = cudaGetLastError();          \
    if (e != cudaSuccess) return (int)e;               \
  } while (0)

template <typename T, int BS>
int launch(const void* vp, const void* vc, const void* w, void* q,
           const void* alive, void* alive_next, void* h, void* beta,
           void* part, void* scratch, int n, int batch, int rows_per_slab,
           int slabs, double eps, cudaStream_t s) {
  const dim3 grid(slabs, (batch + 31) / 32);
  const int per_member = (batch + WARPS - 1) / WARPS;
  const T* tvp = (const T*)vp;
  const T* tvc = (const T*)vc;
  T* tq = (T*)q;
  double* dpart = (double*)part;
  T* h1 = (T*)scratch;
  T* h2 = h1 + (size_t)batch * 2 * BS * BS;
  T* qcoef = h2 + (size_t)batch * 2 * BS * BS;
  stream_kernel<T, BS, 0><<<grid, THREADS, 0, s>>>(
      tvp, tvc, (const T*)w, nullptr, nullptr, nullptr, dpart, n, batch,
      rows_per_slab);
  KRT_LAUNCHED();
  fold_kernel<T, BS><<<per_member, THREADS, 0, s>>>(dpart, h1, slabs, batch);
  KRT_LAUNCHED();
  stream_kernel<T, BS, 1><<<grid, THREADS, 0, s>>>(
      tvp, tvc, (const T*)w, nullptr, h1, nullptr, dpart, n, batch,
      rows_per_slab);
  KRT_LAUNCHED();
  fold_kernel<T, BS><<<per_member, THREADS, 0, s>>>(dpart, h2, slabs, batch);
  KRT_LAUNCHED();
  stream_kernel<T, BS, 2><<<grid, THREADS, 0, s>>>(
      tvp, tvc, (const T*)w, tq, h1, h2, dpart, n, batch, rows_per_slab);
  KRT_LAUNCHED();
  const double eps_t = std::numeric_limits<T>::epsilon();
  factor_kernel<T, BS><<<per_member, THREADS, 0, s>>>(
      dpart, h1, h2, (const bool*)alive, (T*)h, (T*)beta, (bool*)alive_next,
      qcoef, slabs, batch, (T)(eps * eps), (T)(eps_t * 16.0),
      (T)(eps_t * 256.0));
  KRT_LAUNCHED();
  apply_q_kernel<T, BS><<<grid, THREADS, 0, s>>>(tq, qcoef, n, batch,
                                                 rows_per_slab);
  KRT_LAUNCHED();
  return 0;
}

// scratch (in T): W1/W2 (n, batch, bs), then h1 and h2 (batch, 2 bs, bs),
// the rowmul<1> coefficients (batch, bs^2 + bs + 1) and factor_wide's work
// (batch, 2 bs^2)
template <typename T>
int launch_wide(const void* vp, const void* vc, const void* w, void* q,
                const void* alive, void* alive_next, void* h, void* beta,
                void* part, void* scratch, int n, int batch, int bs,
                int rows_per_slab, int slabs, double eps, cudaStream_t s) {
  const int tiles = (bs + TILE - 1) / TILE;
  const dim3 gram2(slabs, 2 * tiles * tiles, batch);
  const dim3 gram1(slabs, tiles * tiles, batch);
  const dim3 rows((n + TILE - 1) / TILE, tiles, batch);
  const size_t K = (size_t)bs * bs;
  const size_t hcount = (size_t)batch * 2 * K;
  const unsigned folds = (unsigned)((hcount + THREADS - 1) / THREADS);
  const T* tvp = (const T*)vp;
  const T* tvc = (const T*)vc;
  double* dpart = (double*)part;
  T* buf = (T*)scratch;
  T* h1 = buf + (size_t)n * batch * bs;
  T* h2 = h1 + hcount;
  T* qcoef = h2 + hcount;
  T* work = qcoef + (size_t)batch * (K + bs + 1);
  gram_wide_kernel<T><<<gram2, THREADS, 0, s>>>(tvp, tvc, (const T*)w, dpart,
                                                n, batch, bs, 2,
                                                rows_per_slab);
  KRT_LAUNCHED();
  fold_wide_kernel<T><<<folds, THREADS, 0, s>>>(dpart, h1, slabs, hcount);
  KRT_LAUNCHED();
  rowmul_wide_kernel<T, 0><<<rows, THREADS, 0, s>>>(tvp, tvc, (const T*)w,
                                                    buf, h1, n, batch, bs);
  KRT_LAUNCHED();
  gram_wide_kernel<T><<<gram2, THREADS, 0, s>>>(tvp, tvc, buf, dpart, n,
                                                batch, bs, 2, rows_per_slab);
  KRT_LAUNCHED();
  fold_wide_kernel<T><<<folds, THREADS, 0, s>>>(dpart, h2, slabs, hcount);
  KRT_LAUNCHED();
  rowmul_wide_kernel<T, 0><<<rows, THREADS, 0, s>>>(tvp, tvc, buf, buf, h2,
                                                    n, batch, bs);
  KRT_LAUNCHED();
  gram_wide_kernel<T><<<gram1, THREADS, 0, s>>>(buf, buf, buf, dpart, n,
                                                batch, bs, 1, rows_per_slab);
  KRT_LAUNCHED();
  const double eps_t = std::numeric_limits<T>::epsilon();
  factor_wide_kernel<T><<<batch, THREADS, 0, s>>>(
      dpart, h1, h2, (const bool*)alive, (T*)h, (T*)beta, (bool*)alive_next,
      qcoef, work, slabs, batch, bs, (T)(eps * eps), (T)(eps_t * 16.0),
      (T)(eps_t * 256.0));
  KRT_LAUNCHED();
  rowmul_wide_kernel<T, 1><<<rows, THREADS, 0, s>>>(buf, nullptr, nullptr,
                                                    (T*)q, qcoef, n, batch,
                                                    bs);
  KRT_LAUNCHED();
  return 0;
}

template <typename T>
int dispatch(const void* vp, const void* vc, const void* w, void* q,
             const void* alive, void* alive_next, void* h, void* beta,
             void* part, void* scratch, int n, int batch, int bs,
             int rows_per_slab, int slabs, double eps, void* stream) {
  if (n <= 0 || batch <= 0 || bs <= 0 || rows_per_slab <= 0 || slabs <= 0 ||
      (long long)rows_per_slab * slabs < n ||
      (long long)rows_per_slab * (slabs - 1) >= n || (batch + 31) / 32 > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (bs > 4) {
    const long long tiles = (bs + TILE - 1) / TILE;
    if (batch > 65535 || 2 * tiles * tiles > 65535)
      return (int)cudaErrorInvalidValue;
    return launch_wide<T>(vp, vc, w, q, alive, alive_next, h, beta, part,
                          scratch, n, batch, bs, rows_per_slab, slabs, eps, s);
  }
  switch (bs) {
    case 1:
      return launch<T, 1>(vp, vc, w, q, alive, alive_next, h, beta, part,
                          scratch, n, batch, rows_per_slab, slabs, eps, s);
    case 2:
      return launch<T, 2>(vp, vc, w, q, alive, alive_next, h, beta, part,
                          scratch, n, batch, rows_per_slab, slabs, eps, s);
    case 3:
      return launch<T, 3>(vp, vc, w, q, alive, alive_next, h, beta, part,
                          scratch, n, batch, rows_per_slab, slabs, eps, s);
    default:
      return launch<T, 4>(vp, vc, w, q, alive, alive_next, h, beta, part,
                          scratch, n, batch, rows_per_slab, slabs, eps, s);
  }
}

}  // namespace

extern "C" {

// One block step in f32 (f64 Gram sums): vp, vc, w (n, batch, bs) in,
// q (n, batch, bs) out (the new v_cur; W2 passes through it), alive (batch,)
// bool in, alive_next (batch,) bool, h (batch, 2 bs, bs) and beta
// (batch, bs, bs) out; part holds slabs * 2 bs^2 * batch doubles and scratch
// batch * (5 bs^2 + bs + 1) floats, or, for bs > 4, n * batch * bs +
// batch * (7 bs^2 + bs + 1). The row slabs are rows_per_slab long, the last
// one ragged.
int krt_block_mgs_f32(const void* vp, const void* vc, const void* w, void* q,
                      const void* alive, void* alive_next, void* h,
                      void* beta, void* part, void* scratch, int n, int batch,
                      int bs, int rows_per_slab, int slabs, double eps,
                      void* stream) {
  return dispatch<float>(vp, vc, w, q, alive, alive_next, h, beta, part,
                         scratch, n, batch, bs, rows_per_slab, slabs, eps,
                         stream);
}

// The same in f64, DFMA only; scratch holds as many doubles.
int krt_block_mgs_f64(const void* vp, const void* vc, const void* w, void* q,
                      const void* alive, void* alive_next, void* h,
                      void* beta, void* part, void* scratch, int n, int batch,
                      int bs, int rows_per_slab, int slabs, double eps,
                      void* stream) {
  return dispatch<double>(vp, vc, w, q, alive, alive_next, h, beta, part,
                          scratch, n, batch, bs, rows_per_slab, slabs, eps,
                          stream);
}

}  // extern "C"
