// Eigenvalues of the host-eigh scorer's projected band matrices by Sturm-count
// bisection in f64, for Hopper (sm_90a), bound to Python with ctypes
// (ops/banded_sturm.py).
//
// It replaces no TPU kernel: at each round boundary the JAX package copies the
// block Lanczos recurrence to the host and calls LAPACK's banded eigensolver
// there, once a candidate and projection
// (krylov_robustness_tpu/updates/trace_update.py::_eigvals_banded_batch). The
// port did the same, about a thousand tiny dsbev calls a round at Q = 250,
// each dominated by Python and the GIL, while the card sat idle. This kernel
// computes a round's spectra where the recurrence already lies, in one launch.
//
// What it computes. For each active candidate (act[i], i = blockIdx.x) it
// builds, in shared memory and in f64, the symmetrized block-tridiagonal
// projection G of the first m steps of the recurrence h (steps, batch, 2bs,
// bs) and beta (steps, batch, bs, bs), in the layout of
// updates/trace_update.py::_band_from_blocks: diagonal blocks
// (alpha_j + alpha_j^T) / 2 with alpha_j = h[j][bs:2bs], couplings
// (beta_{j-1} + h[j][0:bs]^T) / 2 below them; tG adds (Cm + Cm^T) / 2 in the
// top-left bs x bs. Its half-bandwidth is w = 2bs - 1. It returns all
// eigenvalues of four matrices: tG and G at M = m bs columns and at
// ML = m_lag bs (their leading principal submatrices), as out[i][l] with the
// lanes l laid out [tG(M) | G(M) | tG(ML) | G(ML)], eigenvalue index ascending
// within each; a matrix with a non-finite entry gets NaN throughout.
//
// How. Each of the four matrices is reduced to tridiagonal form by Givens
// rotations in shared memory (Schwarz's band reduction: the diagonals from
// the outermost, each entry zeroed and its bulge chased off the end), and its
// eigenvalues are then found by Sturm-count bisection on the tridiagonal, a
// lane one (matrix, eigenvalue) pair: f64, 62 iterations from the
// Gerschgorin interval, q_i = (d_i - x) - e_{i-1}^2 / q_{i-1}, a q below
// eps * scale in magnitude taken as -eps * scale (scale = max(|lo|, |hi|,
// 1)). That is as accurate as the host's LAPACK (dsbtrd, then a tridiagonal
// solver), O(eps |G|). Bisection straight on the band
// (ops/banded_eig.py::_bisect, an unpivoted banded LDL^T) is not: a pivot
// near zero makes its Schur updates cancel, and on the main path's bands it
// strayed up to 3e-13 |G| from LAPACK. ops/banded_sturm.py::spectra_plain is
// the same arithmetic in torch.
//
// What bounds it on the H100: chains of dependent f64 operations, not bytes.
// A round reads a few hundred KB and writes batch * (2M + 2ML) doubles. A
// matrix's reduction is about 0.42 M^2 rotations (a square root, a division
// and some 40 FMAs each, on shared memory), and each lane's bisection is 62
// steps of M Sturm-count steps, each a division whose result the next needs.
//
// Mapping, and what covers the latency. A CTA holds up to 32 of a candidate's
// lanes, of the four matrices at once since they share one band (a candidate
// with more lanes takes several CTAs). All its threads build the candidate's
// band from the recurrence in shared memory; one warp reduces each matrix its
// lanes need, running the rotations of a wavefront (those that touch no
// common entry) on its lanes at once, about 6M rotation times in all against
// 0.42 M^2 one after another; then eight threads bisect each lane: a sweep
// counts at the seven nested midpoints of three bisection steps at once, so
// the 62 steps take 21 sweeps of the chain, not 62, with the same bits. The
// lanes of a matrix read the same tridiagonal entry at each step: a broadcast
// 16-byte load from shared memory. At Q = 250 a round holds 250 x (2M + 2ML)
// / 32 CTAs, and still the chains, not the FP64 pipes, set the time (PERF.md
// has the times and the least time).
//
// No atomics on floating-point values: two runs give identical bits. Every
// entry point launches on the given stream, allocates nothing and returns the
// first cudaGetLastError() that is not cudaSuccess (0 = success).

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int ITERS = 62;
constexpr int MAX_THREADS = 256;
constexpr int LEVELS = 3;  // bisection steps a sweep
constexpr int GROUP = 1 << LEVELS;  // threads a lane: 2^LEVELS - 1 counts
constexpr double EPS = 2.220446049250313e-16;  // 2^-52, f64's eps
constexpr unsigned FULL = 0xffffffffu;

// Entry (r, t), r >= t, r - t <= K, of a working matrix in band-row storage:
// B[r * (K + 1) + k] = A[r][r - K + k], k = K the diagonal.
template <int K>
__device__ __forceinline__ double& at(double* B, int r, int t) {
  return B[r * (K + 1) + K - (r - t)];
}

// One Givens rotation of rows and columns (p, p + 1) of the symmetric matrix
// in B (n rows, half-bandwidth k plus the bulge at k + 1) that zeroes
// A[p + 1][col] against A[p][col].
template <int K>
__device__ void rotate(double* B, int n, int k, int p, int col) {
  const int q = p + 1;
  const double a = at<K>(B, p, col), b = at<K>(B, q, col);
  double c = 1.0, s = 0.0, r = a;
  if (b != 0.0) {
    r = sqrt(a * a + b * b);
    const double inv = 1.0 / r;
    c = a * inv;
    s = b * inv;
  }
  at<K>(B, p, col) = r;
  at<K>(B, q, col) = 0.0;
  for (int t = max(0, q - k - 1); t < p; ++t) {  // rows p, q left of the block
    if (t == col) continue;
    const double x = at<K>(B, p, t), y = at<K>(B, q, t);
    at<K>(B, p, t) = c * x + s * y;
    at<K>(B, q, t) = c * y - s * x;
  }
  const double x = at<K>(B, p, p), y = at<K>(B, q, q), z = at<K>(B, q, p);
  const double cs2 = 2.0 * c * s * z;
  at<K>(B, p, p) = c * c * x + cs2 + s * s * y;
  at<K>(B, q, q) = s * s * x - cs2 + c * c * y;
  at<K>(B, q, p) = c * s * (y - x) + (c * c - s * s) * z;
  const int last = min(n - 1, q + k);
  for (int r2 = q + 1; r2 <= last; ++r2) {  // columns p, q below the block
    const double x2 = at<K>(B, r2, p), y2 = at<K>(B, r2, q);
    at<K>(B, r2, p) = c * x2 + s * y2;
    at<K>(B, r2, q) = c * y2 - s * x2;
  }
}

// Reduce the symmetric band matrix in B (n rows, half-bandwidth W) to
// tridiagonal form by Givens rotations (Schwarz), one warp a matrix: the
// diagonals from the outermost (k = W ... 2); in each, rotation s of chase j
// (zeroing A[j+k][j] for s = 0, then the bulge that each rotation leaves at
// distance k + 1) turns rows and columns (p, p + 1), p = j + k - 1 + s k. Two
// rotations touch a common entry only if their p lie within k + 1, so the
// wavefront t = 3 j + s runs the rotations of one t on the warp's lanes at
// once and keeps every pair that touches in the order of the sequential
// chases: the result has their bits.
template <int W>
__device__ void tridiagonalize(double* B, int n, int lane) {
  constexpr int K = W + 1;
  for (int k = W; k >= 2; --k) {
    const int jmax = n - k - 1;
    for (int t = 0; t <= 3 * jmax; ++t) {
      for (int j = min(t / 3, jmax) - lane; j >= 0; j -= 32) {
        const int s = t - 3 * j;
        const int i = j + k + s * k;
        if (i >= n) break;  // chase j has ended, and every older one too
        rotate<K>(B, n, k, i - 1, s == 0 ? j : i - k - 1);
      }
      __syncwarp();
    }
  }
}

// #{eigenvalues below x} of the n x n tridiagonal matrix with diagonal
// tri[i].x and squared off-diagonal tri[i].y = e_{i-1}^2 (tri[0].y = 0).
__device__ __forceinline__ int count_below(const double2* tri, int n,
                                           double x, double pivmin) {
  int cnt = 0;
  double q = 1.0;
  for (int i = 0; i < n; ++i) {
    const double2 de = tri[i];
    q = (de.x - x) - de.y / q;
    if (fabs(q) < pivmin) q = -pivmin;
    cnt += q < 0.0;
  }
  return cnt;
}

template <typename T, int BS>
__global__ void __launch_bounds__(MAX_THREADS)
    sturm_kernel(const T* __restrict__ h, const T* __restrict__ beta,
                 const double* __restrict__ cm, const int* __restrict__ act,
                 double* __restrict__ out, int batch, int m, int m_lag) {
  constexpr int W1 = 2 * BS;
  constexpr int W = W1 - 1;
  constexpr int K = W + 1;  // the band and the bulge
  const int M = m * BS, ML = m_lag * BS;
  extern __shared__ __align__(16) double smem[];
  double* col = smem;                                   // M * W1
  double* work = col + M * W1;                          // 4 * M * (K + 1)
  double2* tri = reinterpret_cast<double2*>(work + 4 * M * (K + 1));  // 4 M
  __shared__ double cs[BS * BS];
  __shared__ int bad[2];  // first row with a non-finite entry: of G, of Cs
  __shared__ double bound[4][2];

  const int member = act[blockIdx.x];
  const int tid = threadIdx.x;
  if (tid < 2) bad[tid] = INT_MAX;
  __syncthreads();

  // G's band, col[c * W1 + k] = G[c][c - W + k], k = W the diagonal
  for (int e = tid; e < M * W1; e += blockDim.x) {
    const int c = e / W1, k = e - c * W1, cc = c - W + k;
    const int j = c / BS, r = c - j * BS;
    double v = 0.0;
    if (cc >= j * BS) {  // diagonal block j, (alpha_j + alpha_j^T) / 2
      const int q = cc - j * BS;
      const T* a = h + ((size_t)j * batch + member) * (2 * BS * BS) + BS * BS;
      v = ((double)a[r * BS + q] + (double)a[q * BS + r]) * 0.5;
    } else if (j > 0 && cc >= (j - 1) * BS) {
      // the coupling below block j - 1, (beta_{j-1} + h[j][0:bs]^T) / 2;
      // further left the band holds zeros
      const int q = cc - (j - 1) * BS;
      const T* b = beta + ((size_t)(j - 1) * batch + member) * (BS * BS);
      const T* u = h + ((size_t)j * batch + member) * (2 * BS * BS);
      v = ((double)b[r * BS + q] + (double)u[q * BS + r]) * 0.5;
    }
    if (!isfinite(v)) atomicMin(&bad[0], c);
    col[e] = v;
  }
  if (tid < BS * BS) {
    const int r = tid / BS, q = tid - r * BS;
    const double* c0 = cm + (size_t)member * BS * BS;
    const double v = (c0[r * BS + q] + c0[q * BS + r]) * 0.5;
    if (!isfinite(v)) atomicMin(&bad[1], r > q ? r : q);
    cs[tid] = v;
  }
  __syncthreads();

  // the matrices x = 0: tG(M), 1: G(M), 2: tG(ML), 3: G(ML) hold the lanes
  // [first[x], first[x] + size[x]); this CTA's lanes are [l0, l1)
  const int lanes = 2 * M + 2 * ML;
  const int slots = blockDim.x / GROUP;  // lanes a CTA
  const int l0 = blockIdx.y * slots;
  const int l1 = min(lanes, l0 + slots);
  const int first[4] = {0, M, 2 * M, 2 * M + ML};
  const int size[4] = {M, M, ML, ML};
  auto needed = [&](int x) {
    return size[x] > 0 && first[x] < l1 && first[x] + size[x] > l0;
  };
  auto poisoned = [&](int x) {
    return ((x & 1) == 0 ? min(bad[0], bad[1]) : bad[0]) < size[x];
  };

  // working copies in band-row storage, tG adding Cs at the top left
  const int per = M * (K + 1);
  for (int e = tid; e < 4 * per; e += blockDim.x) {
    const int x = e / per, rem = e - x * per;
    const int r = rem / (K + 1), k = rem - r * (K + 1), t = r - K + k;
    if (!needed(x) || r >= size[x]) continue;
    double v = 0.0;
    if (k > 0 && t >= 0) {
      v = col[r * W1 + k - 1];
      if ((x & 1) == 0 && r < BS) v += cs[r * BS + t];
    }
    work[e] = v;
  }
  __syncthreads();

  // one warp a matrix: the reduction, then the tridiagonal's Gerschgorin
  // interval
  const int lane = tid & 31, warps = blockDim.x >> 5;
  for (int x = tid >> 5; x < 4; x += warps) {
    if (!needed(x) || poisoned(x)) continue;
    const int n = size[x];
    double* B = work + x * per;
    tridiagonalize<W>(B, n, lane);
    double lo = __longlong_as_double(0x7ff0000000000000LL);  // +inf
    double hi = -lo;
    for (int i = lane; i < n; i += 32) {
      const double d = at<K>(B, i, i);
      const double ep = i > 0 ? at<K>(B, i, i - 1) : 0.0;
      const double en = i + 1 < n ? at<K>(B, i + 1, i) : 0.0;
      tri[x * M + i] = make_double2(d, ep * ep);
      const double rad = fabs(ep) + fabs(en);
      lo = fmin(lo, d - rad);
      hi = fmax(hi, d + rad);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = fmin(lo, __shfl_xor_sync(FULL, lo, o));
      hi = fmax(hi, __shfl_xor_sync(FULL, hi, o));
    }
    if (lane == 0) {
      bound[x][0] = lo;
      bound[x][1] = hi;
    }
  }
  __syncthreads();

  // a group of GROUP threads a lane: each sweep counts at the 2^LEVELS - 1
  // nested midpoints of [lo, hi] at once (one a thread, the last thread
  // idle), then every thread of the group walks the LEVELS bisection steps
  // those counts decide, so ITERS steps take ITERS / LEVELS sweeps and give
  // the bits of one-point bisection
  const int l = l0 + tid / GROUP, node = tid % GROUP;
  if (l >= l1) return;
  const unsigned group = ((1u << GROUP) - 1) << (lane & ~(GROUP - 1));
  int x = 3;
  while (l < first[x]) --x;
  const int tgt = l - first[x];
  double res = __longlong_as_double(0x7ff8000000000000LL);  // NaN
  if (!poisoned(x)) {
    double lo = bound[x][0], hi = bound[x][1];
    const double scale = fmax(fmax(fabs(lo), fabs(hi)), 1.0);
    const double pivmin = EPS * scale;
    const double2* t = tri + x * M;
    for (int done = 0; done < ITERS; done += LEVELS) {
      const int levels = min(LEVELS, ITERS - done);
      // this thread's node: depth d, i-th of its level
      const int d = 31 - __clz(node + 1), i = node + 1 - (1 << d);
      bool left = false;
      if (d < levels) {
        double a = lo, b = hi, mid = (a + b) * 0.5;
        for (int e = d - 1; e >= 0; --e) {
          if ((i >> e) & 1) a = mid; else b = mid;
          mid = (a + b) * 0.5;
        }
        left = count_below(t, size[x], mid, pivmin) > tgt;
      }
      const unsigned votes =
          __ballot_sync(group, left) >> (lane & ~(GROUP - 1));
      for (int v = 0, e = 0; e < levels; ++e) {
        const double mid = (lo + hi) * 0.5;
        if ((votes >> v) & 1) {
          hi = mid;
          v = 2 * v + 1;
        } else {
          lo = mid;
          v = 2 * v + 2;
        }
      }
    }
    res = (lo + hi) * 0.5;
  }
  if (node == 0) out[(size_t)blockIdx.x * lanes + l] = res;
}

template <typename T, int BS>
int launch(const void* h, const void* beta, const void* cm, const void* act,
           void* out, int n_act, int batch, int m, int m_lag, int chunks,
           int threads, cudaStream_t s) {
  constexpr int W1 = 2 * BS;
  const size_t smem =
      (size_t)m * BS * (W1 + 4 * (W1 + 1) + 8) * sizeof(double);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sturm_kernel<T, BS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sturm_kernel<T, BS><<<dim3(n_act, chunks), threads, smem, s>>>(
      (const T*)h, (const T*)beta, (const double*)cm, (const int*)act,
      (double*)out, batch, m, m_lag);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* h, const void* beta, const void* cm, const void* act,
             void* out, int n_act, int batch, int bs, int m, int m_lag,
             int chunks, int threads, void* stream) {
  if (n_act <= 0 || batch <= 0 || m <= 0 || m_lag < 0 || m_lag > m ||
      chunks <= 0 || chunks > 65535 || threads <= 0 ||
      threads > MAX_THREADS || threads % 32 ||
      (long long)chunks * (threads / GROUP) < 2LL * (m + m_lag) * bs)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (bs) {
    case 1:
      return launch<T, 1>(h, beta, cm, act, out, n_act, batch, m, m_lag,
                          chunks, threads, s);
    case 2:
      return launch<T, 2>(h, beta, cm, act, out, n_act, batch, m, m_lag,
                          chunks, threads, s);
    case 3:
      return launch<T, 3>(h, beta, cm, act, out, n_act, batch, m, m_lag,
                          chunks, threads, s);
    case 4:
      return launch<T, 4>(h, beta, cm, act, out, n_act, batch, m, m_lag,
                          chunks, threads, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// A round's spectra from an f32 recurrence: h (steps, batch, 2 bs, bs) and
// beta (steps, batch, bs, bs) with steps >= m, cm (batch, bs, bs) f64, act
// (n_act,) int32 member indices, out (n_act, 2 (m + m_lag) bs) f64; a grid of
// n_act x chunks CTAs of `threads` threads, GROUP a lane, covers each
// candidate's lanes.
int krt_banded_sturm_f32(const void* h, const void* beta, const void* cm,
                         const void* act, void* out, int n_act, int batch,
                         int bs, int m, int m_lag, int chunks, int threads,
                         void* stream) {
  return dispatch<float>(h, beta, cm, act, out, n_act, batch, bs, m, m_lag,
                         chunks, threads, stream);
}

// The same from an f64 recurrence.
int krt_banded_sturm_f64(const void* h, const void* beta, const void* cm,
                         const void* act, void* out, int n_act, int batch,
                         int bs, int m, int m_lag, int chunks, int threads,
                         void* stream) {
  return dispatch<double>(h, beta, cm, act, out, n_act, batch, bs, m, m_lag,
                          chunks, threads, stream);
}

}  // extern "C"
