// Flat block-sparse (BSR, 128 x 128 blocks) SpMM for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernel of krylov_robustness_tpu/ops/pallas_bsr.py:
//   K4  bsr_flat_kernel  <-  _bsr_kernel (launched by _bsr_spmm)
//
// What it computes. The (RCM-permuted) adjacency is packed into dense 128 x 128
// blocks sorted by row block; block t covers rows rb[t]*128.. and columns
// cb[t]*128... Every row block owns at least one block. With x row-major (n, b),
//   y[rows of row block r] = sum over blocks t of r of  A_blk[t] @ x[cols of cb[t]],
// in full precision, as the TPU kernel's Precision.HIGHEST: FFMA in f32 (never
// TF32), DFMA in f64. The sum runs over blocks in order and over each block's
// columns in order, which is not the plain torch version's order, so the two
// agree to rounding, not bit for bit.
//
// Schedule. On the TPU the grid ran block by block in order, zeroed the
// resident y tile at a row block's first block (the `first` flags) and
// accumulated into it. Here one CTA owns one (128-row block, 64-column slice)
// of y: it walks that row block's blocks (row_ptr[r] .. row_ptr[r+1], derived
// from rb at packing), keeps the sum in registers and writes y once. No
// atomics, no zero pass, no `first` flags. Each block is staged through shared
// memory in k-chunks of BK columns (128 x BK of A beside BK x 64 of x), so the
// f64 block (128 KB whole) fits the 48 KB of static shared memory. The CTAs of
// one row block are adjacent in the 1-D grid, so its blocks are read from HBM
// about once and from L2 by the other column slices.
//
// What bounds it on the H100. The useful work, 2*nnz*b flops, is negligible,
// and the bytes it must move (the blocks, x read once, y written once) bound
// it: on a road network at Vermont's scale (2,336 blocks) at b = 512 in f32,
// ~545 MB, 0.163 ms at 3.35 TB/s. But the dense-block design computes every
// block whole, and 98.9% of a block there is fill: 39.2 GFLOP, 0.585 ms at the
// 67 TFLOP/s of FFMA (1.15 ms at 34 TFLOP/s in f64). This simple kernel is
// bound by that arithmetic. Skipping empty sub-blocks with a bitmap (as K1/K2
// do) or running split terms on the tensor cores are later work.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLK = 128;    // block edge, the packing's
constexpr int BN = 64;      // y columns per CTA
constexpr int THREADS = 256;
// each thread owns an 8 x 4 register block of the CTA's 128 x 64 y tile, rows
// ty + 16i and columns tx + 16j (broadcast, conflict-free shared reads)
constexpr int TM = BLK / 16;
constexpr int TN = BN / 16;

__device__ __forceinline__ float fused_madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_madd(double a, double b, double c) {
  return fma(a, b, c);
}

// BK: block columns per k-chunk, 32 in f32 and 16 in f64, which keeps the
// staged chunk near 25 KB in either dtype.
template <typename T, int BK>
__global__ void __launch_bounds__(THREADS) bsr_flat_kernel(
    const T* __restrict__ ablocks, const int* __restrict__ cb,
    const int* __restrict__ row_ptr, const T* __restrict__ x,
    T* __restrict__ y, int n, int b, int nslices) {
  __shared__ T As[BLK][BK + 1];
  __shared__ T Xs[BK][BN];

  const int rblk = blockIdx.x / nslices;
  const int row0 = rblk * BLK;
  const int col0 = (blockIdx.x % nslices) * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

  const int t_end = row_ptr[rblk + 1];
  for (int t = row_ptr[rblk]; t < t_end; ++t) {
    const T* a = ablocks + (size_t)t * BLK * BLK;
    const int xrow0 = cb[t] * BLK;
    for (int kc = 0; kc < BLK; kc += BK) {
      for (int e = tid; e < BLK * BK; e += THREADS) {
        const int r = e / BK;
        const int c = e % BK;
        As[r][c] = a[r * BLK + kc + c];
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        const int r = e / BN;
        const int c = e % BN;
        const int gr = xrow0 + kc + r;
        const int gc = col0 + c;
        Xs[r][c] = (gr < n && gc < b) ? x[(size_t)gr * b + gc] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        T av[TM], xv[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < TN; ++j) xv[j] = Xs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i][j] = fused_madd(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < b) y[(size_t)gr * b + gc] = acc[i][j];
    }
  }
}

template <typename T, int BK>
int launch(const void* ablocks, const void* cb, const void* row_ptr,
           const void* x, void* y, int nrb, int n, int b, void* stream) {
  if (nrb <= 0 || n <= 0 || b <= 0 || n > (long long)nrb * BLK)
    return (int)cudaErrorInvalidValue;
  const int nslices = (b + BN - 1) / BN;
  const long long ctas = (long long)nrb * nslices;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bsr_flat_kernel<T, BK><<<(unsigned)ctas, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)ablocks, (const int*)cb, (const int*)row_ptr, (const T*)x,
      (T*)y, n, b, nslices);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4 in f32: y (n, b) = A (f32 blocks) @ x (n, b), FFMA only.
int krt_bsr_flat_f32(const void* ablocks, const void* cb, const void* row_ptr,
                     const void* x, void* y, int nrb, int n, int b,
                     void* stream) {
  return launch<float, 32>(ablocks, cb, row_ptr, x, y, nrb, n, b, stream);
}

// K4 in f64: y (n, b) = A (f64 blocks) @ x (n, b), DFMA only.
int krt_bsr_flat_f64(const void* ablocks, const void* cb, const void* row_ptr,
                     const void* x, void* y, int nrb, int n, int b,
                     void* stream) {
  return launch<double, 16>(ablocks, cb, row_ptr, x, y, nrb, n, b, stream);
}

}  // extern "C"
