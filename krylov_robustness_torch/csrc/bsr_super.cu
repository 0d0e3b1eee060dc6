// Super-tile block-sparse SpMM for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of krylov_robustness_tpu/ops/pallas_bsr_super.py:
//   K1  bsr_super_bf16_kernel  <-  _kernel_bf16 (launched by _tile_spmm_bf16)
//   K2  bsr_super_full_kernel  <-  _kernel_f32  (launched by _tile_spmm_f32)
//
// What they compute. The (RCM-permuted) adjacency is packed into dense
// tile_r x tile_c super-tiles (default 512 x 256), sorted by super-row; tile t
// covers rows sup(t)*tile_r.. and columns slab[t]*tile_c... Then
//   y[rows of super-row s] = sum over tiles t of s of  A_tile[t] @ x[cols of slab[t]].
// K1 stores A in bf16 (0/+-1 adjacency is bf16-exact) and splits each f32 x
// value into `terms` bf16 parts (hi, lo, lo2) on load; every part runs through
// the bf16 tensor cores with f32 accumulation, so y = A x to ~2^-18 (2 terms) or
// ~2^-27 (3 terms) relative. K2 is the same schedule in full f32 or f64 with
// plain FFMA/DFMA (no TF32), for values that are not bf16-exact and for f64.
//
// Schedule. On the TPU the grid ran tile by tile in order and accumulated into a
// resident y tile. Here one CTA owns one (64-row strip of a super-row, 64-column
// batch tile) of y: it walks that super-row's tiles (sup_ptr[s] .. sup_ptr[s+1])
// in a loop, keeps the sum in registers and writes y once. No atomics, no
// second pass, and the `start` flags of the TPU packing are not needed.
//
// What bounds it on the H100. The tiles are nearly empty: on a road network at
// Vermont's scale a 512 x 256 tile is ~0.2% dense, so a dense-tile product
// would spend ~500x more tensor-core MACs (and A bytes) than the nnz*b useful
// work. The kernel is fill-bound, not HBM-bound. What the design does about it:
// each tile carries a structural bitmap of its 64 x 32 sub-blocks (built at pack
// time from the sparsity pattern, which frozen-structure edits never change),
// and a CTA skips every sub-block that holds no entry: no load, no MMA. What is
// left is the fill inside the occupied sub-blocks, plus the x re-reads, one per
// occupied sub-block. Faster variants (wgmma/TMA pipelines, a tile shape chosen
// for Hopper) are later work.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

// BM and BK are also the bitmap's sub-block; MASK_BM and MASK_BK of
// ops/bsr_super.py, which packs the bitmap, must equal them.
constexpr int BM = 64;  // y rows per CTA (strip of a super-row)
constexpr int BN = 64;  // batch columns per CTA
constexpr int BK = 32;  // tile columns per reduction chunk (= one bitmap bit)

// K1 shared-memory strides (elements). bf16 strides are multiples of 8 and the
// f32 stride a multiple of 4, as wmma requires; the padding breaks bank
// conflicts. Every fragment pointer below lands on a 32-byte boundary.
constexpr int A_LD = BK + 8;
constexpr int X_LD = BN + 8;
constexpr int C_LD = BN + 4;

template <int TERMS>
__global__ void __launch_bounds__(128) bsr_super_bf16_kernel(
    const __nv_bfloat16* __restrict__ atiles, const int* __restrict__ slab,
    const int* __restrict__ sup_ptr, const uint8_t* __restrict__ blkmask,
    const float* __restrict__ x, float* __restrict__ y, int tile_r,
    int tile_c, int n, int b) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * A_LD];
  __shared__ __align__(128) __nv_bfloat16 Xs[TERMS][BK * X_LD];
  __shared__ __align__(128) float Cs[BM * C_LD];

  const int strips = tile_r / BM;
  const int kblocks = tile_c / BK;
  const int s = blockIdx.x / strips;
  const int strip = blockIdx.x % strips;
  const int row0 = s * tile_r + strip * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // 2 x 2 warps, 32 x 32 of y each
  const int wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int t_end = sup_ptr[s + 1];
  for (int t = sup_ptr[s]; t < t_end; ++t) {
    const uint8_t* bits = blkmask + ((size_t)t * strips + strip) * kblocks;
    const __nv_bfloat16* a_strip =
        atiles + (size_t)t * tile_r * tile_c + (size_t)strip * BM * tile_c;
    const int xrow0 = slab[t] * tile_c;
    for (int kb = 0; kb < kblocks; ++kb) {
      if (!bits[kb]) continue;  // uniform across the CTA
      // A sub-block (BM x BK bf16) as 16-byte vectors
      for (int v = tid; v < BM * BK / 8; v += blockDim.x) {
        const int r = v / (BK / 8);
        const int c = (v % (BK / 8)) * 8;
        *reinterpret_cast<uint4*>(&As[r * A_LD + c]) =
            *reinterpret_cast<const uint4*>(a_strip + (size_t)r * tile_c +
                                            kb * BK + c);
      }
      // x rows of this sub-block, split into TERMS bf16 parts on load
      for (int e = tid; e < BK * BN; e += blockDim.x) {
        const int r = e / BN;
        const int c = e % BN;
        const int gr = xrow0 + kb * BK + r;
        const int gc = col0 + c;
        float rem = (gr < n && gc < b) ? x[(size_t)gr * b + gc] : 0.0f;
#pragma unroll
        for (int k = 0; k < TERMS; ++k) {
          const __nv_bfloat16 h = __float2bfloat16_rn(rem);
          Xs[k][r * X_LD + c] = h;
          rem -= __bfloat162float(h);
        }
      }
      __syncthreads();
      // The hi term accumulates straight into the running sum. The lower
      // terms of this sub-block go to a fresh tensor-core accumulator of
      // their own, added to the running sum with round-to-nearest f32 adds:
      // the tensor cores' accumulation truncates, and this keeps the small
      // terms from being added (and truncated) at the magnitude of y.
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> lo[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(lo[i][j], 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], &As[(wm * 32 + i * 16) * A_LD + kk],
                                 A_LD);
#pragma unroll
        for (int k = 0; k < TERMS; ++k) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              bf[2];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(
                bf[j], &Xs[k][kk * X_LD + wn * 32 + j * 16], X_LD);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (k == 0)
                wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
              else
                wmma::mma_sync(lo[i][j], af[i], bf[j], lo[i][j]);
            }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e)
            acc[i][j].x[e] += lo[i][j].x[e];
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + i * 16) * C_LD + wn * 32 + j * 16],
                              acc[i][j], C_LD, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += blockDim.x) {
    const int r = e / BN;
    const int c = e % BN;
    const int gr = row0 + r;
    const int gc = col0 + c;
    if (gr < n && gc < b) y[(size_t)gr * b + gc] = Cs[r * C_LD + c];
  }
}

__device__ __forceinline__ float fused_madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_madd(double a, double b, double c) {
  return fma(a, b, c);
}

// K2: 256 threads, each owns a 4 x 4 register block of the CTA's 64 x 64 y
// tile (rows ty + 16i, columns tx + 16j: conflict-free shared reads).
template <typename T>
__global__ void __launch_bounds__(256) bsr_super_full_kernel(
    const T* __restrict__ atiles, const int* __restrict__ slab,
    const int* __restrict__ sup_ptr, const uint8_t* __restrict__ blkmask,
    const T* __restrict__ x, T* __restrict__ y, int tile_r, int tile_c, int n,
    int b) {
  __shared__ T As[BM][BK + 1];
  __shared__ T Xs[BK][BN];

  const int strips = tile_r / BM;
  const int kblocks = tile_c / BK;
  const int s = blockIdx.x / strips;
  const int strip = blockIdx.x % strips;
  const int row0 = s * tile_r + strip * BM;
  const int col0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  const int t_end = sup_ptr[s + 1];
  for (int t = sup_ptr[s]; t < t_end; ++t) {
    const uint8_t* bits = blkmask + ((size_t)t * strips + strip) * kblocks;
    const T* a_strip =
        atiles + (size_t)t * tile_r * tile_c + (size_t)strip * BM * tile_c;
    const int xrow0 = slab[t] * tile_c;
    for (int kb = 0; kb < kblocks; ++kb) {
      if (!bits[kb]) continue;  // uniform across the CTA
      for (int e = tid; e < BM * BK; e += blockDim.x) {
        const int r = e / BK;
        const int c = e % BK;
        As[r][c] = a_strip[(size_t)r * tile_c + kb * BK + c];
      }
      for (int e = tid; e < BK * BN; e += blockDim.x) {
        const int r = e / BN;
        const int c = e % BN;
        const int gr = xrow0 + kb * BK + r;
        const int gc = col0 + c;
        Xs[r][c] = (gr < n && gc < b) ? x[(size_t)gr * b + gc] : T(0);
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        T av[4], xv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = Xs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fused_madd(av[i], xv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gr = row0 + ty + 16 * i;
    if (gr >= n) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gc = col0 + tx + 16 * j;
      if (gc < b) y[(size_t)gr * b + gc] = acc[i][j];
    }
  }
}

bool bad_shape(int nsup, int tile_r, int tile_c, int n, int b) {
  return nsup <= 0 || n <= 0 || b <= 0 || tile_r <= 0 || tile_c <= 0 ||
         tile_r % BM != 0 || tile_c % BK != 0 || (b + BN - 1) / BN > 65535;
}

template <typename T>
int launch_full(const void* atiles, const void* slab, const void* sup_ptr,
                const void* blkmask, const void* x, void* y, int nsup,
                int tile_r, int tile_c, int n, int b, void* stream) {
  if (bad_shape(nsup, tile_r, tile_c, n, b))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsup * (tile_r / BM), (b + BN - 1) / BN);
  bsr_super_full_kernel<T><<<grid, 256, 0, (cudaStream_t)stream>>>(
      (const T*)atiles, (const int*)slab, (const int*)sup_ptr,
      (const uint8_t*)blkmask, (const T*)x, (T*)y, tile_r, tile_c, n, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: y (n, b) f32 = A (bf16 tiles) @ x (n, b) f32, x split into `terms` bf16
// parts (2 or 3).
int krt_bsr_super_bf16(const void* atiles, const void* slab,
                       const void* sup_ptr, const void* blkmask, const void* x,
                       void* y, int nsup, int tile_r, int tile_c, int n, int b,
                       int terms, void* stream) {
  if (bad_shape(nsup, tile_r, tile_c, n, b))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nsup * (tile_r / BM), (b + BN - 1) / BN);
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* a = (const __nv_bfloat16*)atiles;
  const int* sl = (const int*)slab;
  const int* sp = (const int*)sup_ptr;
  const uint8_t* bm = (const uint8_t*)blkmask;
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  switch (terms) {
    case 2:
      bsr_super_bf16_kernel<2><<<grid, 128, 0, st>>>(a, sl, sp, bm, xf, yf,
                                                     tile_r, tile_c, n, b);
      break;
    case 3:
      bsr_super_bf16_kernel<3><<<grid, 128, 0, st>>>(a, sl, sp, bm, xf, yf,
                                                     tile_r, tile_c, n, b);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2 in f32: y (n, b) = A (f32 tiles) @ x (n, b), FFMA only.
int krt_bsr_super_f32(const void* atiles, const void* slab, const void* sup_ptr,
                      const void* blkmask, const void* x, void* y, int nsup,
                      int tile_r, int tile_c, int n, int b, void* stream) {
  return launch_full<float>(atiles, slab, sup_ptr, blkmask, x, y, nsup, tile_r,
                            tile_c, n, b, stream);
}

// K2 in f64: y (n, b) = A (f64 tiles) @ x (n, b), DFMA only.
int krt_bsr_super_f64(const void* atiles, const void* slab, const void* sup_ptr,
                      const void* blkmask, const void* x, void* y, int nsup,
                      int tile_r, int tile_c, int n, int b, void* stream) {
  return launch_full<double>(atiles, slab, sup_ptr, blkmask, x, y, nsup,
                             tile_r, tile_c, n, b, stream);
}

}  // extern "C"
