// Super-tile SpMM kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of krylov_robustness_tpu/ops/pallas_bsr_super.py:
//   K1  row_gather_kernel<bf16, float, terms> (csrc/row_gather.cuh)
//         <-  _kernel_bf16 (:97, launched by _tile_spmm_bf16 at :181)
//   K2  bsr_super_full_kernel  <-  _kernel_f32 (:82, launched at :135)
//
// The (RCM-permuted) adjacency is packed into dense tile_r x tile_c
// super-tiles (default 512 x 256), sorted by super-row; tile t covers rows
// sup(t)*tile_r.. and columns slab[t]*tile_c...
//
// K1: y (n, b) f32 = A x for bf16 tile values (0/+-1 adjacency is
// bf16-exact) and f32 x split into `terms` bf16 parts, y = A x to ~2^-18 (2
// terms) or ~2^-27 (3 terms) relative. It is a row gather over a CSR row
// index of the packing (row_ptr, cols, and val_off, the offset of each
// entry's value in the flattened tiles): a warp walks the entries of a run of
// consecutive rows, each lane owns four consecutive columns of a 128-column
// slice (one 16-byte load), and every entry is one coalesced load of an x row
// slice; x is split into its bf16 parts in registers and each part's
// products accumulate in an f32 sum of their own (row_gather.cuh). The tiles
// stay the only copy of the values and are read at the entries only.
//
// Why the tiles and tensor cores were dropped for K1. The TPU packs tiles
// because its matrix unit is dense and Mosaic cannot gather. The tiles are
// nearly empty: on a Chung-Lu hub graph at ca-AstroPh's scale (n = 18,772,
// 395,524 nonzeros, 2,538 tiles) a 64 x 32 sub-block holds ~2.3 nonzeros, so
// a tensor-core schedule over the occupied sub-blocks did ~665 GFLOP of bf16
// work for 0.4 GFLOP of useful work, and at the card's full 989 TFLOP/s that
// alone takes ~0.67 ms, above cuSPARSE's product on the same graph (NVIDIA
// H100 80GB HBM3, 700 W). Hopper gathers cheaply, and a gather pays for the
// nonzeros only.
//
// What bounds K1 on the H100: bytes. x is read from HBM about once per
// column slice (the slice stays in L2 while every row group gathers from
// it), y is written once, and the gathers, nnz * b * 4 bytes, come from L2
// and L1: ~790 MB at b = 500 on that hub graph, ~845 MB at b = 512 on a road
// network at Vermont's scale, against ~80 MB and ~392 MB through HBM. On the
// hub graph the gathers miss L1 (no locality in any node order), and their
// rate from L2 sets the time (PERF.md).
//
// K2 is the dense-tile schedule in full f32 or f64 with plain FFMA/DFMA (no
// TF32), for values that are not bf16-exact and for f64: one CTA owns one
// (64-row strip of a super-row, 64-column batch tile) of y, walks that
// super-row's tiles (sup_ptr[s] .. sup_ptr[s+1]), keeps the sum in registers
// and writes y once. Each tile carries a structural bitmap of its 64 x 32
// sub-blocks (built at pack time; frozen-structure edits never change it), and
// a CTA skips every sub-block that holds no entry.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

#include "row_gather.cuh"

namespace {

// BM and BK are also the bitmap's sub-block; MASK_BM and MASK_BK of
// ops/bsr_super.py, which packs the bitmap, must equal them.
constexpr int BM = 64;  // y rows per CTA (strip of a super-row)
constexpr int BN = 64;  // batch columns per CTA
constexpr int BK = 32;  // tile columns per reduction chunk (= one bitmap bit)

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

// K1: y (n, b) f32 = A x (n, b) f32 over the row index (row_ptr n + 1,
// cols and val_off nnz, int32) into the flattened bf16 tiles, x split into
// `terms` bf16 parts (2 or 3).
int krt_bsr_super_bf16(const void* row_ptr, const void* cols,
                       const void* val_off, const void* atiles, const void* x,
                       void* y, int n, int b, int terms, void* stream) {
  switch (terms) {
    case 2:
      return row_gather::launch<__nv_bfloat16, float, 2>(
          row_ptr, cols, val_off, atiles, x, y, n, b, stream);
    case 3:
      return row_gather::launch<__nv_bfloat16, float, 3>(
          row_ptr, cols, val_off, atiles, x, y, n, b, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
