// Row-gather SpMM over a CSR row index into dense value storage, for Hopper
// (sm_90a). Shared by K1 and K2 (csrc/bsr_super.cu), K3 for b >= 32
// (csrc/banded_ell.cu) and K4 (csrc/bsr_flat.cu).
//
// What it computes. Row r owns the entries e = row_ptr[r] .. row_ptr[r+1] in
// CSR order; entry e has column cols[e] and the value vals[val_off[e]], where
// val_off is an int32 offset into the operator's own dense tile, block or
// ELL storage, flattened. That storage stays the only copy of the values, so a
// value edit in place, a replaced storage tensor over the same packing or an
// explicit-zero slot needs no change here. With x and y row-major (n, b),
//   y[r, c] = sum over e of vals[val_off[e]] * x[cols[e], c],
// one fused multiply-add per entry in CSR order into a sum of type Acc,
// rounded to T once at the store: FFMA for float, DFMA for double (and for
// float x summed in double, K2 in f32), never TF32. Acc defaults to T, and
// then every conversion below is the identity. With TERMS > 1 (K1: bf16 values, f32 x) each gathered
// x value is split in registers into TERMS bf16 parts, each the
// round-to-nearest bf16 of what the earlier parts left; each part's products
// accumulate in an f32 sum of their own, and the sums are added at the end,
// the high part's first.
//
// Mapping (b >= 32). A warp owns a run of ROWS_PER_WARP consecutive rows,
// whose entries are contiguous in CSR order, and walks them as one stream:
// it loads the column and value of 32 entries at a time, one per lane, and
// broadcasts them with __shfl_sync, so a row of a few entries costs no index
// load of its own. Lane l owns VEC consecutive columns c0 + VEC * l .. of the
// CTA's column slice, read as one 16-byte load (VEC = 4 in f32, 2 in f64:
// one entry is one coalesced 512-byte load of an x row slice), or, where b or
// a pointer does not allow 16-byte loads, columns c0 + l and c0 + l + 32.
// The x loads of UNROLL entries are issued before their FMAs, so several are
// in flight. The grid walks row groups fast (blockIdx.x) and column slices
// slow (blockIdx.y), so one x slice stays in L2 while every row group
// gathers from it. For b < 32 the lanes stride over one row's entries
// instead, one column at a time, and the warp reduces each sum with
// __shfl_xor_sync (the sum is then a tree over the lanes, not CSR order).
//
// Each y value is written once; a row without entries is written as 0. No
// atomics, no zero pass, no shared memory, nothing allocated.
//
// The constants were chosen on an NVIDIA H100 80GB HBM3 at 700 W;
// `python3 -m krylov_robustness_torch.tools.probe gather` times them against
// others (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace row_gather {

constexpr int WARPS = 4;  // warps per CTA
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_PER_CTA = WARPS * ROWS_PER_WARP;
constexpr int UNROLL = 4;  // entries whose x loads are issued together
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ float fused_madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_madd(double a, double b, double c) {
  return fma(a, b, c);
}

// acc[k] += a * (part k of xv): xv itself for TERMS = 1, else its bf16 parts.
template <int TERMS, typename Acc, typename T>
__device__ __forceinline__ void accumulate(Acc (&acc)[TERMS], T a, T xv) {
  if constexpr (TERMS == 1) {
    acc[0] = fused_madd(Acc(a), Acc(xv), acc[0]);
  } else {
    float rem = xv;
#pragma unroll
    for (int k = 0; k < TERMS; ++k) {
      const float part = __bfloat162float(__float2bfloat16_rn(rem));
      rem -= part;
      acc[k] = fused_madd(a, part, acc[k]);
    }
  }
}

// The parts' sums added in order: (acc[0] + acc[1]) + acc[2].
template <int TERMS, typename Acc>
__device__ __forceinline__ Acc total(const Acc (&acc)[TERMS]) {
  Acc s = acc[0];
#pragma unroll
  for (int k = 1; k < TERMS; ++k) s = s + acc[k];
  return s;
}

// VEC values of T, loaded and stored as one vector (16 bytes for VEC > 1).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Lane l's REP groups of VEC columns: c0 + (g * 32 + l) * VEC + i. Since
// b % VEC == 0, a group lies in [0, b) whole or not at all.
template <typename T, typename Acc, int TERMS, int VEC, int REP>
struct Lanes {
  int col[REP];
  bool live[REP];
  Acc acc[REP][VEC][TERMS];

  __device__ __forceinline__ Lanes(int c0, int lane, int b) {
#pragma unroll
    for (int g = 0; g < REP; ++g) {
      col[g] = c0 + (g * 32 + lane) * VEC;
      live[g] = col[g] < b;
    }
    clear();
  }
  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int g = 0; g < REP; ++g)
#pragma unroll
      for (int i = 0; i < VEC; ++i)
#pragma unroll
        for (int k = 0; k < TERMS; ++k) acc[g][i][k] = Acc(0);
  }
  // writes the sums into y row yr and starts the next row's from 0
  __device__ __forceinline__ void flush(T* __restrict__ yr) {
#pragma unroll
    for (int g = 0; g < REP; ++g) {
      if (!live[g]) continue;
      Pack<T, VEC> out;
#pragma unroll
      for (int i = 0; i < VEC; ++i) out.v[i] = T(total<TERMS>(acc[g][i]));
      *reinterpret_cast<Pack<T, VEC>*>(yr + col[g]) = out;
    }
    clear();
  }
};

// b >= 32: rows row0 .. row0 + count - 1, their entries as one stream.
template <typename V, typename T, typename Acc, int TERMS, int VEC, int REP>
__device__ __forceinline__ void wide_rows(
    int row0, int count, int lane, int c0, const int* __restrict__ row_ptr,
    const int* __restrict__ cols, const int* __restrict__ val_off,
    const V* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
    int b) {
  Lanes<T, Acc, TERMS, VEC, REP> out(c0, lane, b);
  // lane i <= count holds row_ptr[row0 + i]
  const int my_rp = lane <= count ? row_ptr[row0 + lane] : 0;
  const int e_end = __shfl_sync(FULL, my_rp, count);
  int cur = 0;                              // the row summed now, from row0
  int bound = __shfl_sync(FULL, my_rp, 1);  // the end of its entries
  for (int e0 = __shfl_sync(FULL, my_rp, 0); e0 < e_end; e0 += 32) {
    const int cnt = min(32, e_end - e0);
    int my_col = 0;
    T my_val = T(0);
    if (lane < cnt) {
      my_col = cols[e0 + lane];
      my_val = widen(vals[val_off[e0 + lane]]);
    }
    for (int j = 0; j < cnt; j += UNROLL) {  // uniform across the warp
      T av[UNROLL];
      Pack<T, VEC> xv[UNROLL][REP];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int src = (j + u) & 31;
        const int col = __shfl_sync(FULL, my_col, src);
        av[u] = __shfl_sync(FULL, my_val, src);
        const T* xr = x + (size_t)col * b;
#pragma unroll
        for (int g = 0; g < REP; ++g) {
          if (j + u < cnt && out.live[g]) {
            xv[u][g] = *reinterpret_cast<const Pack<T, VEC>*>(xr + out.col[g]);
          } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) xv[u][g].v[i] = T(0);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j + u >= cnt) break;  // uniform across the warp
        while (e0 + j + u >= bound) {  // rows that end before this entry
          out.flush(y + (size_t)(row0 + cur) * b);
          ++cur;
          bound = __shfl_sync(FULL, my_rp, cur + 1);
        }
#pragma unroll
        for (int g = 0; g < REP; ++g)
#pragma unroll
          for (int i = 0; i < VEC; ++i)
            accumulate<TERMS>(out.acc[g][i], av[u], xv[u][g].v[i]);
      }
    }
  }
  for (; cur < count; ++cur)  // the last row with entries, and empty ones
    out.flush(y + (size_t)(row0 + cur) * b);
}

// b < 32: the lanes stride over one row's entries, one column at a time.
template <typename V, typename T, typename Acc, int TERMS>
__device__ __forceinline__ void narrow_row(
    int r, int lane, const int* __restrict__ row_ptr,
    const int* __restrict__ cols, const int* __restrict__ val_off,
    const V* __restrict__ vals, const T* __restrict__ x, T* __restrict__ y,
    int b) {
  const int e_begin = row_ptr[r];
  const int e_end = row_ptr[r + 1];
  T* yr = y + (size_t)r * b;
  for (int c = 0; c < b; ++c) {
    Acc acc[TERMS];
#pragma unroll
    for (int k = 0; k < TERMS; ++k) acc[k] = Acc(0);
    for (int e = e_begin + lane; e < e_end; e += 32)
      accumulate<TERMS>(acc, T(widen(vals[val_off[e]])),
                        x[(size_t)cols[e] * b + c]);
#pragma unroll
    for (int k = 0; k < TERMS; ++k)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[k] += __shfl_xor_sync(FULL, acc[k], off);
    if (lane == 0) yr[c] = T(total<TERMS>(acc));
  }
}

// V: the storage type of the values; T: the type of x and y; Acc: the type
// of the sums.
template <typename V, typename T, typename Acc, int TERMS, int VEC, int REP>
__global__ void __launch_bounds__(WARPS * 32) row_gather_kernel(
    const int* __restrict__ row_ptr, const int* __restrict__ cols,
    const int* __restrict__ val_off, const V* __restrict__ vals,
    const T* __restrict__ x, T* __restrict__ y, int n, int b) {
  static_assert(TERMS == 1 || sizeof(T) == 4, "bf16 parts split f32 x only");
  const int lane = threadIdx.x % 32;
  const int row0 =
      blockIdx.x * ROWS_PER_CTA + (threadIdx.x / 32) * ROWS_PER_WARP;
  if (row0 >= n) return;  // uniform across the warp
  const int count = min(ROWS_PER_WARP, n - row0);
  if (b < 32) {
    for (int r = row0; r < row0 + count; ++r)
      narrow_row<V, T, Acc, TERMS>(r, lane, row_ptr, cols, val_off, vals, x,
                                   y, b);
  } else {
    wide_rows<V, T, Acc, TERMS, VEC, REP>(row0, count, lane,
                                     blockIdx.y * 32 * VEC * REP, row_ptr,
                                     cols, val_off, vals, x, y, b);
  }
}

template <typename V, typename T, typename Acc, int TERMS, int VEC, int REP>
int launch_grid(const void* row_ptr, const void* cols, const void* val_off,
                const void* vals, const void* x, void* y, int n, int b,
                void* stream) {
  constexpr int slice = 32 * VEC * REP;
  const int slices = b < 32 ? 1 : (b + slice - 1) / slice;
  if (slices > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + ROWS_PER_CTA - 1) / ROWS_PER_CTA, slices);
  row_gather_kernel<V, T, Acc, TERMS, VEC, REP><<<grid, WARPS * 32, 0,
                                                  (cudaStream_t)stream>>>(
      (const int*)row_ptr, (const int*)cols, (const int*)val_off,
      (const V*)vals, (const T*)x, (T*)y, n, b);
  return (int)cudaGetLastError();
}

// Launches the kernel on `stream` and returns cudaGetLastError() (0 =
// success): y (n, b) = A x (n, b) for A given by (row_ptr, cols, val_off,
// vals), each sum accumulated in Acc; the caller checks that the index lies
// inside vals and x. 16-byte loads where b and the pointers allow them, else
// two columns a lane.
template <typename V, typename T, int TERMS, typename Acc = T>
int launch(const void* row_ptr, const void* cols, const void* val_off,
           const void* vals, const void* x, void* y, int n, int b,
           void* stream) {
  if (n <= 0 || b <= 0 || n > 0x7fffffff - ROWS_PER_CTA)
    return (int)cudaErrorInvalidValue;
  constexpr int VEC = 16 / sizeof(T);
  if (b % VEC == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0)
    return launch_grid<V, T, Acc, TERMS, VEC, 1>(row_ptr, cols, val_off, vals,
                                                  x, y, n, b, stream);
  return launch_grid<V, T, Acc, TERMS, 1, 2>(row_ptr, cols, val_off, vals, x,
                                              y, n, b, stream);
}

}  // namespace row_gather
