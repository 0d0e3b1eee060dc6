// Banded-ELL SpMM for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel of krylov_robustness_tpu/ops/pallas_spmm.py:
//   K3  banded_ell_kernel  <-  _banded_kernel (launched by _banded_spmm)
//
// What it computes. The RCM-permuted adjacency is stored as an ELL of K slots
// per row, slot-major: cols[k * n + r], vals[k * n + r] hold the k-th entry of
// row r in sorted CSR order; a row with fewer entries pads its slots with
// val = 0 and col = r. With x row-major (n, b),
//   y[r, c] = sum over k < K of vals[k, r] * x[cols[k, r], c],
// summed in slot order with one fused multiply-add per slot: FFMA in f32
// (never TF32), DFMA in f64. A padding slot adds 0 * x[r, c], which is 0
// unless x[r, c] is not finite; the plain torch version does the same.
//
// On the TPU, Mosaic's gather cannot cross a 128-lane vector register, so the
// Pallas kernel transposed x, split the band into 128-lane windows and did one
// masked gather per (slot, window). Hopper gathers from any address, so none
// of that is carried over: each thread owns one (row, column) output of y and
// reads its K x values directly.
//
// What bounds it on the H100. The kernel does 2 flops per slot for every
// output and reads each x row K times, so it is memory-bound. On a road
// network at Vermont's scale (n = 95,672, K = 9) at b = 100 in f32, one
// product moves about 38 MB of x once, writes 38 MB of y and reads about 7 MB
// of ELL tables: ~83 MB of HBM traffic. What the design does about it:
//   * thread t of the grid owns output (t / b, t % b), so a warp's 32 threads
//     read 32 neighbouring columns of one x row (one coalesced transaction)
//     and write 32 neighbouring y values; at b = 1 they read 32 neighbouring
//     rows' table entries and x values instead;
//   * RCM keeps every gathered row within the bandwidth (~200 rows) of the
//     output row, and neighbouring blocks run at nearly the same rows, so the
//     K re-reads of an x row hit L1/L2, not HBM: x comes from HBM about once;
//   * each output is written once, with no atomics and no second pass;
//   * the table reads of one row are shared by the warp's threads
//     (broadcast), and K is only a loop bound: any K runs, with no shared
//     memory sized by it.
// Faster variants (several columns per thread, staging the band in shared
// memory) are later work.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float fused_madd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fused_madd(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) banded_ell_kernel(
    const int* __restrict__ cols, const T* __restrict__ vals,
    const T* __restrict__ x, T* __restrict__ y, int n, int K, int b) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= (long long)n * b) return;  // ragged edge of the last block
  const int r = (int)(t / b);
  const int c = (int)(t % b);
  T acc = T(0);
  for (int k = 0; k < K; ++k) {
    const size_t slot = (size_t)k * n + r;
    acc = fused_madd(vals[slot], x[(size_t)cols[slot] * b + c], acc);
  }
  y[t] = acc;
}

template <typename T>
int launch(const void* cols, const void* vals, const void* x, void* y, int n,
           int K, int b, void* stream) {
  if (n <= 0 || K <= 0 || b <= 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * b;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  banded_ell_kernel<T><<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const T*)vals, (const T*)x, (T*)y, n, K, b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K3 in f32: y (n, b) = ELL(cols, vals) @ x (n, b), FFMA only.
int krt_banded_ell_f32(const void* cols, const void* vals, const void* x,
                       void* y, int n, int K, int b, void* stream) {
  return launch<float>(cols, vals, x, y, n, K, b, stream);
}

// K3 in f64: y (n, b) = ELL(cols, vals) @ x (n, b), DFMA only.
int krt_banded_ell_f64(const void* cols, const void* vals, const void* x,
                       void* y, int n, int K, int b, void* stream) {
  return launch<double>(cols, vals, x, y, n, K, b, stream);
}

}  // extern "C"
