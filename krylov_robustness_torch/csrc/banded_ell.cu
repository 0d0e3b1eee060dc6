// Banded-ELL SpMM for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernel of krylov_robustness_tpu/ops/pallas_spmm.py:
//   K3  row_gather_kernel<T, T, 1> (csrc/row_gather.cuh) for b >= 32, and
//       banded_ell_kernel for b < 32
//         <-  _banded_kernel (:51, launched by _banded_spmm at :92)
//
// What it computes. The RCM-permuted adjacency is stored as an ELL of K slots
// per row, slot-major: cols[k * n + r], vals[k * n + r] hold the k-th entry of
// row r in sorted CSR order; a row with fewer entries pads its slots with
// val = 0 and col = r. With x row-major (n, b),
//   y[r, c] = sum over the stored entries of row r of vals[k, r] * x[cols[k, r], c],
// one fused multiply-add an entry: FFMA in f32 (never TF32), DFMA in f64.
//
// On the TPU, Mosaic's gather cannot cross a 128-lane vector register, so the
// Pallas kernel transposed x, split the band into 128-lane windows and did one
// masked gather per (slot, window). Hopper gathers from any address, so none
// of that is carried over. Which kernel runs is chosen by the width b, in one
// place, ops/banded_spmm.py::ell_spmm:
//
// b >= 32 (krt_banded_gather_*): the row gather shared with K1, K2 and K4,
// over a CSR row index of the ELL (row_ptr, cols, and val_off = k * n + r,
// the entry's slot in the flattened (K, n) vals). A warp walks the entries of
// 4 consecutive rows as one stream, each lane owns 16 bytes of a column slice
// (4 f32 or 2 f64 columns), and every entry is one coalesced load of an x row
// slice; the sum runs in CSR order, which is slot order. The index holds the
// stored entries only, so a padding slot is never read: on a road network at
// Vermont's scale (n = 95,672, K = 9, mean degree 4.3) a row gathers 4.3 x
// rows, not 9, and reads its column and value once for all b columns.
//
// b < 32 (krt_banded_ell_*): one thread per output y[r, c] loops over the K
// slots of row r in slot order, padding included (at b = 1 a warp reads 32
// neighbouring rows' slots and x values, coalesced).
//
// A padding slot. The ELL kernel adds 0 * x[r, c] for it, which is 0 unless
// x[r, c] is not finite; the row gather adds nothing. For finite x both give
// the slot-order sum of the stored entries; a non-finite x value reaches
// through the row gather only the rows whose entries touch it, as with K1,
// K2 and K4. The plain torch version sums every slot, as the ELL kernel does.
//
// What bounds it on the H100: bytes. x is read from HBM about once per
// column slice (RCM keeps every gathered row within the bandwidth, ~200 rows,
// of the output row, so the gathers, nnz * b * sizeof(T) bytes, hit L1 and
// L2), y is written once, and the tables are read once: at b = 100 in f32 on
// that road network ~38 MB of x, 38 MB of y and ~5 MB of index and values.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>

#include "row_gather.cuh"

namespace {

constexpr int THREADS = 256;

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
    acc = row_gather::fused_madd(vals[slot], x[(size_t)cols[slot] * b + c],
                                 acc);
  }
  y[t] = acc;
}

template <typename T>
int launch_ell(const void* cols, const void* vals, const void* x, void* y,
               int n, int K, int b, void* stream) {
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

// K3 for b < 32 in f32: y (n, b) = ELL(cols, vals) @ x (n, b), FFMA only.
int krt_banded_ell_f32(const void* cols, const void* vals, const void* x,
                       void* y, int n, int K, int b, void* stream) {
  return launch_ell<float>(cols, vals, x, y, n, K, b, stream);
}

// K3 for b < 32 in f64: y (n, b) = ELL(cols, vals) @ x (n, b), DFMA only.
int krt_banded_ell_f64(const void* cols, const void* vals, const void* x,
                       void* y, int n, int K, int b, void* stream) {
  return launch_ell<double>(cols, vals, x, y, n, K, b, stream);
}

// K3 for b >= 32 in f32: y (n, b) = A x (n, b) over the row index (row_ptr
// n + 1, cols and val_off nnz, int32) into the flattened (K, n) f32 vals.
int krt_banded_gather_f32(const void* row_ptr, const void* cols,
                          const void* val_off, const void* vals,
                          const void* x, void* y, int n, int b,
                          void* stream) {
  return row_gather::launch<float, float, 1>(row_ptr, cols, val_off, vals, x,
                                             y, n, b, stream);
}

// K3 for b >= 32 in f64: the same over f64 vals, DFMA only.
int krt_banded_gather_f64(const void* row_ptr, const void* cols,
                          const void* val_off, const void* vals,
                          const void* x, void* y, int n, int b,
                          void* stream) {
  return row_gather::launch<double, double, 1>(row_ptr, cols, val_off, vals,
                                               x, y, n, b, stream);
}

}  // extern "C"
