// Flat block-sparse (BSR, 128 x 128 blocks) SpMM for Hopper (sm_90a), bound to
// Python with ctypes.
//
// Replaces the Pallas TPU kernel of krylov_robustness_tpu/ops/pallas_bsr.py:
//   K4  row_gather_kernel<T, T, 1> (csrc/row_gather.cuh)
//         <-  _bsr_kernel (:49, launched by _bsr_spmm at :85)
//
// What it computes. The (RCM-permuted) adjacency is packed into dense 128 x 128
// blocks sorted by row block; the blocks stay the only copy of the values.
// The kernel reads them through a CSR row index of the packing: row_ptr
// (n + 1), cols and val_off (nnz, int32), where val_off is the offset of
// each entry's value in the flattened blocks (block * 16384 + offset in the
// block). With x row-major (n, b),
//   y[r, c] = sum over the entries e of row r of ablocks[val_off[e]] * x[cols[e], c],
// in full precision, as the TPU kernel's Precision.HIGHEST: one FFMA (f32,
// never TF32) or DFMA (f64) per entry, in CSR order for b >= 32 and as a
// tree over a warp's lanes for b < 32. The plain torch version sums in
// another order, so the two agree to rounding, not bit for bit.
//
// Why the blocks are not computed whole. On the TPU the grid ran block by
// block and accumulated into a resident y tile, because its matrix unit is
// dense and Mosaic cannot gather. On a road network at Vermont's scale a
// block is 1.08% full: computing 2,336 blocks whole at b = 512 is 39.2 GFLOP
// of FFMA for 0.42 GFLOP of useful work. Hopper gathers cheaply, and a gather
// pays for the nonzeros only: a warp walks the entries of a run of
// consecutive rows, each lane owns 16 bytes of a column slice (four f32 or
// two f64 columns), and every entry is one coalesced load of an x row slice
// (row_gather.cuh). For b < 32 the lanes stride over a row's entries, so a
// vector product does not leave 31 of 32 lanes idle.
//
// What bounds it on the H100: bytes. x is read from HBM about once per
// column slice (the slice stays in L2 while every row group gathers from it),
// y is written once, and the gathers, nnz * b * sizeof(T) bytes, come from L2
// and L1 (RCM keeps a row's columns near it, so most hit L1): ~845 MB at
// b = 512 in f32 on that road network, against ~392 MB through HBM.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>

#include "row_gather.cuh"

extern "C" {

// K4 in f32: y (n, b) = A x (n, b) for f32 blocks, FFMA only.
int krt_bsr_flat_f32(const void* row_ptr, const void* cols,
                     const void* val_off, const void* ablocks, const void* x,
                     void* y, int n, int b, void* stream) {
  return row_gather::launch<float, float, 1>(row_ptr, cols, val_off, ablocks,
                                             x, y, n, b, stream);
}

// K4 in f64: y (n, b) = A x (n, b) for f64 blocks, DFMA only.
int krt_bsr_flat_f64(const void* row_ptr, const void* cols,
                     const void* val_off, const void* ablocks, const void* x,
                     void* y, int n, int b, void* stream) {
  return row_gather::launch<double, double, 1>(row_ptr, cols, val_off,
                                               ablocks, x, y, n, b, stream);
}

}  // extern "C"
