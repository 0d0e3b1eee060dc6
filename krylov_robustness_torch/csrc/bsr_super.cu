// Super-tile SpMM kernels for Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the Pallas TPU kernels of krylov_robustness_tpu/ops/pallas_bsr_super.py:
//   K1  row_gather_kernel<bf16, float, terms> (csrc/row_gather.cuh)
//         <-  _kernel_bf16 (:97, launched by _tile_spmm_bf16 at :181)
//   K2  row_gather_kernel<float, float, double, 1> (f32 values and x, f64
//         sums) and <double, double, double, 1>
//         <-  _kernel_f32 (:82, launched by _tile_spmm_f32 at :135)
//
// Both kernels read the (RCM-permuted) adjacency through a CSR row index:
// row_ptr, cols, and val_off, the offset of each entry's value in a flat
// value storage. The single-card operator (ops/bsr_super.py) stores its
// values in CSR order, so val_off[e] = e; a row-sharded block reads its
// flattened 512 x 256 super-tiles, the TPU packing. A warp walks the entries
// of a run of consecutive rows, each lane owns 16 bytes of a column slice,
// and every entry is one coalesced load of an x row slice (row_gather.cuh).
//
// K1: y (n, b) f32 = A x for bf16 values (0/+-1 adjacency is
// bf16-exact) and f32 x split into `terms` bf16 parts, y = A x to ~2^-18 (2
// terms) or ~2^-27 (3 terms) relative. x is split into its bf16 parts in
// registers and each part's products accumulate in an f32 sum of their own.
//
// K2: y (n, b) = A x in full f32 or f64, for values that are not bf16-exact
// and for f64: one DFMA an entry into an f64 sum (also for f32 values and x,
// rounded to f32 once at the store; never TF32), in CSR order for b >= 32
// (a row the split plan cuts: in CSR order within each piece, then the
// pieces' sums in order) and as a tree over a warp's lanes for b < 32. A
// sequential f32 sum over a hub row of up to 511 entries sat at the f32 gate
// of 1e-6 of max|y| (PERF.md); the f64 sum costs ~2e8 DFMA at b = 500 on a
// hub graph at ca-AstroPh's scale, against gathers that take ~0.3 ms.
//
// Why the tiles are not computed whole. The TPU packs tiles because its
// matrix unit is dense and Mosaic cannot gather. The tiles are nearly empty:
// on a Chung-Lu hub graph at ca-AstroPh's scale (n = 18,772, 395,524
// nonzeros, 2,538 tiles) a 64 x 32 sub-block holds ~2.3 nonzeros, and on a
// road network at Vermont's scale (n = 95,672, 412,448 nonzeros, 746 tiles)
// the f64 tiles alone are 782 MB, as many bytes as the whole product at
// b = 512 (789 MB with A as CSR). Hopper gathers cheaply, and a gather pays
// for the nonzeros only.
//
// No fill is computed. The dense Pallas tile product, and the earlier
// dense-tile K2 inside an occupied sub-block, added 0 * x for every fill
// position. For finite x that changes nothing (fma(0, x, acc) == acc), so y
// is the same column-ordered sum; a non-finite x value now reaches only the
// rows whose entries touch it, as with K1 and K4.
//
// What bounds both on the H100: bytes. x is read from HBM about once per
// column slice (the slice stays in L2 while every row group gathers from
// it), y is written once, and the gathers, nnz * b * sizeof(x) bytes, come
// from L2 and L1: ~790 MB at b = 500 in f32 on that hub graph, ~845 MB at
// b = 512 in f32 on that road network (1.69 GB in f64), against ~80 MB and
// ~392 MB (~784 MB) through HBM. On the hub graph the gathers miss L1 (no
// locality in any node order), and their rate from L2 sets the time
// (PERF.md). A warp's time is its run's entries, so a run that holds a hub's
// row would be the grid's tail: the single-card operator passes a split
// plan (ops/row_gather.py::split_plan), whose units of at most
// SPLIT_ENTRIES entries take such runs first in each column slice; the
// pieces of a cut row keep their sums in a scratch of (pieces, terms, b) in
// the sum type (f32 parts for K1, f64 for K2) that the caller allocates, and
// a second launch adds them in piece order into y (row_gather.cuh). On a
// road network no run is that long and the plan is empty.
//
// Every entry point launches on the given stream, allocates nothing and returns
// cudaGetLastError() (0 = success). `n` is the number of y rows: x is read
// only through the index's columns, so x may have other rows than y, as in
// a shard's block of a row-sharded operator (parallel/spmm_sharded.py: its
// own rows against its local x or the gathered x); the caller checks that
// every column lies inside x. `plan` is a split plan of the index, or
// nullptr (a shard's block passes none).

#include <cuda_runtime.h>

#include "row_gather.cuh"

extern "C" {

// K1: y (n, b) f32 = A x (n, b) f32 over the row index (row_ptr n + 1,
// cols and val_off nnz, int32) into the flat bf16 values, x split into
// `terms` bf16 parts (2 or 3).
int krt_bsr_super_bf16(const void* row_ptr, const void* cols,
                       const void* val_off, const void* vals, const void* x,
                       void* y, int n, int b, int terms,
                       const row_gather::SplitPlan* plan, void* stream) {
  switch (terms) {
    case 2:
      return row_gather::launch<__nv_bfloat16, float, 2>(
          row_ptr, cols, val_off, vals, x, y, n, b, stream, plan);
    case 3:
      return row_gather::launch<__nv_bfloat16, float, 3>(
          row_ptr, cols, val_off, vals, x, y, n, b, stream, plan);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The sum type of K2 in f32 (`tools/probe.py gather --variants
// K2F32Sum=float` builds the sequential f32 sum it replaced).
using K2F32Sum = double;

// K2 in f32: y (n, b) = A x (n, b) over the row index into the flat f32
// values, each sum in f64 (DFMA) and rounded to f32 once.
int krt_bsr_super_f32(const void* row_ptr, const void* cols,
                      const void* val_off, const void* vals, const void* x,
                      void* y, int n, int b,
                      const row_gather::SplitPlan* plan, void* stream) {
  return row_gather::launch<float, float, 1, K2F32Sum>(
      row_ptr, cols, val_off, vals, x, y, n, b, stream, plan);
}

// K2 in f64: y (n, b) = A x (n, b) over the row index into the flat f64
// values, DFMA only.
int krt_bsr_super_f64(const void* row_ptr, const void* cols,
                      const void* val_off, const void* vals, const void* x,
                      void* y, int n, int b,
                      const row_gather::SplitPlan* plan, void* stream) {
  return row_gather::launch<double, double, 1>(
      row_ptr, cols, val_off, vals, x, y, n, b, stream, plan);
}

}  // extern "C"
