"""Super-tile block-sparse SpMM operator with hand-written Hopper kernels.

Port of ``krylov_robustness_tpu/ops/pallas_bsr_super.py``. The (RCM-permuted)
matrix is packed into dense ``tile_r × tile_c`` super-tiles (default
512 × 256), one per (super-row, column-slab) pair that holds an entry, sorted
by super-row; every super-row owns at least one tile so every y row is
written. The packing (``atiles``, ``slab``/``sup``/``start``, the entry maps)
equals the JAX package's.

Two kernels in ``csrc/bsr_super.cu`` compute ``A @ x`` over that packing:

* K1 (``tile_spmm_bf16``) replaces ``_kernel_bf16``: A stored in bf16
  (bf16-exact 0/±1 adjacency), x split into ``terms`` bf16 parts on load,
  bf16 tensor cores with f32 accumulation — modes ``bf16x2``/``bf16x3``.
* K2 (``tile_spmm_full``) replaces ``_kernel_f32``: the same schedule in full
  f32 or f64 with FFMA/DFMA — mode ``f32`` (f32 or f64 storage).

Beside each kernel is its plain torch version (a batched tile product plus
``index_add_`` by super-row). :meth:`SuperBsrOperator.matmul` runs the plain
version for CPU tensors only; a CUDA tensor launches the kernel or raises.
The kernels are built with ``nvcc`` at first use into ``build/kernels/``
(keyed on a hash of the source and flags) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import torch

from ..utils.device import float_dtype, resolve_device

BLK = 128
SUP = 4  # 128-row blocks per super-row (tile height 512)
SLAB = 2  # 128-col blocks per x slab (tile width 256)
TILE_R = SUP * BLK
TILE_C = SLAB * BLK
# sub-block of the kernels' structural bitmap: must equal the CTA row strip
# (BM) and the reduction chunk (BK) compiled into csrc/bsr_super.cu
MASK_BM = 64
MASK_BK = 32
MODES = ("f32", "bf16x2", "bf16x3")

# launch counts of K1 and K2 (K2 counts both its f32 and f64 instantiation);
# each wrapper adds one where it launches its kernel and nowhere else
launches_bf16 = 0
launches_f32 = 0

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "bsr_super.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
_LIB = None


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _n_pad(n: int, tile_r: int, tile_c: int) -> int:
    return _round_up(max(n, tile_r), int(np.lcm(tile_r, tile_c)))


# -- packing ---------------------------------------------------------------
def pack_bsr_super(A_scipy, tile_r: int = TILE_R, tile_c: int = TILE_C, *,
                   dtype=torch.float64, device):
    """Pack a (RCM-permuted) scipy matrix into super-tiles.

    Returns (atiles (ntile, tile_r, tile_c) in ``dtype`` on ``device``, meta
    = (slab, sup, start) int32 sorted by (super, slab), entry_tile,
    entry_offset, n_pad); the entry arrays map CSR-order nnz index → (tile,
    flat offset). ``atiles`` is filled in its storage dtype straight from the
    nonzeros, never through a dense f64 host array.
    """
    A = sp.csr_matrix(A_scipy)
    A.sort_indices()
    n = A.shape[0]
    n_pad = _n_pad(n, tile_r, tile_c)
    nslab = n_pad // tile_c
    nsup = n_pad // tile_r
    coo = A.tocoo()
    key = (coo.row // tile_r).astype(np.int64) * nslab + coo.col // tile_c
    uniq = np.unique(key)
    # every super-row needs ≥1 tile so its y rows are written
    missing = np.setdiff1d(np.arange(nsup), np.unique(uniq // nslab))
    if len(missing):
        extra = missing.astype(np.int64) * nslab + np.minimum(missing,
                                                              nslab - 1)
        uniq = np.unique(np.concatenate([uniq, extra]))
    ntile = len(uniq)
    sup = (uniq // nslab).astype(np.int32)
    slab = (uniq % nslab).astype(np.int32)
    start = np.zeros(ntile, dtype=np.int32)
    start[np.unique(sup, return_index=True)[1]] = 1
    entry_tile = np.searchsorted(uniq, key).astype(np.int64)
    entry_offset = ((coo.row % tile_r).astype(np.int64) * tile_c
                    + coo.col % tile_c).astype(np.int64)
    dev = resolve_device(device)
    atiles = torch.zeros((ntile, tile_r, tile_c), dtype=dtype, device=dev)
    atiles.view(ntile, -1)[
        torch.as_tensor(entry_tile, device=dev),
        torch.as_tensor(entry_offset, device=dev),
    ] = torch.as_tensor(coo.data, device=dev).to(dtype)
    return atiles, (slab, sup, start), entry_tile, entry_offset, n_pad


def super_tile_count(A_scipy, perm: np.ndarray | None = None,
                     tile_r: int = TILE_R, tile_c: int = TILE_C) -> int:
    """Number of super-tiles (incl. per-super fill-ins) under ``perm``."""
    C = sp.coo_matrix(A_scipy)
    row, col = C.row, C.col
    if perm is not None:
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
        row, col = pinv[row], pinv[col]
    n_pad = _n_pad(A_scipy.shape[0], tile_r, tile_c)
    nslab = n_pad // tile_c
    key = (row // tile_r).astype(np.int64) * nslab + col // tile_c
    uniq = np.unique(key)
    nsup_missing = len(np.setdiff1d(np.arange(n_pad // tile_r),
                                    np.unique(uniq // nslab)))
    return len(uniq) + nsup_missing


def bf16_split(x: torch.Tensor, terms: int) -> torch.Tensor:
    """x (f32) → [hi | lo | ...] bf16 parts concatenated along axis 1; each
    part is the round-to-nearest bf16 of what the previous ones left."""
    parts = []
    r = x
    for _ in range(terms):
        h = r.to(torch.bfloat16)
        parts.append(h)
        r = r - h.to(r.dtype)
    return torch.cat(parts, dim=1)


# -- plain versions (CPU path, and the kernels' on-card reference) ---------
def tile_spmm_bf16_plain(atiles, slab, sup, x, n_pad: int, terms: int):
    """Plain twin of K1: per term, batched f32 tile products over the x
    slabs, folded term-wise, then ``index_add_`` into y by super-row."""
    n, b = x.shape
    ntile, tile_r, tile_c = atiles.shape
    xp = torch.zeros((n_pad, b), dtype=torch.float32, device=x.device)
    xp[:n] = x
    xcat = bf16_split(xp, terms).view(n_pad // tile_c, tile_c, terms * b)
    p = torch.bmm(atiles.float(), xcat[slab.long()].float())
    s = p[..., :b]
    for k in range(1, terms):
        s = s + p[..., k * b:(k + 1) * b]
    y = torch.zeros((n_pad // tile_r, tile_r, b), dtype=torch.float32,
                    device=x.device)
    y.index_add_(0, sup.long(), s)
    return y.view(n_pad, b)[:n]


def tile_spmm_full_plain(atiles, slab, sup, x, n_pad: int):
    """Plain twin of K2: batched tile products in the compute dtype, then
    ``index_add_`` into y by super-row."""
    n, b = x.shape
    ntile, tile_r, tile_c = atiles.shape
    xp = torch.zeros((n_pad, b), dtype=x.dtype, device=x.device)
    xp[:n] = x
    xs = xp.view(n_pad // tile_c, tile_c, b)[slab.long()]
    p = torch.bmm(atiles.to(x.dtype), xs)
    y = torch.zeros((n_pad // tile_r, tile_r, b), dtype=x.dtype,
                    device=x.device)
    y.index_add_(0, sup.long(), p)
    return y.view(n_pad, b)[:n]


# -- kernel build and binding ----------------------------------------------
def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the super-tile kernels need the "
                           "CUDA toolkit to build")
    return path


def build_kernels() -> tuple[Path, float]:
    """Compile ``csrc/bsr_super.cu`` for sm_90a into ``build/kernels/`` unless
    a library built from the same source and flags is there. Returns (library
    path, seconds spent compiling — 0.0 when it was already built)."""
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = _BUILD_DIR / f"libbsr_super_{digest[:16]}.so"
    if lib.exists():
        return lib, 0.0
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {_SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib, time.perf_counter() - t0


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build_kernels()[0]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.krt_bsr_super_bf16.argtypes = [ptr] * 6 + [i32] * 6 + [ptr]
        for name in ("krt_bsr_super_f32", "krt_bsr_super_f64"):
            getattr(lib, name).argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        for name in ("krt_bsr_super_bf16", "krt_bsr_super_f32",
                     "krt_bsr_super_f64"):
            getattr(lib, name).restype = i32
        _LIB = lib
    return _LIB


def _check_launch_args(atiles, slab, sup_ptr, blkmask, x, store, compute):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"the super-tile kernels run on CUDA tensors, got {dev}")
    for name, t, dt in (("atiles", atiles, store), ("slab", slab, torch.int32),
                        ("sup_ptr", sup_ptr, torch.int32),
                        ("blkmask", blkmask, torch.uint8), ("x", x, compute)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ntile, tile_r, tile_c = atiles.shape
    if x.ndim != 2 or x.shape[0] == 0 or x.shape[1] == 0:
        raise ValueError(f"x must be a non-empty (n, b) matrix, got "
                         f"{tuple(x.shape)}")
    if tile_r % MASK_BM or tile_c % MASK_BK:
        raise ValueError(f"tile {tile_r}x{tile_c} is not a multiple of the "
                         f"kernels' {MASK_BM}x{MASK_BK} sub-block")
    if slab.shape != (ntile,) or blkmask.shape != (
            ntile, (tile_r // MASK_BM) * (tile_c // MASK_BK)):
        raise ValueError("slab/blkmask do not match atiles")
    nsup = sup_ptr.shape[0] - 1
    if nsup * tile_r < x.shape[0] or x.shape[0] > 2**31 - 1:
        raise ValueError(f"x has {x.shape[0]} rows, the tiles cover "
                         f"{nsup * tile_r}")
    return nsup, tile_r, tile_c


def _raise_on(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {code}")


def tile_spmm_bf16(atiles, slab, sup_ptr, blkmask, x, terms: int):
    """K1: y (n, b) f32 = A @ x for bf16 tiles and f32 x (n, b), x split
    into ``terms`` bf16 parts inside the kernel."""
    global launches_bf16
    nsup, tile_r, tile_c = _check_launch_args(
        atiles, slab, sup_ptr, blkmask, x, torch.bfloat16, torch.float32)
    if terms not in (2, 3):
        raise ValueError(f"terms must be 2 or 3, got {terms}")
    n, b = x.shape
    y = torch.empty((n, b), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.krt_bsr_super_bf16(
            atiles.data_ptr(), slab.data_ptr(), sup_ptr.data_ptr(),
            blkmask.data_ptr(), x.data_ptr(), y.data_ptr(), nsup, tile_r,
            tile_c, n, b, terms, stream)
    _raise_on(code, "krt_bsr_super_bf16")
    launches_bf16 += 1
    return y


def tile_spmm_full(atiles, slab, sup_ptr, blkmask, x):
    """K2: y (n, b) = A @ x with A and x both f32 or both f64 (FFMA/DFMA)."""
    global launches_f32
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"K2 takes float32 or float64, got {x.dtype}")
    nsup, tile_r, tile_c = _check_launch_args(
        atiles, slab, sup_ptr, blkmask, x, x.dtype, x.dtype)
    n, b = x.shape
    y = torch.empty((n, b), dtype=x.dtype, device=x.device)
    lib = _library()
    fn = (lib.krt_bsr_super_f32 if x.dtype == torch.float32
          else lib.krt_bsr_super_f64)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(atiles.data_ptr(), slab.data_ptr(), sup_ptr.data_ptr(),
                  blkmask.data_ptr(), x.data_ptr(), y.data_ptr(), nsup,
                  tile_r, tile_c, n, b, stream)
    _raise_on(code, fn.__name__)
    launches_f32 += 1
    return y


# -- the operator ------------------------------------------------------------
class SuperBsrOperator:
    """Super-tile block-sparse SpMM operator with a frozen sparsity structure.

    ``matmul`` on (n, b) blocks or (n,) vectors; ``update_entry_values`` /
    ``set_edge`` edit values of existing entries in place. mode ``f32`` runs
    K2 in the compute dtype; ``bf16xN`` (N = 2, 3) stores A in bf16 (values
    must be bf16-exact) and runs K1 with x split into N bf16 parts — ~2^-18
    (N=2) / ~2^-27 (N=3) relative error. ``auto`` picks ``bf16x2`` for
    bf16-exact values in f32 and ``f32`` otherwise.
    """

    # Plain (CPU) path only: batches wider than MAX_B run as column chunks,
    # which bounds the tile products' scratch; results are identical. The
    # kernels take any width.
    MAX_B = 1024

    def __init__(self, A_scipy, *, dtype=torch.float32, device,
                 mode: str = "auto", tile: tuple[int, int] = (TILE_R, TILE_C)):
        A = sp.csr_matrix(A_scipy)
        A.sort_indices()
        dtype = float_dtype(dtype)
        if mode == "auto":
            # bf16x2's ~2^-18 error equals the f32 trace-update convergence
            # floor (32·eps_f32, updates/trace_update.py), so for bf16-exact
            # values it is accuracy-consistent with the f32 path. Exactness is
            # checked on the stored values only (the fill is zero).
            vals = torch.as_tensor(A.data.astype(np.float64))
            exact = bool(torch.all(vals.to(torch.bfloat16).double() == vals))
            mode = "bf16x2" if (exact and dtype == torch.float32) else "f32"
        if mode not in MODES:
            raise ValueError(f"mode must be 'auto' or one of {MODES}")
        store = torch.bfloat16 if mode.startswith("bf16x") else dtype
        atiles, meta, et, eo, n_pad = pack_bsr_super(
            A, tile[0], tile[1], dtype=store, device=device)
        coo = A.tocoo()
        self._setup(atiles, meta, et, eo,
                    (coo.row.astype(np.int64), coo.col.astype(np.int64)),
                    A.shape[0], n_pad, mode, dtype)

    @classmethod
    def from_packed(cls, atiles: torch.Tensor, meta, entry_tile, entry_offset,
                    entry_rc, n: int, n_pad: int, mode: str, dtype):
        """Operator over an existing packing (tiles already in their storage
        dtype and on their device)."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}")
        obj = cls.__new__(cls)
        obj._setup(atiles, tuple(np.array(m, np.int32) for m in meta),
                   np.array(entry_tile, np.int64),
                   np.array(entry_offset, np.int64),
                   tuple(np.array(a, np.int64) for a in entry_rc),
                   int(n), int(n_pad), mode, float_dtype(dtype))
        return obj

    def _setup(self, atiles, meta, entry_tile, entry_offset, entry_rc, n,
               n_pad, mode, dtype):
        ntile, tile_r, tile_c = atiles.shape
        if tile_r % MASK_BM or tile_c % MASK_BK:
            raise ValueError(f"tile must be a multiple of {MASK_BM}x{MASK_BK}")
        self.n = n
        self.nnz = len(entry_tile)
        self.n_pad = n_pad
        self.mode = mode
        self.dtype = dtype  # compute dtype of the products
        self.atiles = atiles
        self.meta = meta  # (slab, sup, start) int32, as packed
        self._entry_tile = entry_tile
        self._entry_offset = entry_offset
        self._entry_rc = entry_rc
        # CSR order ⇒ row-major keys ascending: (i, j) → entry by searchsorted
        self._entry_keys = entry_rc[0] * n + entry_rc[1]
        slab, sup, _ = meta
        dev = atiles.device
        self._slab = torch.as_tensor(slab, device=dev)
        self._sup = torch.as_tensor(sup, device=dev)
        self._sup_ptr = torch.as_tensor(
            np.searchsorted(sup, np.arange(n_pad // tile_r + 1)).astype(
                np.int32), device=dev)
        # structural bitmap of (MASK_BM × MASK_BK) sub-blocks: frozen-structure
        # edits only touch existing entries, so it never goes stale
        kblocks = tile_c // MASK_BK
        mask = np.zeros((ntile, (tile_r // MASK_BM) * kblocks), np.uint8)
        mask[entry_tile, (entry_offset // tile_c // MASK_BM) * kblocks
             + (entry_offset % tile_c) // MASK_BK] = 1
        self._blkmask = torch.as_tensor(mask, device=dev)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def device(self) -> torch.device:
        return self.atiles.device

    @property
    def ntiles(self) -> int:
        return int(self.atiles.shape[0])

    def storage_bytes(self) -> int:
        return self.atiles.numel() * self.atiles.element_size()

    def with_tiles(self, atiles: torch.Tensor) -> "SuperBsrOperator":
        """The same operator over replacement tile storage (no copy)."""
        if atiles.shape != self.atiles.shape or atiles.dtype != self.atiles.dtype:
            raise ValueError("replacement tiles must match shape and dtype")
        obj = object.__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj.atiles = atiles
        return obj

    # -- frozen-structure value edits ---------------------------------------
    def update_entry_values(self, entry_indices, values) -> None:
        """Set values of specific nnz entries (CSR order), in place."""
        idx = np.asarray(entry_indices, np.int64)
        dev = self.atiles.device
        flat = self.atiles.view(self.atiles.shape[0], -1)
        flat[torch.as_tensor(self._entry_tile[idx], device=dev),
             torch.as_tensor(self._entry_offset[idx], device=dev)] = (
            torch.as_tensor(np.asarray(values, np.float64), device=dev).to(
                self.atiles.dtype))

    def entry_index(self, i, j):
        """CSR-order entry index of (i, j); arrays give arrays."""
        keys = self._entry_keys
        key = np.asarray(i, np.int64) * self.n + np.asarray(j, np.int64)
        pos = np.minimum(np.searchsorted(keys, key), max(len(keys) - 1, 0))
        if not len(keys) or not np.all(keys[pos] == key):
            raise KeyError(f"no stored entry at ({i}, {j})")
        return int(pos) if np.ndim(pos) == 0 else pos

    def set_edge(self, i: int, j: int, value: float) -> None:
        idx = [self.entry_index(i, j)]
        if i != j:
            idx.append(self.entry_index(j, i))
        self.update_entry_values(np.asarray(idx), np.full(len(idx), value))

    def entry_values(self) -> np.ndarray:
        """Current values of all nnz entries in CSR order, as f32."""
        dev = self.atiles.device
        flat = self.atiles.view(self.atiles.shape[0], -1)
        return flat[torch.as_tensor(self._entry_tile, device=dev),
                    torch.as_tensor(self._entry_offset, device=dev)].to(
            torch.float32).cpu().numpy()

    # -- linear algebra ------------------------------------------------------
    def _terms(self) -> int:
        return int(self.mode[-1]) if self.mode.startswith("bf16x") else 0

    def _compute_dtype(self) -> torch.dtype:
        return torch.float32 if self._terms() else self.dtype

    def _plain(self, x: torch.Tensor) -> torch.Tensor:
        if self._terms():
            return tile_spmm_bf16_plain(self.atiles, self._slab, self._sup, x,
                                        self.n_pad, self._terms())
        return tile_spmm_full_plain(self.atiles, self._slab, self._sup, x,
                                    self.n_pad)

    def _prepare(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.atiles.device:
            raise ValueError(f"x is on {x.device}, the operator on "
                             f"{self.atiles.device}")
        if x.shape[0] != self.n:
            raise ValueError(f"x has {x.shape[0]} rows, A is {self.n}x{self.n}")
        return x.to(self._compute_dtype()).contiguous()

    def matmul_plain(self, x: torch.Tensor) -> torch.Tensor:
        """The plain torch version on any device (the kernels' reference)."""
        squeeze = x.ndim == 1
        xc = self._prepare(x[:, None] if squeeze else x)
        b = xc.shape[1]
        y = torch.cat([self._plain(xc[:, s:s + self.MAX_B])
                       for s in range(0, b, self.MAX_B)], dim=1) \
            if b > self.MAX_B else self._plain(xc)
        y = y.to(x.dtype)
        return y[:, 0] if squeeze else y

    def matmul(self, x: torch.Tensor) -> torch.Tensor:
        if x.device.type == "cpu":
            return self.matmul_plain(x)
        if x.device.type != "cuda":
            raise ValueError(f"unsupported device {x.device}")
        squeeze = x.ndim == 1
        xc = self._prepare(x[:, None] if squeeze else x)
        if self._terms():
            y = tile_spmm_bf16(self.atiles, self._slab, self._sup_ptr,
                               self._blkmask, xc, self._terms())
        else:
            y = tile_spmm_full(self.atiles, self._slab, self._sup_ptr,
                               self._blkmask, xc)
        y = y.to(x.dtype)
        return y[:, 0] if squeeze else y

    def __matmul__(self, x):
        return self.matmul(x)
