"""The block Lanczos step after its SpMM: two MGS passes against the
two-block window, Cholesky QR with per-column deflation, and the breakdown
masks (``lanczos_krylov.m:73-101``).

:func:`block_mgs` takes the n-major blocks ``v_prev``, ``v_cur`` and
``w = A·v_cur`` (n, batch, bs) of ``krylov/lanczos.py::lanczos_step`` and
returns the new ``v_cur``, ``h``, ``beta`` and ``alive``. CPU tensors run
:func:`block_mgs_plain`, the torch einsum step; CUDA tensors run the
hand-written kernel chain of ``csrc/block_mgs.cu`` (no TPU kernel stands
behind it: the JAX package leaves these products to XLA), or raise where the
kernel does not take them (:func:`on_kernel_path`). Blocks of up to
:data:`MAX_BS` columns (every greedy caller's bs = 2) take its narrow
chain, a lane a member; wider ones (a joint edit's rescoring, the weighted
objective) its wide chain, a tile of Gram coefficients a CTA. The kernel
sums its Gram products in f64 and works in the blocks' type otherwise; each
step it runs adds the batch to the counter ``krylov.steps_kernel`` and its
launches to ``krylov.launches.MGS``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import tracing
from . import cuda_build

MAX_BS = 4  # the narrow chain's templates cover bs = 1 … 4
LAUNCHES = {"narrow": 7, "wide": 9}  # kernel launches a step of each chain
TILE = 32  # the wide chain's tile edge
GRID_Y = 65535  # the largest y and z extent of a CUDA grid
# the kernel splits the rows into slabs so that about this many of its
# 256-thread CTAs run on each SM whatever the batch and width, each slab at
# least MIN_SLAB_ROWS rows long
CTAS_PER_SM = 4
MIN_SLAB_ROWS = 64

_LIB = None
_SMS: dict[int, int] = {}


def chol_qr(w: torch.Tensor, eps: float):
    """Batched Cholesky QR of n-major (n, batch, bs) blocks with per-column
    deflation. Returns (Q, R, ok); ``ok`` is False only on full-block
    breakdown (‖w‖_F < eps). Partially dependent columns (twin nodes) are
    deflated — zeroed in Q and in the matching rows of R — instead of
    completed, so they add exact decoupled zero rows to the projection.

    ``torch.linalg.cholesky`` raises where JAX's returns NaN, so the
    factorization runs through ``cholesky_ex`` and a nonzero ``info`` (or a
    NaN) marks the member as broken down, as the NaN test does in JAX.
    """
    G = torch.einsum("nbk,nbl->bkl", w, w)
    bs = w.shape[-1]
    frob2 = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)
    ok = frob2 > eps * eps
    eps_m = torch.finfo(w.dtype).eps
    eye = torch.eye(bs, dtype=w.dtype, device=w.device)
    reg = frob2 * (eps_m * 16.0) + eps * eps
    L, info = torch.linalg.cholesky_ex(G + reg[:, None, None] * eye[None])
    bad = (info != 0) | torch.isnan(L).any(dim=(-1, -2))
    ok = ok & ~bad
    L = torch.where(ok[:, None, None], L, eye[None])
    # deflate columns whose pivot is pure ridge/rounding noise
    keep = torch.diagonal(L, dim1=-2, dim2=-1).square() > (
        frob2[:, None] * (eps_m * 256.0))
    R = L.transpose(-1, -2)  # upper triangular, w = Q R
    Rinv = torch.linalg.solve_triangular(R, eye.expand(R.shape), upper=True,
                                         left=True)
    Q = torch.einsum("nbk,bkl->nbl", w, Rinv)
    Q = Q * keep[None, :, :].to(w.dtype)
    R = R * keep[:, :, None].to(w.dtype)
    Q = torch.where(ok[None, :, None], Q, torch.zeros_like(Q))
    R = torch.where(ok[:, None, None], R, torch.zeros_like(R))
    return Q, R, ok


def block_mgs_plain(vp: torch.Tensor, vc: torch.Tensor, w: torch.Tensor,
                    alive: torch.Tensor, eps: float):
    """The step in torch: double MGS of ``w`` against (``vp``, ``vc``)
    (``lanczos_krylov.m:109-115``), :func:`chol_qr`, and dead members'
    blocks zeroed. Returns (Q, h (batch, 2bs, bs), beta (batch, bs, bs),
    alive_next)."""

    def proj(w):
        hp = torch.einsum("nbk,nbl->bkl", vp, w)
        hc = torch.einsum("nbk,nbl->bkl", vc, w)
        w = w - torch.einsum("nbk,bkl->nbl", vp, hp)
        w = w - torch.einsum("nbk,bkl->nbl", vc, hc)
        return w, hp, hc

    w, hp1, hc1 = proj(w)
    w, hp2, hc2 = proj(w)  # second MGS pass (lanczos_krylov.m:112-114)
    h = torch.cat([hp1 + hp2, hc1 + hc2], dim=-2)  # (batch, 2bs, bs)

    Q, beta, ok = chol_qr(w, eps)
    alive_next = alive & ok
    # dead batch members emit zero blocks from here on
    h = torch.where(alive[:, None, None], h, torch.zeros_like(h))
    beta = torch.where(alive_next[:, None, None], beta,
                       torch.zeros_like(beta))
    Q = torch.where(alive_next[None, :, None], Q, torch.zeros_like(Q))
    return Q, h, beta, alive_next


def on_kernel_path(vp, vc, w, alive) -> bool:
    """Which version takes these inputs: False when all four lie on the CPU
    (the plain version), True for the kernel's inputs — CUDA tensors on one
    device, ``vp``, ``vc`` and ``w`` of one non-empty (n, batch, bs) shape
    in float32 or float64 that the kernel's grid holds, ``alive`` bool
    (batch,), each contiguous and 16-byte aligned. Raises on anything
    else."""
    tensors = (vp, vc, w, alive)
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = w.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"block_mgs takes its blocks on one CUDA device or "
                         f"all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    if w.dtype not in (torch.float32, torch.float64) or \
            vp.dtype != w.dtype or vc.dtype != w.dtype:
        raise ValueError(f"the block_mgs kernel takes float32 or float64 "
                         f"blocks of one type, got {vp.dtype}, {vc.dtype}, "
                         f"{w.dtype}")
    shape = tuple(w.shape)
    if len(shape) != 3 or 0 in shape or tuple(vp.shape) != shape or \
            tuple(vc.shape) != shape:
        raise ValueError(f"block_mgs takes three non-empty (n, batch, bs) "
                         f"blocks of one shape, got {tuple(vp.shape)}, "
                         f"{tuple(vc.shape)}, {shape}")
    batch, bs = shape[1:]
    tiles = -(-bs // TILE)
    if -(-batch // 32) > GRID_Y or bs > MAX_BS and (
            batch > GRID_Y or 2 * tiles * tiles > GRID_Y):
        raise ValueError(f"block_mgs: batch {batch} at bs {bs} is more than "
                         f"the kernel's grid holds")
    if alive.dtype != torch.bool or tuple(alive.shape) != shape[1:2]:
        raise ValueError(f"alive must be bool ({shape[1]},), got "
                         f"{alive.dtype} {tuple(alive.shape)}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("block_mgs takes contiguous blocks that start "
                             "on a 16-byte boundary")
    return True


def plan(n: int, batch: int, sms: int, bs: int = 2) -> tuple[int, int]:
    """(rows a slab, slabs) of the kernel's grid over ``sms`` SMs: the
    narrow chain's CTAs tile the members by 32, the wide chain's the
    projection coefficients of each member by 32 × 32."""
    if bs <= MAX_BS:
        tiles = -(-batch // 32)
    else:
        tiles = batch * 2 * (-(-bs // TILE)) ** 2
    want = max(1, min(-(-CTAS_PER_SM * sms // tiles), -(-n // MIN_SLAB_ROWS)))
    rows = -(-n // want)
    return rows, -(-n // rows)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("block_mgs")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("krt_block_mgs_f32", "krt_block_mgs_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 10 + [i32] * 5 + [ctypes.c_double, ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def _sms(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def block_mgs_cuda(vp, vc, w, alive, eps: float):
    """The kernel chain on inputs that :func:`on_kernel_path` admitted;
    returns what :func:`block_mgs_plain` returns."""
    n, batch, bs = w.shape
    dev, dt = w.device, w.dtype
    rows, slabs = plan(n, batch, _sms(dev), bs)
    q = torch.empty_like(w)
    h = torch.empty((batch, 2 * bs, bs), dtype=dt, device=dev)
    beta = torch.empty((batch, bs, bs), dtype=dt, device=dev)
    alive_next = torch.empty((batch,), dtype=torch.bool, device=dev)
    part = torch.empty((slabs * 2 * bs * bs * batch,), dtype=torch.float64,
                       device=dev)
    # h1, h2 and the Q coefficients; the wide chain also W1/W2 and the
    # factor's G and L
    size = batch * (5 * bs * bs + bs + 1) if bs <= MAX_BS else \
        n * batch * bs + batch * (7 * bs * bs + bs + 1)
    scratch = torch.empty((size,), dtype=dt, device=dev)
    lib = _library()
    fn = lib.krt_block_mgs_f32 if dt == torch.float32 else \
        lib.krt_block_mgs_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(vp.data_ptr(), vc.data_ptr(), w.data_ptr(), q.data_ptr(),
                  alive.data_ptr(), alive_next.data_ptr(), h.data_ptr(),
                  beta.data_ptr(), part.data_ptr(), scratch.data_ptr(), n,
                  batch, bs, rows, slabs, float(eps), stream)
    cuda_build.raise_on(code, fn.__name__)
    return q, h, beta, alive_next


def block_mgs(vp: torch.Tensor, vc: torch.Tensor, w: torch.Tensor,
              alive: torch.Tensor, eps: float):
    """(Q, h, beta, alive_next) of one block step from ``w = A·vc``: the
    kernel for CUDA blocks, the plain version for CPU ones."""
    if not on_kernel_path(vp, vc, w, alive):
        return block_mgs_plain(vp, vc, w, alive, eps)
    out = block_mgs_cuda(vp, vc, w, alive, eps)
    tracing.count("krylov.steps_kernel", w.shape[1])
    tracing.count("krylov.launches.MGS",
                  LAUNCHES["narrow" if w.shape[2] <= MAX_BS else "wide"])
    return out
