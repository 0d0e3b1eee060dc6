"""The host-eigh scorer's projected spectra on the card: a round's four
band projections of each active candidate, in f64.

At a round boundary after m steps, the scorer needs the eigenvalues of tG
and G (``updates/trace_update.py::_band_from_blocks``: the symmetrized block
tridiagonal projection of the recurrence, tG with R0·B·R0ᵀ added at the top
left) at m·bs columns and at m_lag·bs. :func:`spectra` returns them for the
candidates ``act`` as one (len(act), 2M + 2ML) f64 tensor, the lanes laid
out [tG(M) | G(M) | tG(ML) | G(ML)], each part in the order of its
eigenvalue index (ascending up to rounding; the caller sorts). Each matrix
is reduced to tridiagonal form by Givens rotations and its eigenvalues found
by Sturm-count bisection on the tridiagonal (:data:`ITERS` iterations), as
accurate as the host's LAPACK: bisection straight on the band
(``ops/banded_eig.py::_bisect``) strays where a pivot nears zero. CPU tensors
run :func:`spectra_plain`, that arithmetic in torch; CUDA tensors run the
hand-written kernel of ``csrc/banded_sturm.cu`` (no TPU kernel stands behind
it: the JAX package calls LAPACK on the host here), or raise where the
kernel does not take them (:func:`on_kernel_path`). Each launch adds its
candidates' four matrices to the counter ``spectra.members_kernel`` and one
to ``spectra.launches.sturm``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import tracing
from . import cuda_build

MAX_BS = 4  # the kernel's templates cover bs = 1 … 4
ITERS = 62  # bisection steps: f64, as the host's LAPACK solves
MAX_THREADS = 256  # a CTA's threads; a candidate with more takes several
GROUP = 8  # threads a lane: 7 counts a sweep, 3 bisection steps
# a CTA's shared memory for one candidate, within the 227 KB it may hold
# beside its few hundred static bytes
MAX_SHARED_BYTES = 200 * 1024


def shared_bytes(M: int, bs: int) -> int:
    """The kernel's dynamic shared memory for a candidate of M columns: the
    band (M · 2bs doubles), the four working matrices in band-row storage
    with room for the bulge (M · (2bs + 1) each) and their tridiagonals
    (M · 2 each)."""
    return 8 * M * (2 * bs + 4 * (2 * bs + 1) + 8)


_LIB = None


def plan(lanes: int) -> tuple[int, int]:
    """(CTAs a candidate, threads a CTA) for ``lanes`` (matrix, eigenvalue)
    pairs of one candidate, GROUP threads a lane: as few CTAs as hold them
    at MAX_THREADS, the lanes split evenly over them in whole warps."""
    per_cta = MAX_THREADS // GROUP
    chunks = max(1, -(-lanes // per_cta))
    per = -(-lanes // chunks)
    warp_lanes = 32 // GROUP
    return chunks, GROUP * -(-per // warp_lanes) * warp_lanes


def on_kernel_path(h, beta, Cm, act, m: int, m_lag: int) -> bool:
    """Which version takes these inputs: False when all four lie on the CPU
    (the plain version), True for the kernel's — CUDA tensors on one device,
    ``h`` (steps, batch, 2bs, bs) with 1 ≤ bs ≤ MAX_BS and ``beta`` (steps,
    batch, bs, bs) of one type, float32 or float64, ``Cm`` (batch, bs, bs)
    float64, ``act`` (n,) int32 with n ≥ 1, each contiguous; 1 ≤ m ≤ steps,
    0 ≤ m_lag ≤ m, and a band that fits a CTA's shared memory. Raises on
    anything else. The indices in ``act`` are not checked: they must lie in
    [0, batch)."""
    tensors = (h, beta, Cm, act)
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = h.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"banded_sturm takes its inputs on one CUDA device "
                         f"or all on the CPU, got "
                         f"{[str(t.device) for t in tensors]}")
    if h.dtype not in (torch.float32, torch.float64) or beta.dtype != h.dtype:
        raise ValueError(f"the banded_sturm kernel takes a float32 or float64 "
                         f"recurrence of one type, got {h.dtype}, "
                         f"{beta.dtype}")
    if Cm.dtype != torch.float64 or act.dtype != torch.int32:
        raise ValueError(f"banded_sturm takes Cm float64 and act int32, got "
                         f"{Cm.dtype}, {act.dtype}")
    shape = tuple(h.shape)
    if len(shape) != 4 or 0 in shape or shape[2] != 2 * shape[3] or \
            shape[3] > MAX_BS:
        raise ValueError(f"banded_sturm takes h (steps, batch, 2bs, bs) with "
                         f"1 <= bs <= {MAX_BS}, got {shape}")
    steps, batch, _, bs = shape
    if tuple(beta.shape) != (steps, batch, bs, bs) or \
            tuple(Cm.shape) != (batch, bs, bs):
        raise ValueError(f"banded_sturm: beta {tuple(beta.shape)} and Cm "
                         f"{tuple(Cm.shape)} do not match h {shape}")
    if act.ndim != 1 or act.shape[0] == 0:
        raise ValueError(f"act must be (n,) with n >= 1, got "
                         f"{tuple(act.shape)}")
    if not (1 <= m <= steps and 0 <= m_lag <= m):
        raise ValueError(f"banded_sturm: m {m}, m_lag {m_lag} outside "
                         f"1 <= m_lag + 1 <= m + 1, m <= {steps} steps")
    if shared_bytes(m * bs, bs) > MAX_SHARED_BYTES:
        raise ValueError(f"banded_sturm: a band of {m * bs} columns at bs "
                         f"{bs} is more than a CTA holds")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("banded_sturm takes contiguous inputs")
    return True


def projections(h, beta, Cm, act, m: int):
    """The dense symmetrized projections (tG, G), each (len(act), m·bs,
    m·bs) f64, of the candidates ``act`` after m steps, with the numbers of
    ``updates/trace_update.py::_band_from_blocks``: diagonal blocks
    (αⱼ + αⱼᵀ)/2, αⱼ = h[j][bs:2bs], couplings (βⱼ₋₁ + h[j][0:bs]ᵀ)/2 below
    them and their transposes above, tG adding (Cm + Cmᵀ)/2 at the top
    left."""
    bs = h.shape[-1]
    idx = act.long()
    hh = h[:m, idx].to(torch.float64)  # (m, n, 2bs, bs)
    n = idx.numel()
    G = torch.zeros((n, m, bs, m, bs), dtype=torch.float64, device=h.device)
    alpha = hh[:, :, bs:]
    ar = torch.arange(m, device=h.device)
    G[:, ar, :, ar, :] = (alpha + alpha.transpose(-1, -2)) / 2
    if m > 1:
        lower = (beta[:m - 1, idx].to(torch.float64)
                 + hh[1:, :, :bs].transpose(-1, -2)) / 2
        G[:, ar[1:], :, ar[:-1], :] = lower
        G[:, ar[:-1], :, ar[1:], :] = lower.transpose(-1, -2)
    G = G.reshape(n, m * bs, m * bs)
    C = Cm[idx].to(torch.float64)
    tG = G.clone()
    tG[:, :bs, :bs] += (C + C.transpose(-1, -2)) / 2
    return tG, G


def _rotations(n: int, w: int):
    """(k, p, col) of each Givens rotation that reduces a symmetric band
    matrix of n rows and half-bandwidth w to tridiagonal form (Schwarz), in
    the kernel's order: the diagonals from the outermost (k = w … 2), each
    entry A[j+k][j] zeroed by a rotation of rows and columns (p, p+1) =
    (j+k−1, j+k), the bulge it leaves at distance k+1 chased off the end."""
    for k in range(w, 1, -1):
        for j in range(n - k):
            col, i = j, j + k
            while True:
                yield k, i - 1, col
                if i + k >= n:
                    break
                col, i = i - 1, i + k


def band_rows(X: torch.Tensor, w: int) -> torch.Tensor:
    """The kernel's working storage of symmetric band matrices X (b, n, n),
    half-bandwidth w: band rows B[:, r, k] = X[:, r, r − K + k], K = w + 1
    (the band and room for the bulge), zero outside the matrix."""
    b, n, _ = X.shape
    K = w + 1
    B = X.new_zeros((b, n, K + 1))
    for d in range(min(w, n - 1) + 1):
        B[:, d:, K - d] = torch.diagonal(X, offset=-d, dim1=1, dim2=2)
    return B


def rotate(B: torch.Tensor, k: int, p: int, col: int) -> None:
    """In place on band rows B (b, n, K + 1): the kernel's Givens rotation
    of rows and columns (p, p + 1) that zeroes A[p+1][col] against
    A[p][col], the matrix at half-bandwidth k with a bulge at k + 1."""
    n, K = B.shape[1], B.shape[2] - 1
    q = p + 1
    a, v = B[:, p, K - (p - col)], B[:, q, K - (q - col)]
    nz = v != 0
    r = torch.where(nz, torch.sqrt(a * a + v * v), a)
    inv = 1.0 / r
    c = torch.where(nz, a * inv, torch.ones_like(a))[:, None]
    s = torch.where(nz, v * inv, torch.zeros_like(a))[:, None]
    B[:, p, K - (p - col)] = r
    B[:, q, K - (q - col)] = 0.0
    ts = np.array([t for t in range(max(0, q - k - 1), p) if t != col],
                  dtype=np.int64)
    if len(ts):  # rows p, q left of the block
        ip, iq = K - (p - ts), K - (q - ts)
        x, y = B[:, p, ip], B[:, q, iq]
        B[:, p, ip] = c * x + s * y
        B[:, q, iq] = c * y - s * x
    c, s = c[:, 0], s[:, 0]
    x, y, z = (B[:, p, K].clone(), B[:, q, K].clone(),
               B[:, q, K - 1].clone())
    cs2 = 2.0 * c * s * z
    B[:, p, K] = c * c * x + cs2 + s * s * y
    B[:, q, K] = s * s * x - cs2 + c * c * y
    B[:, q, K - 1] = c * s * (y - x) + (c * c - s * s) * z
    rows = np.arange(q + 1, min(n - 1, q + k) + 1)
    if len(rows):  # columns p, q below the block
        x, y = B[:, rows, K - (rows - p)], B[:, rows, K - (rows - q)]
        B[:, rows, K - (rows - p)] = c[:, None] * x + s[:, None] * y
        B[:, rows, K - (rows - q)] = c[:, None] * y - s[:, None] * x


def tridiagonalize(X: torch.Tensor, w: int):
    """(d, e): the diagonal (b, n) and off-diagonal (b, n − 1) of the
    tridiagonal matrices that the kernel's rotations (:func:`_rotations`,
    :func:`rotate`) reduce the symmetric band matrices X (b, n, n),
    half-bandwidth w, to, with its arithmetic."""
    B = band_rows(X, w)
    K = w + 1
    for k, p, col in _rotations(X.shape[1], w):
        rotate(B, k, p, col)
    return B[:, :, K], B[:, 1:, K - 1]


def bisect_tridiagonal(d: torch.Tensor, e: torch.Tensor,
                       iters: int = ITERS) -> torch.Tensor:
    """Eigenvalues (b, n) of the symmetric tridiagonal matrices (d, e) by
    Sturm-count bisection, one lane an eigenvalue index, as the kernel
    computes them: the Gerschgorin interval, a pivot below eps·scale in
    magnitude taken as −eps·scale (scale = max(|lo|, |hi|, 1))."""
    b, n = d.shape
    if n == 0:
        return d.new_zeros((b, 0))
    ae = e.abs()
    rad = torch.nn.functional.pad(ae, (1, 0)) + \
        torch.nn.functional.pad(ae, (0, 1))
    lo = (d - rad).min(dim=1).values
    hi = (d + rad).max(dim=1).values
    scale = torch.maximum(torch.maximum(lo.abs(), hi.abs()),
                          torch.ones_like(lo))
    pivmin = (torch.finfo(d.dtype).eps * scale)[:, None]
    e2 = torch.nn.functional.pad(e * e, (1, 0))
    tgt = torch.arange(n, device=d.device)[None, :]
    lo = lo[:, None].expand(b, n)
    hi = hi[:, None].expand(b, n)
    for _ in range(iters):
        mid = (lo + hi) / 2
        q = torch.ones_like(mid)
        cnt = torch.zeros(mid.shape, dtype=torch.int64, device=d.device)
        for i in range(n):
            q = (d[:, i, None] - mid) - e2[:, i, None] / q
            q = torch.where(q.abs() < pivmin, -pivmin, q)
            cnt += q < 0
        left = cnt > tgt
        lo, hi = torch.where(left, lo, mid), torch.where(left, mid, hi)
    return (lo + hi) / 2


def spectra_plain(h, beta, Cm, act, m: int, m_lag: int) -> torch.Tensor:
    """The kernel's output in torch, with its arithmetic: each of
    :func:`projections` and their leading m_lag·bs submatrices reduced to
    tridiagonal form (:func:`tridiagonalize`, half-bandwidth 2bs − 1), then
    :func:`bisect_tridiagonal` in f64 with ITERS iterations; NaN throughout
    a matrix with a non-finite entry."""
    bs = h.shape[-1]
    tG, G = projections(h, beta, Cm, act, m)
    ML = m_lag * bs
    parts = []
    for X in (tG, G, tG[:, :ML, :ML], G[:, :ML, :ML]):
        bad = ~torch.isfinite(X).all(dim=2).all(dim=1)
        eig = bisect_tridiagonal(*tridiagonalize(
            torch.where(bad[:, None, None], torch.zeros_like(X), X),
            2 * bs - 1))
        parts.append(torch.where(bad[:, None], float("nan"), eig))
    return torch.cat(parts, dim=1)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = cuda_build.library("banded_sturm")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name in ("krt_banded_sturm_f32", "krt_banded_sturm_f64"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def spectra_cuda(h, beta, Cm, act, m: int, m_lag: int) -> torch.Tensor:
    """The kernel on inputs that :func:`on_kernel_path` admitted; returns
    what :func:`spectra_plain` returns, on the card."""
    _, batch, _, bs = h.shape
    lanes = 2 * (m + m_lag) * bs
    chunks, threads = plan(lanes)
    n = act.shape[0]
    out = torch.empty((n, lanes), dtype=torch.float64, device=h.device)
    lib = _library()
    fn = lib.krt_banded_sturm_f32 if h.dtype == torch.float32 else \
        lib.krt_banded_sturm_f64
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        code = fn(h.data_ptr(), beta.data_ptr(), Cm.data_ptr(),
                  act.data_ptr(), out.data_ptr(), n, batch, bs, m, m_lag,
                  chunks, threads, stream)
    cuda_build.raise_on(code, fn.__name__)
    return out


def spectra(h, beta, Cm, act, m: int, m_lag: int) -> torch.Tensor:
    """The round's four spectra of the candidates ``act``: the kernel for
    CUDA inputs, the plain version for CPU ones."""
    if not on_kernel_path(h, beta, Cm, act, m, m_lag):
        return spectra_plain(h, beta, Cm, act, m, m_lag)
    out = spectra_cuda(h, beta, Cm, act, m, m_lag)
    tracing.count("spectra.members_kernel", 4 * act.shape[0])
    tracing.count("spectra.launches.sturm")
    return out
