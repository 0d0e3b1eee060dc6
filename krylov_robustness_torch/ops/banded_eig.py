"""Batched eigenvalues of small symmetric banded matrices by Sturm-count
bisection — port of ``krylov_robustness_tpu/ops/banded_eig.py``, the f32
spectra solver of the fused greedy scorer.

Each (matrix, eigenvalue-index) lane holds its own bisection interval; one
banded LDLᵀ sweep per iteration counts the eigenvalues below every lane's
midpoint (Sylvester inertia). The sweep carries the active (w+1)×(w+1)
Schur window down the band and clamps near-zero pivots at eps·scale
(LAPACK ``dlaebz``-style pivmin, deliberately larger — see the JAX module).
Eigenvalue error ≈ gerschgorin_range·2^−iters + O(eps·‖G‖).

Plain torch, written as the JAX version is (an M-step sweep inside the
bisection), so the CPU parity tests can hold the two together.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import tracing


def eigvalsh_banded(G: torch.Tensor, w: int = 3,
                    iters: int | None = None) -> torch.Tensor:
    """Ascending eigenvalues of symmetric banded matrices.

    G: (batch, M, M), symmetric, lower bandwidth ``w`` — entries with
    |i−j| > w are ignored (assumed zero). Returns (batch, M). A band at
    least as wide as the matrix (M ≤ w) is the whole matrix: w is clamped
    to M−1.
    """
    batch, M, _ = G.shape
    if iters is None:
        iters = 34 if G.dtype == torch.float32 else 62
    if M == 0:
        return G.new_zeros((batch, 0))
    with tracing.span("spectra.sturm", batch, M):
        return _bisect(G, min(w, M - 1), iters)


def _bisect(G: torch.Tensor, w: int, iters: int) -> torch.Tensor:
    """:func:`eigvalsh_banded` for 1 ≤ M, w ≤ M − 1."""
    batch, M, _ = G.shape
    dtype, dev = G.dtype, G.device

    diag = torch.diagonal(G, dim1=-2, dim2=-1)  # (batch, M)
    # banded view: band[b, d, i] = G[i+d, i], d = 0..w (zero-padded tail)
    band = torch.stack(
        [F.pad(torch.diagonal(G, offset=-d, dim1=-2, dim2=-1), (0, d))
         for d in range(w + 1)], dim=1)

    # Gerschgorin bounds from the banded entries only
    radius = torch.zeros_like(diag)
    for d in range(1, w + 1):
        off = band[:, d, :].abs()  # |G[i+d, i]| attributed to rows i, i+d
        radius = radius + F.pad(off[:, :M - d], (0, d))
        radius = radius + F.pad(off[:, :M - d], (d, 0))
    lo0 = torch.min(diag - radius, dim=-1).values  # (batch,)
    hi0 = torch.max(diag + radius, dim=-1).values
    scale = torch.maximum(torch.maximum(lo0.abs(), hi0.abs()),
                          torch.ones((), dtype=dtype, device=dev))
    # pivot clamp at eps·scale and window saturation at scale/eps keep a run
    # of near-singular pivots from overflowing the Schur window to inf/NaN
    eps = torch.finfo(dtype).eps
    pivmin = eps * scale
    sat = scale / eps
    big = 4.0 * scale  # sentinel diagonal for past-the-end window slots

    # appended column per sweep step j (window moves to cover c = j+w+1):
    # cols_app[b, j, k] = G[c−w+k, c] for k = 0..w (k = w is the diagonal);
    # steps with c ≥ M append a decoupled +big slot (positive pivot, zero
    # coupling) so the window stays full-size without affecting the count
    j_idx = np.arange(M)
    c_idx = j_idx + w + 1
    k_idx = np.arange(w + 1)
    d_sel = torch.as_tensor((w - k_idx)[None, :], device=dev)
    i_sel = torch.as_tensor(
        np.clip(c_idx[:, None] - w + k_idx[None, :], 0, M - 1), device=dev)
    valid = c_idx < M
    cols_app = band[:, d_sel, i_sel]  # (batch, M, w+1)
    cols_app = torch.where(torch.as_tensor(valid, device=dev)[None, :, None],
                           cols_app, torch.zeros((), dtype=dtype, device=dev))
    diag_app = torch.where(torch.as_tensor(valid, device=dev)[None, :],
                           cols_app[:, :, w], big[:, None])  # (batch, M)

    W1 = w + 1
    eyeW = torch.eye(W1, dtype=dtype, device=dev)
    # initial window: G[0:w+1, 0:w+1] (banded entries), built from band
    S0 = torch.zeros((W1, W1, batch), dtype=dtype, device=dev)
    for d in range(0, w + 1):
        for i in range(0, W1 - d):
            S0[i + d, i] = band[:, d, i]
            if d:
                S0[i, i + d] = band[:, d, i]
    # the window is kept as (W1, W1, batch, L): every op runs over whole
    # contiguous (batch, L) planes; the arithmetic is the JAX version's
    lim = sat[None, None, :, None]
    cols_T = cols_app.permute(1, 2, 0)  # (M, w+1, batch)

    def count_below(x):
        """#{λ < x} per lane; x: (batch, L)."""
        L = x.shape[1]
        S = S0[:, :, :, None] - x[None, None] * eyeW[:, :, None, None]
        cnt = torch.zeros(x.shape, dtype=torch.int32, device=dev)
        for j in range(M):
            p = S[0, 0]
            p = torch.where(p.abs() < pivmin[:, None], -pivmin[:, None], p)
            cnt += p < 0
            v = S[1:, 0]  # (w, batch, L)
            S2 = S[1:, 1:] - v[:, None] * v[None, :] / p
            S2 = torch.clamp(S2, -lim, lim)
            col = cols_T[j, :w, :, None].expand(w, batch, L)
            d_new = (diag_app[:, j, None] - x if valid[j]
                     else diag_app[:, j, None].expand(x.shape))
            S = torch.cat([
                torch.cat([S2, col[:, None]], dim=1),
                torch.cat([col[None], d_new[None, None]], dim=1),
            ], dim=0)
        return cnt

    # one bisection lane per eigenvalue index: λ_i ⇔ count ≥ i+1
    tgt = torch.arange(M, dtype=torch.int32, device=dev)[None, :]
    lo = lo0[:, None].expand(batch, M)
    hi = hi0[:, None].expand(batch, M)
    for _ in range(iters):
        mid = (lo + hi) / 2
        go_left = count_below(mid) >= tgt + 1
        lo, hi = torch.where(go_left, lo, mid), torch.where(go_left, mid, hi)
    return (lo + hi) / 2
