"""Plain reference of one greedy break step (paper Tables 2–3, Figures
1–4): for each candidate edge (i, j),

    Δ = [trace exp(A − e_i e_jᵀ − e_j e_iᵀ) − trace exp(A)] · exp(−σ),

by block Lanczos started from [e_i, e_j] with full reorthogonalization
(classical Gram–Schmidt, twice, against every earlier block) until Δ stops
moving. With V the orthonormal basis and T = VᵀAV, Δ is
Σ exp(λ(T + C) − σ) − Σ exp(λ(T) − σ) with C = −[[0, 1], [1, 0]] in the
first block (Beckermann, Kressner and Schweitzer's low-rank update of a
matrix function); the spectra come from LAPACK's banded solver on the
host. In float64 this is the truth the program's f32 scores are held to.

``precision='tf32'`` computes the same in float32 with the Gram products in
TF32 (the tensor cores' 10-bit mantissa, f32 sums): on a GPU by cuBLAS with
TF32 allowed, on the CPU by rounding their operands to TF32. That is the
control of an f32 cell whose answer rests on its f32 products: the step
that would tempt a change to the program's f32 Lanczos. ``'bf16'`` rounds
every product's operands (the Gram products, the sparse products' block)
and the projected matrix to bfloat16's 7-bit mantissa, with f32 sums: the
control where the answer rests on f32 arithmetic that is no product.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch

from . import to_torch_csr

DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "tf32": torch.float32, "bf16": torch.float32}
DROPPED_BITS = {"tf32": 13, "bf16": 16}  # f32 mantissa bits rounded off
MAX_STEPS = 100
BASIS_BYTES = 16e9  # basis memory of one chunk of candidates


def _round(x: torch.Tensor, dropped: int) -> torch.Tensor:
    """f32 values rounded to a mantissa ``dropped`` bits shorter (to
    nearest, ties away from zero): 13 bits for TF32, 16 for bfloat16."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + (1 << (dropped - 1))) & ~((1 << dropped) - 1)
    return bits.view(torch.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    """TF32 for the control's dense products on a GPU; otherwise full
    precision."""
    if precision != "tf32" or device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def _bmm(a, b, dropped: int):
    if dropped:
        return torch.bmm(_round(a, dropped), _round(b, dropped))
    return torch.bmm(a, b)


def _band(alpha: list, beta: list, m: int) -> np.ndarray:
    """Lower band (4, 2m) of the symmetric block tridiagonal T_m from its
    2 × 2 diagonal blocks ``alpha`` and subdiagonal blocks ``beta``, each a
    (batch, 2, 2) host array: returns (batch, 4, 2m)."""
    batch = alpha[0].shape[0]
    band = np.zeros((batch, 4, 2 * m), alpha[0].dtype)
    for j in range(m):
        a = alpha[j]
        band[:, 0, 2 * j] = a[:, 0, 0]
        band[:, 0, 2 * j + 1] = a[:, 1, 1]
        band[:, 1, 2 * j] = a[:, 1, 0]
        if j + 1 < m:
            b = beta[j]  # rows of block j+1, columns of block j
            band[:, 2, 2 * j] = b[:, 0, 0]
            band[:, 1, 2 * j + 1] = b[:, 0, 1]
            band[:, 3, 2 * j] = b[:, 1, 0]
            band[:, 2, 2 * j + 1] = b[:, 1, 1]
    return band


def _delta_from_band(band: np.ndarray, sign: float, shift: float):
    """(Δ, rounding floor) for each member from T's lower band: Δ from the
    eigenvalues of T and of T + C (C = sign·[[0, 1], [1, 0]] in the first
    block), paired in ascending order, Σ exp(λ(T) − σ)·expm1(λ(T + C) −
    λ(T)), an exact rearrangement of the difference of the two sums; the
    floor is 64 epsilons of max|λ|·Σ exp(λ(T) − σ), what rounding the
    eigenvalues leaves of Δ."""
    eps = np.finfo(band.dtype).eps
    out = np.empty(band.shape[0], np.float64)
    floor = np.empty(band.shape[0], np.float64)
    for c in range(band.shape[0]):
        d2 = scipy.linalg.eigvals_banded(band[c], lower=True,
                                         check_finite=False)
        bt = band[c].copy()
        bt[1, 0] += sign
        d1 = scipy.linalg.eigvals_banded(bt, lower=True, check_finite=False)
        d1, d2 = np.sort(d1.astype(np.float64)), np.sort(d2.astype(np.float64))
        out[c] = np.sum(np.exp(d2 - shift) * np.expm1(d1 - d2))
        floor[c] = 64 * eps * max(1.0, np.abs(d2).max()) * \
            np.sum(np.exp(d2 - shift))
    return out, floor


def _chunk(A, edges: np.ndarray, sign: float, shift: float, dtype,
           gram_bits: int, all_bits: int, rtol: float, atol: float,
           max_steps: int):
    """Δ of one chunk of candidates and the steps its slowest member took;
    a member stops where its Δ moves by no more than ``atol``, ``rtol`` of
    itself or its rounding floor between two checks two steps apart.
    ``gram_bits`` is the mantissa bits the Gram products' operands lose,
    ``all_bits`` those of the sparse products' block and the projected
    matrix (0: none).
    """
    dev = A.device
    n = A.shape[0]
    c = len(edges)
    e = torch.as_tensor(edges, device=dev)
    idx = torch.arange(c, device=dev)
    V = torch.zeros((c, 2 * max_steps, n), dtype=dtype, device=dev)
    V[idx, 0, e[:, 0]] = 1.0
    V[idx, 1, e[:, 1]] = 1.0
    eps = torch.finfo(dtype).eps
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    alpha, beta = [], []
    last = np.full(c, np.nan)
    delta = np.full(c, np.nan)
    active = np.ones(c, bool)
    m = 0
    for j in range(max_steps):
        Vj = V[:, 2 * j:2 * j + 2, :].reshape(2 * c, n)
        if all_bits:
            Vj = _round(Vj, all_bits)
        W = torch.sparse.mm(A, Vj.t().contiguous()).t().reshape(c, 2, n)
        Vp = V[:, :2 * j + 2, :]
        h = None
        for _ in range(2):
            H = _bmm(Vp, W.transpose(1, 2).contiguous(), gram_bits)
            W = W - _bmm(H.transpose(1, 2).contiguous(), Vp, gram_bits)
            h = H if h is None else h + H
        a = h[:, 2 * j:2 * j + 2, :]
        alpha.append(((a + a.transpose(1, 2)) / 2).double().cpu().numpy())
        G = _bmm(W, W.transpose(1, 2).contiguous(), gram_bits)
        s, U = torch.linalg.eigh((G + G.transpose(1, 2)) / 2)
        keep = s > (1e3 * eps) ** 2 * torch.clamp(s.max(dim=1, keepdim=True)
                                                  .values, min=1.0)
        root = torch.sqrt(torch.clamp(s, min=0.0))
        inv = torch.where(keep, 1.0 / torch.where(keep, root, 1.0), 0.0)
        # W = U·diag(√s)·Vnext (rows): T[j+1, j] = diag(√s)·Uᵀ
        Ut = U.transpose(1, 2)
        if j + 1 < max_steps:
            V[:, 2 * j + 2:2 * j + 4, :] = torch.bmm(Ut, W) * inv[:, :, None]
        beta.append(((root * keep)[:, :, None] * Ut).double().cpu().numpy())
        m = j + 1
        if m >= 4 and m % 2 == 0:
            act = np.flatnonzero(active)
            band = _band([x[act] for x in alpha], [x[act] for x in beta],
                         m).astype(np_dtype)
            if all_bits:
                band = _round(torch.from_numpy(band), all_bits).numpy()
            now, floor = _delta_from_band(band, sign, shift)
            done = np.abs(now - last[act]) <= np.maximum(
                np.maximum(atol, rtol * np.abs(now)), floor)
            delta[act] = now
            last[act] = now
            active[act[done]] = False
            if not active.any():
                return delta, m
    return delta, m


def delta_trace_exp(A: sp.spmatrix, edges: np.ndarray, *, sign: float = -1.0,
                    shift: float = 0.0, precision: str = "float64",
                    atol: float = 0.0, device="cpu",
                    max_steps: int = MAX_STEPS):
    """Δ of each candidate edge of ``edges`` (e, 2) on the graph ``A``
    (scipy, symmetric): returns (Δ as float64 (e,), the Lanczos steps of the
    slowest chunk). A candidate stops where its Δ moves by no more than
    ``atol``, 1e-10 of itself or its rounding floor between two checks two
    steps apart; in f32 the relative stop is 32 epsilons, as an f32
    recurrence resolves no better. ``precision``: 'float64' (the
    reference), 'float32', 'tf32' or 'bf16' (controls)."""
    dtype = DTYPES[precision]
    dev = torch.device(device)
    At = to_torch_csr(A, dtype, dev)
    n = A.shape[0]
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    rtol = max(1e-10, 32 * float(torch.finfo(dtype).eps))
    # TF32 runs on the card's tensor cores, and is emulated on the CPU;
    # bfloat16 is emulated on both
    gram_bits = 0 if precision == "tf32" and dev.type == "cuda" else \
        DROPPED_BITS.get(precision, 0)
    all_bits = DROPPED_BITS["bf16"] if precision == "bf16" else 0
    size = max(1, int(BASIS_BYTES // (2 * max_steps * n *
                                      torch.finfo(dtype).bits // 8)))
    out, steps = [], 0
    with _matmul_precision(precision, dev):
        for s in range(0, len(edges), size):
            d, m = _chunk(At, edges[s:s + size], sign, shift, dtype,
                          gram_bits, all_bits, rtol, atol, max_steps)
            out.append(d)
            steps = max(steps, m)
    return np.concatenate(out), steps


def step_numbers(delta_ref: np.ndarray, candidates: np.ndarray, pick,
                 pick_delta: float) -> dict:
    """The numbers one greedy break step is judged by, against the
    reference's Δ of every candidate of the step, each over the magnitude of
    the reference's best Δ: ``pick_regret``, how far the reference's own Δ
    of the pick lies above its best (a pick that is not the best widens it;
    a near-tie within rounding does not); ``delta_gap``, the gap between the
    Δ the step reports for its pick and the reference's Δ of that pick;
    ``pick_outside``, 1 if the pick is not a candidate of this step (the
    other two then read 1)."""
    key = [(int(i), int(j)) for i, j in candidates]
    pick = (int(pick[0]), int(pick[1]))
    best = abs(float(np.min(delta_ref)))
    if pick not in key:
        return {"pick_regret": 1.0, "delta_gap": 1.0, "pick_outside": 1}
    mine = float(delta_ref[key.index(pick)])
    return {"pick_regret": (mine - float(np.min(delta_ref))) / best,
            "delta_gap": abs(pick_delta - mine) / best,
            "pick_outside": 0}


def swapped_pick(delta_ref: np.ndarray) -> tuple[int, float]:
    """The planted fault of a scorer whose commit is off by one from its
    argmin: (the index it commits, the Δ it reports), from the reference's
    own scores: the candidate after the best, reported with the best's Δ."""
    h = int(np.argmin(delta_ref))
    return (h + 1 if h + 1 < len(delta_ref) else h - 1), float(delta_ref[h])
