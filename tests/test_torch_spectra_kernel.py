"""The spectra layer of the host-eigh scorer (``ops/banded_sturm.py``,
``updates/trace_update.py::_eigvals_banded_batch``) on the CPU: which path
takes which recurrence, the ``spectra.*`` counts, and the plain f64 Sturm
bisection — the kernel's arithmetic — against LAPACK on the bands of a real
recurrence. The kernel itself runs on the card only (``chip_smoke.py``, its
spectra phase)."""

import numpy as np
import pytest
import scipy.linalg
import torch

from helpers import random_graph
from krylov_robustness_torch.funm.scalar import get_fun
from krylov_robustness_torch.krylov.lanczos import (
    lanczos_continue,
    lanczos_start,
)
from krylov_robustness_torch.ops import banded_sturm, cuda_build
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_torch.updates import trace_update as tu
from krylov_robustness_torch.utils import tracing

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

N, BATCH, STEPS = 300, 8, 20


def _recurrence(dtype=torch.float64, sign=-1.0):
    """(h, beta, Cm) of a 20-step recurrence on a 300-node random graph
    from 8 candidate edges, the last a self-loop (rank-1 B), with Cm as the
    scorer forms it."""
    A = random_graph(N, 0.03, seed=5)
    C = np.stack(np.nonzero(np.triu(A.toarray(), 1)), axis=1)
    pick = np.random.default_rng(1).choice(len(C), BATCH - 1, replace=False)
    edges = np.concatenate([C[pick], [[17, 17]]])
    op = CooMatrix.from_scipy(A, dtype=dtype, device="cpu")
    U0 = tu.edge_start_blocks(N, edges, dtype, "cpu")
    B = tu.edge_B(edges, sign, 1.0, dtype, "cpu")
    state, R0 = lanczos_start(op, U0)
    blocks, _ = lanczos_continue(op, state, STEPS)
    R0n, Bn = tu._to_host(R0), tu._to_host(B)
    Cm = torch.from_numpy(np.einsum("bkl,blm,bpm->bkp", R0n, Bn, R0n))
    return blocks.h, blocks.beta, Cm


def _lapack(h, beta, Cm, act, m, m_lag):
    """(tG_lag, G_lag, tG, G) eigenvalues by LAPACK on the scorer's bands."""
    band_t, band_g = tu._band_from_blocks(tu._to_host(h)[:, act],
                                          tu._to_host(beta)[:, act],
                                          Cm.numpy()[act], m, 2)
    ML = m_lag * 2

    def eig(band):
        return np.stack([scipy.linalg.eigvals_banded(b, lower=True)
                         for b in band])

    return (eig(band_t[:, :, :ML]) if ML else np.zeros((len(act), 0)),
            eig(band_g[:, :, :ML]) if ML else np.zeros((len(act), 0)),
            eig(band_t), eig(band_g))


def _split(eig, M, ML):
    """The kernel's lane layout [tG(M) | G(M) | tG(ML) | G(ML)] as the
    entry returns it, (tG_lag, G_lag, tG, G), each sorted."""
    eig = np.asarray(eig)
    return tuple(np.sort(p, axis=1) for p in (
        eig[:, 2 * M:2 * M + ML], eig[:, 2 * M + ML:], eig[:, :M],
        eig[:, M:2 * M]))


def test_projections_carry_the_numbers_of_the_scorers_bands():
    """The plain version's dense projections hold, entry for entry, what
    ``_band_from_blocks`` puts in the bands LAPACK solves."""
    h, beta, Cm = _recurrence()
    act = np.array([0, 3, 7])
    for m in (1, 2, 6):
        tG, G = banded_sturm.projections(h, beta, Cm, torch.as_tensor(act),
                                         m)
        band_t, band_g = tu._band_from_blocks(tu._to_host(h)[:, act],
                                              tu._to_host(beta)[:, act],
                                              Cm.numpy()[act], m, 2)
        for dense, band in ((tG, band_t), (G, band_g)):
            M = 2 * m
            for d in range(band.shape[1]):
                np.testing.assert_array_equal(
                    np.diagonal(dense.numpy(), offset=-d, axis1=1, axis2=2),
                    band[:, d, :M - d])
            assert torch.equal(dense, dense.transpose(1, 2))
            if M > 4:  # nothing outside the half-bandwidth 2bs − 1 = 3
                assert not torch.triu(dense, 4).any()


@pytest.mark.parametrize("m", [2, 6, 12, 20])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_bisection_matches_lapack(m, dtype):
    """tG and G at m and at m − 2 steps, a subset of candidates with the
    self-loop's rank-1 B among them: every eigenvalue within 1e-13·‖G‖ of
    LAPACK's, and Δ = Σ exp(d1)(−expm1(d2 − d1)) within 1e-11 relative."""
    h, beta, Cm = _recurrence(dtype)
    act = np.array([0, 2, 5, 7])
    m_lag = m - 2
    act_t = torch.as_tensor(act, dtype=torch.int32)
    eig = banded_sturm.spectra(h, beta, Cm, act_t, m, m_lag)
    got = _split(eig, 2 * m, 2 * m_lag)
    want = _lapack(h, beta, Cm, act, m, m_lag)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if w.size:
            norm = np.abs(w).max(axis=1, keepdims=True)
            assert np.all(np.abs(g - w) <= 1e-13 * norm)
    for (d1, d2), (e1, e2) in (((got[0], got[1]), (want[0], want[1])),
                               ((got[2], got[3]), (want[2], want[3]))):
        if not d1.size:
            continue
        x = tu._trace_fun_difference_np(d1, d2, "exp")
        y = tu._trace_fun_difference_np(e1, e2, "exp")
        np.testing.assert_allclose(x, y, rtol=1e-11, atol=0)


def test_non_finite_band_gives_nan_for_its_matrices_only():
    """A NaN in the recurrence at step 3 of one candidate: NaN throughout
    that candidate's matrices that reach step 3, finite everywhere else."""
    h, beta, Cm = _recurrence()
    h = h.clone()
    h[3, 1, 2, 0] = float("nan")  # alpha_3 of candidate 1: rows 6-7 of G
    act = torch.tensor([0, 1, 2], dtype=torch.int32)
    m, m_lag = 6, 3  # G up to row 11; the lag matrices stop at row 5
    eig = banded_sturm.spectra(h, beta, Cm, act, m, m_lag).numpy()
    M = 2 * m
    assert np.isnan(eig[1, :2 * M]).all()
    assert np.isfinite(eig[1, 2 * M:]).all()
    assert np.isfinite(eig[[0, 2]]).all()
    Cm = Cm.clone()
    Cm[2, 0, 1] = float("inf")  # only tG sees R0·B·R0ᵀ
    eig = banded_sturm.spectra(h, beta, Cm, act, m, m_lag).numpy()
    ML = 2 * m_lag
    assert np.isnan(eig[2, :M]).all() and np.isfinite(eig[2, M:2 * M]).all()
    assert np.isnan(eig[2, 2 * M:2 * M + ML]).all()
    assert np.isfinite(eig[2, 2 * M + ML:]).all()


class _T:
    """A stand-in for a CUDA tensor: what the path rules read, no card."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:0",
                 contiguous=True):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self._contiguous = contiguous

    def is_contiguous(self):
        return self._contiguous


def _inputs(steps=20, batch=250, bs=2, n_act=250, dtype=torch.float32,
            **change):
    """(h, beta, Cm, act) stand-ins of the kernel's inputs; ``change`` maps
    a name to the stand-in that replaces it."""
    args = {"h": _T((steps, batch, 2 * bs, bs), dtype),
            "beta": _T((steps, batch, bs, bs), dtype),
            "Cm": _T((batch, bs, bs), torch.float64),
            "act": _T((n_act,), torch.int32)}
    args.update(change)
    return args["h"], args["beta"], args["Cm"], args["act"]


@pytest.mark.parametrize("bs,dtype,device,rule", [
    (2, torch.float32, "cuda:0", True), (2, torch.float64, "cuda:0", True),
    (1, torch.float32, "cuda:0", True), (4, torch.float64, "cuda:0", True),
    (5, torch.float32, "cuda:0", False), (60, torch.float64, "cuda:0", False),
    (2, torch.float64, "cpu", False), (8, torch.float64, "cpu", False)])
def test_path_rule_reads_the_device_and_the_width(bs, dtype, device, rule):
    """CUDA blocks of at most four columns take the kernel; CPU blocks and
    wider CUDA blocks take host LAPACK."""
    assert tu._spectra_on_card(_T((20, 250, 2 * bs, bs), dtype,
                                  device)) is rule


@pytest.mark.parametrize("bs,dtype,m,m_lag,n_act", [
    (2, torch.float32, 6, 4, 250), (2, torch.float64, 20, 18, 260),
    (2, torch.float32, 100, 98, 3), (1, torch.float32, 2, 0, 1),
    (4, torch.float64, 100, 98, 50), (3, torch.float32, 1, 1, 7)])
def test_cuda_inputs_the_kernel_takes(bs, dtype, m, m_lag, n_act):
    h, beta, Cm, act = _inputs(steps=100, bs=bs, n_act=n_act, dtype=dtype)
    assert banded_sturm.on_kernel_path(h, beta, Cm, act, m, m_lag)


BAD = {
    "wider than four": dict(bs=5),
    "float16": dict(dtype=torch.float16),
    "mixed types": dict(beta=_T((20, 250, 2, 2), torch.float64)),
    "Cm float32": dict(Cm=_T((250, 2, 2), torch.float32)),
    "act int64": dict(act=_T((250,), torch.int64)),
    "no candidate": dict(n_act=0),
    "h not 4-d": dict(h=_T((20, 250, 4))),
    "h not (2bs, bs)": dict(h=_T((20, 250, 3, 2))),
    "beta shape": dict(beta=_T((19, 250, 2, 2))),
    "Cm shape": dict(Cm=_T((249, 2, 2), torch.float64)),
    "not contiguous": dict(h=_T((20, 250, 4, 2), contiguous=False)),
    "one on the CPU": dict(Cm=_T((250, 2, 2), torch.float64, "cpu")),
    "two cards": dict(act=_T((250,), torch.int32, "cuda:1")),
    "not CUDA": dict(h=_T((20, 250, 4, 2), device="meta"),
                     beta=_T((20, 250, 2, 2), device="meta"),
                     Cm=_T((250, 2, 2), torch.float64, "meta"),
                     act=_T((250,), torch.int32, "meta")),
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_other_cuda_inputs_raise(what):
    """The kernel's wrapper raises on what the kernel does not take; there
    is no fallback to the plain version or to LAPACK for a CUDA tensor."""
    change = dict(BAD[what])
    kw = {k: change.pop(k) for k in ("bs", "dtype", "n_act") if k in change}
    with pytest.raises(ValueError):
        banded_sturm.on_kernel_path(*_inputs(**kw, **change), 20, 18)


@pytest.mark.parametrize("m,m_lag", [(21, 19), (0, 0), (6, 7), (6, -1)])
def test_rounds_outside_the_recurrence_raise(m, m_lag):
    with pytest.raises(ValueError):
        banded_sturm.on_kernel_path(*_inputs(), m, m_lag)


@pytest.mark.parametrize("bs", [1, 2, 4])
def test_a_band_past_shared_memory_raises(bs):
    """The largest m whose band and working matrices fit a CTA's 200 KB is
    taken, one more step raises; the default schedule's 100 steps fit at
    every width."""
    h, beta, Cm, act = _inputs(steps=4000, bs=bs)
    m = max(m for m in range(1, 4000)
            if banded_sturm.shared_bytes(m * bs, bs) <= 200 * 1024)
    assert m >= 100
    assert banded_sturm.on_kernel_path(h, beta, Cm, act, m, m - 2)
    with pytest.raises(ValueError):
        banded_sturm.on_kernel_path(h, beta, Cm, act, m + 1, m - 1)


@pytest.mark.parametrize("lanes", [4, 40, 88, 152, 248, 256, 257, 408, 792,
                                   1592])
def test_plan_covers_every_lane_in_whole_warps(lanes):
    """GROUP threads a lane, whole warps a CTA, no CTA without a lane."""
    chunks, threads = banded_sturm.plan(lanes)
    per = threads // banded_sturm.GROUP
    assert chunks * per >= lanes > (chunks - 1) * per
    assert threads % 32 == 0 and threads <= banded_sturm.MAX_THREADS
    assert chunks == -(-lanes // (banded_sturm.MAX_THREADS //
                                  banded_sturm.GROUP))


def _score(monkeypatch, card: bool):
    """A host-eigh scoring call on a 200-node graph, its result, the growth
    of the spectra counters over it, and the candidates of each round; with
    ``card`` the path rules give the kernel's verdict and the launch runs the
    plain version."""
    if card:
        monkeypatch.setattr(tu, "_spectra_on_card", lambda h: True)
        monkeypatch.setattr(banded_sturm, "on_kernel_path", lambda *a: True)
        monkeypatch.setattr(banded_sturm, "spectra_cuda",
                            banded_sturm.spectra_plain)
    rounds = []
    entry = tu._eigvals_banded_batch

    def record(h, beta, Cm, act, *rest):
        rounds.append(len(act))
        return entry(h, beta, Cm, act, *rest)

    monkeypatch.setattr(tu, "_eigvals_banded_batch", record)
    A = random_graph(200, 0.05, seed=11)
    op = CooMatrix.from_scipy(A, device="cpu")
    C = np.stack(np.nonzero(np.triu(A.toarray(), 1)), axis=1)[:10]
    tol = 1e-9 * float(np.exp(np.linalg.eigvalsh(A.toarray()).max()))
    U0 = tu.edge_start_blocks(200, C, torch.float64, "cpu")
    B = tu.edge_B(C, -1.0, 1.0, torch.float64, "cpu")
    keys = ("spectra.members_kernel", "spectra.members_host",
            "spectra.launches.sturm")
    before = tracing.counters()
    r = tu._trace_update_host_eigh(op, U0, B, get_fun("exp"), tol,
                                   (6, 6, 8, 12), lag=2)
    after = tracing.counters()
    return r, {k: after.get(k, 0) - before.get(k, 0) for k in keys}, rounds


def test_cpu_blocks_take_lapack_and_count_host_members(monkeypatch):
    _, grew, rounds = _score(monkeypatch, card=False)
    assert len(rounds) > 1
    assert grew == {"spectra.members_kernel": 0,
                    "spectra.members_host": 4 * sum(rounds),
                    "spectra.launches.sturm": 0}


def test_kernel_route_counts_members_and_launches(monkeypatch):
    """Blocks the rule sends to the card take one launch a round and count
    four matrices a candidate; the scorer's decisions are LAPACK's (the
    launch replaced here by the plain version, the rules by their verdict on
    a card)."""
    with pytest.MonkeyPatch.context() as mp:
        want, _, want_rounds = _score(mp, card=False)
    got, grew, rounds = _score(monkeypatch, card=True)
    assert rounds == want_rounds
    assert grew == {"spectra.members_kernel": 4 * sum(rounds),
                    "spectra.members_host": 0,
                    "spectra.launches.sturm": len(rounds)}
    np.testing.assert_array_equal(got.iters.numpy(), want.iters.numpy())
    np.testing.assert_array_equal(got.converged.numpy(),
                                  want.converged.numpy())
    np.testing.assert_allclose(got.delta.numpy(), want.delta.numpy(),
                               rtol=1e-11, atol=0)


def test_source_is_registered():
    assert cuda_build.SOURCES["banded_sturm"].name == "banded_sturm.cu"
    assert cuda_build.SOURCES["banded_sturm"].exists()


@pytest.mark.parametrize("n,bs", [(12, 2), (41, 2), (40, 4), (9, 3)])
def test_tridiagonalization_keeps_the_spectrum_and_leaves_no_band(n, bs):
    """The rotations leave exact zeros beyond the first off-diagonal and the
    eigenvalues of the band matrix to O(eps·‖X‖)."""
    w = 2 * bs - 1
    rng = np.random.default_rng(n)
    X = np.tril(rng.standard_normal((3, n, n)))
    X = np.where(np.arange(n)[:, None] - np.arange(n)[None, :] <= w, X, 0.0)
    X = torch.from_numpy(X + np.transpose(np.tril(X, -1), (0, 2, 1)))
    B = banded_sturm.band_rows(X, w)
    for k, p, col in banded_sturm._rotations(n, w):
        banded_sturm.rotate(B, k, p, col)
    assert not B[:, :, :w].any()
    d, e = B[:, :, w + 1], B[:, 1:, w]
    T = torch.diag_embed(d) + torch.diag_embed(e, -1) + \
        torch.diag_embed(e, 1)
    want = torch.linalg.eigvalsh(X)
    assert float((torch.linalg.eigvalsh(T) - want).abs().max()) <= \
        1e-13 * float(want.abs().max())


@pytest.mark.parametrize("n,w", [(40, 3), (25, 7), (13, 5), (8, 3)])
def test_the_kernels_wavefront_gives_the_sequential_bits(n, w):
    """The kernel runs the rotations of wavefront t = 3j + s (chase j, step
    s) on a warp's lanes at once; that order, within a wavefront in any
    order, gives the bits of the sequential chases."""
    rng = np.random.default_rng(w)
    X = np.tril(rng.standard_normal((2, n, n)))
    X = np.where(np.arange(n)[:, None] - np.arange(n)[None, :] <= w, X, 0.0)
    X = torch.from_numpy(X + np.transpose(np.tril(X, -1), (0, 2, 1)))
    want = banded_sturm.band_rows(X, w)
    for k, p, col in banded_sturm._rotations(n, w):
        banded_sturm.rotate(want, k, p, col)
    got = banded_sturm.band_rows(X, w)
    for k in range(w, 1, -1):
        jmax = n - k - 1
        for t in range(3 * jmax + 1):
            wave = []
            for j in range(min(t // 3, jmax), -1, -1):
                s = t - 3 * j
                i = j + k + s * k
                if i >= n:
                    break
                wave.append((i - 1, j if s == 0 else i - k - 1))
            for p, col in reversed(wave):  # the wavefront's order is free
                banded_sturm.rotate(got, k, p, col)
    assert torch.equal(got, want)
