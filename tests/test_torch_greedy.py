"""The slice as a whole: the PyTorch port's greedy_krylov against the JAX
package's on the n=120/150 graphs of tests/test_greedy.py, break and make,
COO, super-tile and banded backends, per-step and fused lanes, and the
backend choice on a CUDA device against the JAX package's on a TPU.

f64: identical edges, rob_variation rtol 1e-9, identical A_new.
f32 (Sturm spectra + f32 floor): identical edges, rob_variation rtol 1e-4.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.graphs.centrality import compute_centrality_host
from krylov_robustness_torch.graphs.top_edges import (
    find_top_edges,
    find_top_missing_edges,
)
from krylov_robustness_torch.optimize import fused as tfused
from krylov_robustness_torch.optimize import greedy as tgreedy
from krylov_robustness_torch.optimize.greedy import (
    greedy_krylov,
    krylov_miobi,
)
from krylov_robustness_tpu.graphs.centrality import compute_centrality
from krylov_robustness_tpu.ops.sparse import CooMatrix
from krylov_robustness_tpu.optimize.greedy import (
    greedy_krylov as jax_greedy_krylov,
)
from test_greedy import brute_force_greedy, connected_random_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def path_graph(seed, extra, n=150):
    """A path plus ``extra`` short chords (tests/test_greedy.py:363-493)."""
    rng = np.random.default_rng(seed)
    i = np.arange(n - 1)
    src = np.concatenate([i, rng.integers(0, n - 21, extra)])
    dst = np.concatenate([i + 1, np.zeros(extra, np.int64)])
    dst[n - 1:] = src[n - 1:] + rng.integers(1, 20, extra)
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float64)
    A.setdiag(0)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    return A


@pytest.fixture(scope="module")
def graph():
    A = path_graph(23, 80)
    c = np.asarray(compute_centrality(CooMatrix.from_scipy(A), "eig"))
    lam = float(np.linalg.eigvalsh(A.toarray()).max())
    return A, c, 1e-6 * float(np.exp(lam))


def _both(graph, mode, backend, fused_steps, f32, k=5, Q=20):
    A, c, tol32 = graph
    tol = tol32 if f32 else 1e-8
    kw = dict(order="min", tol=tol, mode=mode, backend=backend,
              fused_steps=fused_steps)
    rj = jax_greedy_krylov(A, k, Q, c, dtype=jnp.float32 if f32
                           else jnp.float64, **kw)
    rt = greedy_krylov(A, k, Q, c, dtype=torch.float32 if f32
                       else torch.float64, device="cpu", **kw)
    return rj, rt


@pytest.mark.parametrize("fused_steps", [0, 3])
@pytest.mark.parametrize("backend", ["coo", "bsr"])
@pytest.mark.parametrize("mode", ["break", "make"])
def test_f64_matches_jax(graph, mode, backend, fused_steps):
    rj, rt = _both(graph, mode, backend, fused_steps, f32=False)
    np.testing.assert_array_equal(rt.edges, rj.edges)
    np.testing.assert_allclose(rt.rob_variation, rj.rob_variation, rtol=1e-9)
    assert (rt.A_new != rj.A_new).nnz == 0
    assert rt.operator == ("CooMatrix" if backend == "coo"
                           else "SuperBsrOperator(f32)")
    assert (rt.fused_accepted > 0) == (fused_steps > 1)


@pytest.mark.parametrize("mode,backend,fused_steps", [
    ("break", "coo", 0), ("make", "coo", 0), ("break", "bsr", 0),
    ("make", "bsr", 0), ("break", "coo", 3), ("make", "bsr", 3),
])
def test_f32_matches_jax(graph, mode, backend, fused_steps):
    """The f32 lane (bf16x2 products on the super-tile backend). The fused
    lane's Sturm spectra run as eager torch ops, slow on a CPU: two fused
    configurations, on a 10-candidate window, keep the file fast."""
    rj, rt = _both(graph, mode, backend, fused_steps, f32=True,
                   k=4 if fused_steps else 5, Q=10 if fused_steps else 20)
    if fused_steps:
        assert rt.fused_accepted > 0
    np.testing.assert_array_equal(rt.edges, rj.edges)
    np.testing.assert_allclose(rt.rob_variation, rj.rob_variation, rtol=1e-4)
    if backend == "bsr":
        assert rt.operator == "SuperBsrOperator(bf16x2)"


def test_fused_steps_none_resolves_per_dtype(graph, monkeypatch):
    """``fused_steps=None`` (the experiments' auto value, a TypeError in the JAX
    package) means 10 fused steps per block in f32 and the per-step loop in
    f64."""
    A, c, _ = graph
    lanes = []
    monkeypatch.setattr(tgreedy, "_greedy_loop_fused",
                        lambda *a, R, **kw: lanes.append(("fused", R)))
    monkeypatch.setattr(tgreedy, "_greedy_loop",
                        lambda *a, **kw: lanes.append(("per-step", 0)))
    for dtype in (torch.float32, torch.float64):
        greedy_krylov(A, 3, 20, c, order="min", backend="coo",
                      fused_steps=None, dtype=dtype, device="cpu")
    assert lanes == [("fused", 10), ("per-step", 0)]


def test_no_finite_score_is_not_ok():
    """A window whose scores are all non-finite has no winner: the fused
    block reports ok=False for that step (the JAX block commits candidate 0
    blindly), so the host replays it on the accurate lane."""
    A = path_graph(23, 80)
    c = np.asarray(compute_centrality(CooMatrix.from_scipy(A), "eig"))
    top = find_top_edges(A, c, 12, "min")
    F = tgreedy._FrozenStructureMatrix(A, None, torch.float64, device="cpu")
    op, vals = F.fused_state()
    nan_vals = torch.full_like(vals, float("nan"))
    _, alive, (hs, dls, its, oks, nfs) = tfused.fused_greedy_block(
        op, nan_vals, top, F.fused_slots(top), np.ones(len(top), bool), 0.0,
        1e-8, 0.0, -1.0, 1.0, rebuild=F.fused_rebuild, Q=10, R=2,
        mode="break", fun_name="exp")
    assert not bool(oks.any())
    assert int(nfs[0]) == 10
    assert bool(torch.isnan(nan_vals).all())  # the block worked on a copy


def test_partial_block_commits_only_accepted_steps(graph, monkeypatch):
    """A block accepted up to step 1 only: the host commits the accepted
    winner into the pre-block storage (the block worked on a copy) and
    replays the next step per-step; the sweep equals the per-step loop."""
    A, c, _ = graph
    calls = []
    real = tfused.fused_greedy_block

    def first_step_only(*a, **kw):
        vals_f, alive, (hs, dls, its, oks, nfs) = real(*a, **kw)
        calls.append(1)
        oks = oks.clone()
        oks[1:] = False
        return vals_f, alive, (hs, dls, its, oks, nfs)

    monkeypatch.setattr(tfused, "fused_greedy_block", first_step_only)
    for backend in ("coo", "bsr"):
        kw = dict(order="min", tol=1e-8, backend=backend,
                  dtype=torch.float64, device="cpu")
        r_step = greedy_krylov(A, 4, 20, c, fused_steps=0, **kw)
        r_part = greedy_krylov(A, 4, 20, c, fused_steps=3, **kw)
        np.testing.assert_array_equal(r_part.edges, r_step.edges)
        assert (r_part.A_new != r_step.A_new).nnz == 0
        assert r_part.fused_accepted == 2
    assert calls


class _MemoryCheckpoint:
    """Any object with load/save/clear serves as a checkpoint."""

    def __init__(self):
        self.state = None
        self.cleared = False

    def load(self, dataset):
        return None if self.state is None else dict(
            self.state, edges=np.asarray(self.state["edges"]).reshape(-1, 2))

    def save(self, dataset, step, edges, rob, extra=None):
        self.state = dict(step=step, edges=[list(e) for e in edges],
                          rob_variation=rob, extra=dict(extra or {}))

    def clear(self):
        self.cleared = True


@pytest.mark.parametrize("fused_steps", [0, 3])
@pytest.mark.parametrize("mode", ["break", "make"])
def test_checkpoint_resume(graph, mode, fused_steps):
    """Interrupted after 2 steps and resumed from the checkpoint, the sweep
    equals an uninterrupted one."""
    A, c, _ = graph
    kw = dict(order="min", tol=1e-8, mode=mode, backend="bsr",
              fused_steps=fused_steps, dtype=torch.float64, device="cpu")
    full = greedy_krylov(A, 5, 20, c, **kw)
    ck = _MemoryCheckpoint()
    greedy_krylov(A, 2, 20, c, checkpoint=ck, **kw)
    assert ck.cleared and ck.state["step"] == 2
    resumed = greedy_krylov(A, 5, 20, c, checkpoint=ck, **kw)
    np.testing.assert_array_equal(resumed.edges, full.edges)
    np.testing.assert_allclose(resumed.rob_variation, full.rob_variation,
                               rtol=1e-12)
    assert (resumed.A_new != full.A_new).nnz == 0
    assert ck.state["step"] == 5


@pytest.mark.parametrize("mode", ["break", "make"])
def test_krylov_miobi_matches_bruteforce(mode):
    n, k = 60, 3
    A = connected_random_graph(n, 0.08, seed=17)
    Ad = A.toarray()
    E = None
    if mode == "make":
        I, J = np.nonzero(np.tril(1 - Ad - np.eye(n), -1))
        E = np.stack([I, J], axis=1)
    res = krylov_miobi(A, k, E=E, mode=mode, tol=1e-8, device="cpu")
    _, total_bf, _ = brute_force_greedy(Ad, k, mode)
    np.testing.assert_allclose(res.rob_variation, total_bf, rtol=1e-5)


def test_unported_backends_and_devices_raise(graph):
    """Every backend of the JAX package is ported: 'sharded' and
    'sharded_bsr' run (on a one-rank mesh without a process group; the
    multi-rank cases are in tests/test_torch_parallel.py) with the COO
    backend's picks, 'banded' runs; an unknown backend, a missing or absent
    device raises."""
    A, c, _ = graph
    rc = greedy_krylov(A, 2, 20, c, order="min", backend="coo", device="cpu")
    for backend, op in (("sharded", "RowShardedMatrix"),
                        ("sharded_bsr", "BsrRowShardedMatrix(f32)")):
        r = greedy_krylov(A, 2, 20, c, order="min", backend=backend,
                          device="cpu")
        assert r.operator == op
        np.testing.assert_array_equal(r.edges, rc.edges)
    r = greedy_krylov(A, 2, 20, c, order="min", backend="banded",
                      device="cpu")
    assert r.operator == "BandedEllOperator" and len(r.edges) == 2
    with pytest.raises(ValueError):
        greedy_krylov(A, 2, 20, c, backend="bogus", device="cpu")
    with pytest.raises(ValueError):
        greedy_krylov(A, 2, 20, c, device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            greedy_krylov(A, 2, 20, c, device="cuda")


@pytest.mark.parametrize("n", [120, 150])
@pytest.mark.parametrize("backend", ["banded", "bsr"])
def test_pallas_backends_match_jax(n, backend):
    """tests/test_greedy.py:173-203's setup against the JAX package: at
    n = 120 the scorer runs the phase lane on these operators (they have no
    ``todense``), at n = 150 the host-eigh lane. f64: identical edges,
    rob_variation to rtol 1e-9, identical A_new."""
    A = path_graph(8, 60, n=120) if n == 120 else path_graph(23, 80)
    c = np.asarray(compute_centrality(CooMatrix.from_scipy(A), "eig"))
    kw = dict(order="min", tol=1e-8, mode="break", backend=backend)
    rj = jax_greedy_krylov(A, 3, 12, c, **kw)
    rt = greedy_krylov(A, 3, 12, c, dtype=torch.float64, device="cpu", **kw)
    np.testing.assert_array_equal(rt.edges, rj.edges)
    np.testing.assert_allclose(rt.rob_variation, rj.rob_variation, rtol=1e-9)
    assert (rt.A_new != rj.A_new).nnz == 0
    assert rt.operator == ("BandedEllOperator" if backend == "banded"
                           else "SuperBsrOperator(f32)")


@pytest.fixture(scope="module")
def decision_graphs():
    """A road-like graph whose RCM band spans 1 window, and a random one
    whose band spans 23 (more than the 17 the banded kernel takes)."""
    narrow = path_graph(23, 80)
    wide = random_graph(2000, 0.003, seed=3)
    return {name: (A, compute_centrality_host(A, "eig"))
            for name, A in (("narrow", narrow), ("wide", wide))}


def _choice(graphs, band, Q, mode, backend, fits, monkeypatch):
    A, c = graphs[band]
    top = (find_top_missing_edges if mode == "make" else find_top_edges)(
        A, c, Q + 5, "min")
    if not fits:
        monkeypatch.setattr(tgreedy, "BSR_STORAGE_CAP", 0)
    kind, _, _ = tgreedy.choose_operator(A, top, Q, mode, backend,
                                         torch.device("cuda"))
    return kind


# expected operator per (Q, mode, band, fits), read from the JAX package's
# choice on the TPU (greedy.py:595-648): super tiles at 2Q >= 256 while they
# fit the cap, else banded in break mode while the band spans <= 17 windows,
# else COO
AUTO_GRID = {
    (50, "break", "narrow", True): "banded",
    (50, "break", "narrow", False): "banded",
    (50, "break", "wide", True): "coo",
    (50, "break", "wide", False): "coo",
    (50, "make", "narrow", True): "coo",
    (50, "make", "narrow", False): "coo",
    (50, "make", "wide", True): "coo",
    (50, "make", "wide", False): "coo",
    (250, "break", "narrow", True): "bsr",
    (250, "break", "narrow", False): "banded",
    (250, "break", "wide", True): "bsr",
    (250, "break", "wide", False): "coo",
    (250, "make", "narrow", True): "bsr",
    (250, "make", "narrow", False): "coo",
    (250, "make", "wide", True): "bsr",
    (250, "make", "wide", False): "coo",
}


@pytest.mark.parametrize("cell", sorted(AUTO_GRID))
def test_auto_choice_on_cuda_is_jax_choice_on_tpu(cell, decision_graphs,
                                                  monkeypatch):
    """backend='auto' with a CUDA device (a torch.device object: nothing is
    allocated) chooses the operator the JAX package chooses on a TPU."""
    Q, mode, band, fits = cell
    assert _choice(decision_graphs, band, Q, mode, "auto", fits,
                   monkeypatch) == AUTO_GRID[cell]


@pytest.mark.parametrize("backend,Q,mode,band,fits,want", [
    ("coo", 250, "break", "narrow", True, "coo"),
    ("banded", 250, "break", "narrow", True, "banded"),
    ("banded", 50, "make", "narrow", True, "coo"),
    ("banded", 50, "break", "wide", True, "coo"),
    ("bsr", 50, "break", "narrow", True, "bsr"),
    ("bsr", 50, "break", "narrow", False, "banded"),
    ("bsr", 50, "make", "narrow", False, "coo"),
])
def test_explicit_backend_choice_is_jax_choice(backend, Q, mode, band, fits,
                                               want, decision_graphs,
                                               monkeypatch):
    """Explicit backends on a CUDA device, as the JAX package decides them
    on any platform: 'banded' falls back to COO in make mode or past 17
    windows, 'bsr' past the cap to banded (break) or COO."""
    assert _choice(decision_graphs, band, Q, mode, backend, fits,
                   monkeypatch) == want


def test_auto_on_cpu_is_coo(graph):
    A, c, _ = graph
    top = find_top_edges(A, c, 100, "min")
    for Q in (50, 250):
        assert tgreedy.choose_operator(A, top, Q, "break", "auto",
                                       torch.device("cpu"))[0] == "coo"


def test_fused_request_on_banded_runs_per_step_like_jax(graph):
    """An f32 fused_steps=10 request on the banded operator (no fused hooks)
    runs the per-step lane, as the JAX package's guard sends it; picks equal
    JAX's, rob_variation to the f32 lane's rtol 1e-4."""
    A, c, tol32 = graph
    kw = dict(order="min", tol=tol32, mode="break", backend="banded",
              fused_steps=10)
    rj = jax_greedy_krylov(A, 3, 12, c, dtype=jnp.float32, **kw)
    rt = greedy_krylov(A, 3, 12, c, dtype=torch.float32, device="cpu", **kw)
    assert rt.operator == "BandedEllOperator"
    assert rt.fused_accepted == 0
    np.testing.assert_array_equal(rt.edges, rj.edges)
    np.testing.assert_allclose(rt.rob_variation, rj.rob_variation, rtol=1e-4)
