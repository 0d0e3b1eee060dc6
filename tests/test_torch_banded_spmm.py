"""Banded-ELL operator of the PyTorch port (ops/banded_spmm.py) against the
JAX package's BandedEllOperator in interpret mode, and against scipy.

On the CPU the port runs K3's plain version; the CUDA kernel runs on the
card (chip_smoke.py). f64 products agree to rtol 1e-12 (round-off of a
different summation order); entry addressing and edits agree exactly."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.graphs.centrality import compute_centrality_host
from krylov_robustness_torch.graphs.top_edges import find_top_missing_edges
from krylov_robustness_torch.interop import banded_ell_from_arrays
from krylov_robustness_torch.ops import banded_spmm, cuda_build
from krylov_robustness_torch.ops.banded_spmm import (
    BandedEllOperator,
    make_operator,
    rcm_permutation,
)
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_torch.optimize import greedy as tgreedy
from krylov_robustness_tpu.ops import pallas_spmm as jspmm
from krylov_robustness_tpu.ops.sparse import CooMatrix as JCoo
from test_pallas_spmm import banded_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _pair(A, jdt=jnp.float64, tdt=torch.float64):
    return (jspmm.BandedEllOperator(A, dtype=jdt, interpret=True),
            BandedEllOperator(A, dtype=tdt, device="cpu"))


def _permuted(A):
    """The operand greedy's banded backend builds (JAX greedy.py:645)."""
    perm = rcm_permutation(A)
    return A[perm, :].tocsc()[:, perm].tocsr()


@pytest.mark.parametrize("b", [None, 8, 100])
def test_plain_matches_jax_interpret(b):
    """K3's plain version on tests/test_pallas_spmm.py::banded_graph, f64,
    vector and block right-hand sides."""
    A = banded_graph()
    jop, op = _pair(A)
    shape = (A.shape[0],) if b is None else (A.shape[0], b)
    x = np.random.default_rng(1).standard_normal(shape)
    yj = np.asarray(jop @ jnp.asarray(x))
    yt = (op @ torch.as_tensor(x)).numpy()
    assert yt.shape == shape
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(yt, A @ x, rtol=1e-12, atol=1e-12)


def test_layout_and_entry_addressing_match_jax():
    """Slot k of row r is the k-th CSR entry of r in both packages, so
    ``entry_index`` and ``_entry_pos`` address the same entries; the
    greedy operand is permuted as the JAX package permutes it."""
    Ap = _permuted(banded_graph(n=400, max_off=60, extra=120,
                                weighted=False))
    jop, op = _pair(Ap)
    assert (op.n, op.nnz, op.K, op.Wv, op.num_windows) == (
        jop.n, jop.nnz, jop.K, jop.Wv, jop.num_windows)
    for got, want in zip(op._entry_pos, jop._entry_pos):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(op._entry_cols, jop._entry_cols)
    C = sp.coo_matrix(Ap)
    for i, j in zip(C.row[::7], C.col[::7]):
        assert op.entry_index(int(i), int(j)) == jop.entry_index(int(i),
                                                                  int(j))
    np.testing.assert_array_equal(
        op.entry_index(C.row, C.col),
        [jop.entry_index(int(i), int(j)) for i, j in zip(C.row, C.col)])
    with pytest.raises(KeyError):
        op.entry_index(0, op.n - 1)


def test_padding_slots_hold_zero_and_own_row():
    """A padding slot holds val 0 and col r, so the ELL kernel (b below
    ``GATHER_MIN_B``) and the plain version both add 0·x[r]: a NaN in x[r]
    reaches y[r], as it does through a real entry, and nowhere else. The row
    gather never reads a padding slot (``test_row_index_reads_the_ell``)."""
    A = banded_graph(n=300, max_off=60, extra=100)
    op = BandedEllOperator(A, dtype=torch.float64, device="cpu")
    real = np.zeros((op.K, op.n), bool)
    real[op._entry_pos] = True
    cols, vals = op.cols.numpy(), op.vals.numpy()
    r = np.broadcast_to(np.arange(op.n), cols.shape)
    np.testing.assert_array_equal(cols[~real], r[~real])
    assert np.all(vals[~real] == 0)
    deg = np.diff(A.indptr)
    row = int(np.argmin(deg))  # a row with padding slots, isolated in x
    x = np.zeros((op.n, 2))
    x[row] = np.nan
    y = (op @ torch.as_tensor(x)).numpy()
    hit = set(A[:, [row]].nonzero()[0].tolist()) | {row}
    assert set(np.nonzero(np.isnan(y[:, 0]))[0].tolist()) == hit


def test_update_entry_values_and_set_edge_match_jax():
    A = banded_graph(n=256, max_off=40, extra=50)
    jop, op = _pair(A)
    jop.update_entry_values(np.array([0, 1]), np.array([0.0, 0.0]))
    op.update_entry_values(np.array([0, 1]), np.array([0.0, 0.0]))
    C = sp.coo_matrix(sp.tril(A, -1))
    i, j = int(C.row[5]), int(C.col[5])
    jop.set_edge(i, j, 0.25)
    op.set_edge(i, j, 0.25)
    ks, rows = jop._entry_pos
    np.testing.assert_array_equal(op.entry_values(),
                                  np.asarray(jop.valT)[ks, rows])
    np.testing.assert_array_equal(op.vals.numpy(),
                                  np.asarray(jop.valT)[:, :op.n])
    x = np.random.default_rng(3).standard_normal((256, 3))
    np.testing.assert_allclose((op @ torch.as_tensor(x)).numpy(),
                               np.asarray(jop @ jnp.asarray(x)),
                               rtol=1e-12, atol=1e-12)


def test_float32_matches_scipy():
    """f32 tables and x: the plain version to f32 round-off of max|y|."""
    A = banded_graph(n=500, max_off=80, extra=150, weighted=False)
    op = BandedEllOperator(A, dtype=torch.float32, device="cpu")
    assert op.dtype == torch.float32 and op.cols.dtype == torch.int32
    x = np.random.default_rng(4).standard_normal((500, 7)).astype(np.float32)
    ref = A @ x.astype(np.float64)
    got = (op @ torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def _slotted(n=400, num=40):
    """A road-like banded graph with make mode's candidate slots, as greedy
    builds them: its top ``num`` missing edges in the 'min' order as
    explicit zeros in both triangles, relabeled in COO space under A's own
    RCM order. Returns (A, the slots (num, 2) in A's labels, the relabeled
    CSR matrix with its slots, pinv)."""
    A = banded_graph(n=n, max_off=60, extra=120, weighted=False)
    c = compute_centrality_host(A, "eig")
    slots = find_top_missing_edges(A, c, num, "min")
    Ap, pinv = tgreedy._relabel(tgreedy._with_zero_slots(A, slots),
                                rcm_permutation(A))
    return A, slots, Ap, pinv


def test_make_slots_are_stored_entries_and_commits_write_both():
    """Explicit zeros of the CSR matrix are stored entries of the banded
    operator: its nnz and K count them and each holds 0; ``set_edge`` on a
    slot writes both triangles and nothing else; the plain product equals
    scipy's before and after the commit; the greedy adapter's ``to_scipy``
    drops the slots still at zero, in the original labels."""
    A, slots, Ap, pinv = _slotted()
    op = BandedEllOperator(Ap, dtype=torch.float64, device="cpu")
    assert op.nnz == Ap.nnz == A.nnz + 2 * len(slots)
    assert op.K == int(np.diff(Ap.indptr).max()) > int(
        np.diff(A.indptr).max())
    mine = pinv[slots]
    both = np.concatenate([op.entry_index(mine[:, 0], mine[:, 1]),
                           op.entry_index(mine[:, 1], mine[:, 0])])
    before = op.entry_values()
    assert np.all(before[both] == 0)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (op.n, 100)))
    np.testing.assert_allclose(op.matmul_plain(x).numpy(), Ap @ x.numpy(),
                               rtol=1e-12, atol=1e-12)
    i, j = (int(v) for v in slots[7])
    F = tgreedy._BandedAdapter(op, pinv)
    F.set_edge(i, j, 1.0)
    after = op.entry_values()
    hit = [op.entry_index(int(pinv[i]), int(pinv[j])),
           op.entry_index(int(pinv[j]), int(pinv[i]))]
    assert np.all(after[hit] == 1.0)
    rest = np.ones(op.nnz, bool)
    rest[hit] = False
    np.testing.assert_array_equal(after[rest], before[rest])
    B = Ap.tolil()
    B[int(pinv[i]), int(pinv[j])] = B[int(pinv[j]), int(pinv[i])] = 1.0
    np.testing.assert_allclose(op.matmul_plain(x).numpy(),
                               B.tocsr() @ x.numpy(), rtol=1e-12, atol=1e-12)
    want = A.tolil()
    want[i, j] = want[j, i] = 1.0
    got = F.to_scipy()
    assert got.nnz == A.nnz + 2
    _assert_same_csr(got, want.tocsr())


def test_make_operator_off_cuda_is_coo_like_jax_off_the_tpu():
    """Off the card the port, like the JAX package off the TPU, returns COO
    and the identity permutation, for a narrow band and a wide one."""
    for A in (banded_graph(n=400, max_off=40, extra=80),
              random_graph(400, 0.05, seed=4)):
        op, perm = make_operator(A, dtype=torch.float64, device="cpu")
        jop, jperm = jspmm.make_operator(A, dtype=jnp.float64)
        assert isinstance(op, CooMatrix) and isinstance(jop, JCoo)
        np.testing.assert_array_equal(perm, np.arange(A.shape[0]))
        np.testing.assert_array_equal(jperm, np.arange(A.shape[0]))
        x = np.random.default_rng(5).standard_normal((A.shape[0], 2))
        np.testing.assert_allclose((op @ torch.as_tensor(x)).numpy(), A @ x,
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jdt", [jnp.float64, jnp.float32])
def test_interop_from_jax_lane_windows(jdt):
    """A port operator decoded from the JAX operator's rel/win/val tables
    equals the port's own packing and computes the JAX product."""
    A = banded_graph(n=600, max_off=150, extra=200)
    jop = jspmm.BandedEllOperator(A, dtype=jdt, interpret=True)
    op = banded_ell_from_arrays(np.asarray(jop.relT), np.asarray(jop.winT),
                                np.asarray(jop.valT), jop.Wv, jop.n,
                                jop._entry_pos, "cpu")
    tdt = torch.float32 if jdt == jnp.float32 else torch.float64
    own = BandedEllOperator(A, dtype=tdt, device="cpu")
    assert op.dtype == tdt and (op.Wv, op.K) == (jop.Wv, jop.K)
    torch.testing.assert_close(op.cols, own.cols, rtol=0, atol=0)
    torch.testing.assert_close(op.vals, own.vals, rtol=0, atol=0)
    x = np.random.default_rng(6).standard_normal((600, 4)).astype(
        np.float32 if tdt == torch.float32 else np.float64)
    yj = np.asarray(jop @ jnp.asarray(x))
    yt = (op @ torch.as_tensor(x)).numpy()
    tol = 1e-6 if tdt == torch.float32 else 1e-12
    assert np.abs(yt - yj).max() <= tol * np.abs(yj).max()


def test_kernel_wrapper_refuses_cpu_tensors():
    """K3 takes CUDA tensors only: a CPU call raises, it never falls back,
    on either side of the width where it takes the row gather."""
    op = BandedEllOperator(banded_graph(n=300, max_off=30, extra=60),
                           dtype=torch.float32, device="cpu")
    for b in (4, banded_spmm.GATHER_MIN_B):
        with pytest.raises(ValueError, match="CUDA"):
            banded_spmm.ell_spmm(op.cols, op.vals, op._row_ptr, op._cols,
                                 op._val_off, torch.zeros((300, b)))


@pytest.mark.parametrize("graph", ["banded", "random", "from_tables"])
def test_row_index_reads_the_ell(graph):
    """K3's row index over the flattened (K, n) vals is the operator's
    matrix in CSR form and stays so after ``set_edge`` (the explicit zero
    kept); it names no padding slot, and its product equals the plain
    version's slot-order sum for finite x in f64."""
    if graph == "from_tables":
        A = banded_graph(n=600, max_off=150, extra=200)
        jop = jspmm.BandedEllOperator(A, dtype=jnp.float64, interpret=True)
        op = banded_ell_from_arrays(
            np.asarray(jop.relT), np.asarray(jop.winT), np.asarray(jop.valT),
            jop.Wv, jop.n, jop._entry_pos, "cpu")
    else:
        A = _permuted(banded_graph(n=500, max_off=60, extra=120)
                      if graph == "banded" else random_graph(300, 0.03,
                                                             seed=7))
        op = BandedEllOperator(A, dtype=torch.float64, device="cpu")
    A = sp.csr_matrix(A)
    A.sort_indices()
    row_ptr, cols, val_off = (t.numpy() for t in (op._row_ptr, op._cols,
                                                  op._val_off))
    assert all(t.dtype == torch.int32 for t in (op._row_ptr, op._cols,
                                                op._val_off))
    k, r = val_off // op.n, val_off % op.n
    rows = np.repeat(np.arange(op.n), np.diff(row_ptr))
    np.testing.assert_array_equal(r, rows)
    assert np.all(k < np.diff(A.indptr)[rows])  # no padding slot

    def indexed():
        flat = op.vals.reshape(-1).numpy()
        return sp.csr_matrix((flat[val_off], cols, row_ptr), shape=A.shape)

    _assert_same_csr(indexed(), A)
    C = sp.coo_matrix(sp.tril(A, -1))
    i, j = int(C.row[3]), int(C.col[3])
    op.set_edge(i, j, 0.0)
    A2 = A.copy()
    A2[i, j] = A2[j, i] = 0.0  # explicit zeros: the structure is frozen
    _assert_same_csr(indexed(), A2)
    x = np.random.default_rng(9).standard_normal((op.n, 40))
    y = op.matmul_plain(torch.as_tensor(x)).numpy()
    assert np.abs(indexed() @ x - y).max() <= 1e-13 * np.abs(y).max()


def _assert_same_csr(got, want):
    """Equal structure (explicit zeros count) and equal values."""
    want = sp.csr_matrix(want)
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_non_cpu_tensor_never_takes_the_plain_path(monkeypatch):
    op = BandedEllOperator(banded_graph(n=300, max_off=30, extra=60),
                           dtype=torch.float32, device="cpu")
    called = []
    monkeypatch.setattr(banded_spmm, "ell_spmm_plain",
                        lambda *a: called.append(a) or a[2])
    with pytest.raises(ValueError):
        op.matmul(torch.zeros((300, 4), device="meta"))
    assert not called


def test_one_build_per_source_all_started_together(monkeypatch, tmp_path):
    """Without a library on disk, every source gets its own nvcc process,
    all started before the first is waited on."""
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    events = []

    class FakeProc:
        returncode = 0

        def __init__(self, cmd, **kw):
            self.out = cmd[cmd.index("-o") + 1]
            events.append(("start", cmd[-1]))

        def communicate(self):
            events.append(("wait", self.out))
            open(self.out, "w").close()
            return "", ""

    monkeypatch.setattr(cuda_build.subprocess, "Popen", FakeProc)
    built = cuda_build.build_kernels()
    assert set(built) == set(cuda_build.SOURCES)
    nsrc = len(cuda_build.SOURCES)
    # K1/K2, K3, K4, the block step (block_mgs) and the spectra
    # (banded_sturm)
    assert nsrc == 5
    assert [e for e, _ in events] == ["start"] * nsrc + ["wait"] * nsrc
    assert all(p.exists() and p.parent == tmp_path for p, _ in
               built.values())
    again = cuda_build.build_kernels()
    assert all(s == 0.0 for _, s in again.values())
