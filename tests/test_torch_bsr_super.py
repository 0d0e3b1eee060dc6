"""Super-tile operator of the PyTorch port (ops/bsr_super.py) against the JAX
package's SuperBsrOperator in interpret mode, and against scipy: the
packing equals the JAX package's, and the operator, whose values are one
array in CSR order, computes the products the packed tiles compute.

On the CPU the port runs the kernels' plain versions; the CUDA kernels run
on the card (chip_smoke.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.ops import bsr_super, cuda_build, row_gather
from krylov_robustness_torch.ops.bsr_super import (
    SuperBsrOperator,
    bf16_split,
    pack_bsr_super,
    super_tile_count,
)
from krylov_robustness_torch.utils import tracing
from krylov_robustness_tpu.ops import pallas_bsr_super as jbsr
from test_pallas_spmm import banded_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(n=1200, max_off=90, extra=200),
    dict(n=333, max_off=60, extra=100, weighted=False),
])
def test_pack_equals_jax(kw):
    A = sp.csr_matrix(banded_graph(**kw))
    at_j, meta_j, et_j, eo_j, np_j = jbsr.pack_bsr_super(A)
    at_t, meta_t, et_t, eo_t, np_t = pack_bsr_super(A, device="cpu")
    np.testing.assert_array_equal(at_t.numpy(), at_j)
    for a, b in zip(meta_t, meta_j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(et_t, et_j)
    np.testing.assert_array_equal(eo_t, eo_j)
    assert np_t == np_j
    perm = np.random.default_rng(0).permutation(A.shape[0])
    assert super_tile_count(A, perm) == jbsr.super_tile_count(A, perm)


@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float64, torch.float64, 1e-12),
                                         (jnp.float32, torch.float32, 1e-6)])
def test_full_mode_matches_jax_and_scipy(jdt, tdt, tol):
    """Mode f32 (K2's plain twin) in f64 and f32 storage; relative to
    max|y| — f64 to round-off, f32 to its own round-off."""
    A = banded_graph()
    x = np.random.default_rng(1).standard_normal((A.shape[0], 5))
    yj = np.asarray(jbsr.SuperBsrOperator(A, dtype=jdt, interpret=True,
                                          mode="f32") @ jnp.asarray(x, jdt))
    op = SuperBsrOperator(A, dtype=tdt, device="cpu", mode="f32")
    yt = (op @ torch.as_tensor(x).to(tdt)).double().numpy()
    ref = A @ x.astype(np.float32 if tdt == torch.float32 else np.float64)
    scale = np.abs(ref).max()
    assert np.abs(yt - yj).max() <= tol * scale
    assert np.abs(yt - ref).max() <= tol * scale


@pytest.mark.parametrize("mode,gate", [("bf16x2", 3e-5), ("bf16x3", 3e-7)])
def test_bf16_modes_match_jax_and_scipy(mode, gate):
    """K1's plain twin: the same bf16 split as JAX, the tile products summed
    in another order (≤ 1e-6·max|y|); against scipy within the split's
    accuracy."""
    A = banded_graph(n=700, max_off=50, extra=120, weighted=False)
    x = np.random.default_rng(2).standard_normal((700, 9)).astype(np.float32)
    yj = np.asarray(jbsr.SuperBsrOperator(A, dtype=jnp.float32,
                                          interpret=True, mode=mode)
                    @ jnp.asarray(x))
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode=mode)
    yt = (op @ torch.as_tensor(x)).numpy()
    ref = A @ x.astype(np.float64)
    scale = np.abs(ref).max()
    assert np.abs(yt - yj).max() <= 1e-6 * scale
    assert np.abs(yt - ref).max() <= gate * scale


def test_bf16_split_equals_jax():
    x = np.random.default_rng(3).standard_normal((64, 7)).astype(np.float32)
    for terms in (1, 2, 3):
        got = bf16_split(torch.as_tensor(x), terms).float().numpy()
        want = np.asarray(jbsr.bf16_split(jnp.asarray(x), terms)).astype(
            np.float32)
        np.testing.assert_array_equal(got, want)


def test_auto_mode_choice():
    A = banded_graph(n=700, max_off=50, extra=120, weighted=False)
    assert SuperBsrOperator(A, dtype=torch.float32,
                            device="cpu").mode == "bf16x2"
    assert SuperBsrOperator(A, dtype=torch.float64, device="cpu").mode == "f32"
    Aw = A.copy().astype(np.float64)
    Aw.data *= 1 + 1e-4 * np.arange(len(Aw.data))  # not bf16-exact
    assert SuperBsrOperator(Aw, dtype=torch.float32, device="cpu").mode == "f32"
    assert (SuperBsrOperator(A, dtype=torch.float32, device="cpu")
            .vals.dtype == torch.bfloat16)


def test_set_edge_symmetric_and_entry_values():
    A = banded_graph(n=600, max_off=40, extra=50, weighted=False)
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode="bf16x3")
    C = sp.coo_matrix(sp.tril(A, -1))
    i, j = int(C.row[0]), int(C.col[0])
    op.set_edge(i, j, 0.0)
    A2 = A.copy().tolil()
    A2[i, j] = A2[j, i] = 0.0
    x = np.random.default_rng(4).standard_normal((600, 2)).astype(np.float32)
    ref = sp.csr_matrix(A2) @ x
    got = (op @ torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 3e-7
    vals = op.entry_values()
    assert vals[op.entry_index(i, j)] == 0.0 and vals[op.entry_index(j, i)] == 0
    assert np.count_nonzero(vals) == A.nnz - 2
    with pytest.raises(KeyError):
        op.entry_index(0, 599)


def test_nonmultiple_n_and_vector():
    A = banded_graph(n=333, max_off=60, extra=100)  # n_pad rounds to 512
    op = SuperBsrOperator(A, dtype=torch.float64, device="cpu", mode="f32")
    x = np.random.default_rng(3).standard_normal(333)
    got = (op @ torch.as_tensor(x)).numpy()
    assert got.shape == (333,)
    np.testing.assert_allclose(got, A @ x, rtol=1e-12, atol=1e-12)


def test_wide_batch_chunking(monkeypatch):
    """The plain path runs batches wider than MAX_B as column chunks; the
    values equal the unchunked product."""
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode="bf16x3")
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (300, 700)).astype(np.float32))
    whole = op @ x
    monkeypatch.setattr(SuperBsrOperator, "MAX_B", 256)  # 3 chunks
    chunked = op @ x
    assert chunked.shape == (300, 700)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    ref = A @ x.double().numpy()
    assert np.abs(chunked.numpy() - ref).max() / np.abs(ref).max() < 3e-7


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA kernels take CUDA tensors only: a CPU call raises, it never
    falls back."""
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode="bf16x2")
    x = torch.zeros((300, 4))
    with pytest.raises(ValueError, match="CUDA"):
        bsr_super.tile_spmm_bf16(op._row_ptr, op._cols, op._val_off,
                                 op.vals, x, 2)
    for dtype in (torch.float32, torch.float64):
        full = SuperBsrOperator(A, dtype=dtype, device="cpu", mode="f32")
        with pytest.raises(ValueError, match="CUDA"):
            bsr_super.tile_spmm_full(full._row_ptr, full._cols,
                                     full._val_off, full.vals,
                                     x.to(dtype))


def test_non_cpu_tensor_never_takes_the_plain_path(monkeypatch):
    """Dispatch: only a CPU tensor reaches the plain version; any other
    device goes to the kernel wrapper or raises."""
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode="bf16x2")
    called = []
    monkeypatch.setattr(op, "_plain", lambda x: called.append(x) or x)
    with pytest.raises(ValueError):
        op.matmul(torch.zeros((300, 4), device="meta"))
    assert not called


@pytest.mark.parametrize("mode,dtype", [
    ("bf16x2", torch.float32),   # K1 over bf16 values
    ("f32", torch.float32),      # K2 over f32 values
    ("f32", torch.float64),      # K2 over f64 values
])
@pytest.mark.parametrize("graph", ["banded", "random", "make_slots"])
def test_row_index_reads_the_packed_matrix(graph, mode, dtype):
    """K1's and K2's row index over the CSR-order values is the matrix in
    CSR form, explicit zeros included, and stays so after ``set_edge`` and
    over ``with_values``' replacement values; each offset is its entry's
    own position, and the operator holds no tile."""
    A = sp.csr_matrix(_index_graph(graph))
    A.sort_indices()
    op = SuperBsrOperator(A, dtype=dtype, device="cpu", mode=mode)
    assert op.vals.dtype == (torch.bfloat16 if mode == "bf16x2" else dtype)
    row_ptr, cols, val_off = (t.numpy() for t in (op._row_ptr, op._cols,
                                                  op._val_off))
    assert all(t.dtype == torch.int32 for t in (op._row_ptr, op._cols,
                                                op._val_off))
    np.testing.assert_array_equal(val_off, np.arange(A.nnz))
    assert op.vals.shape == (A.nnz,)
    assert tracing.tensor_bytes(op) == A.nnz * (
        op.vals.element_size() + 8) + (A.shape[0] + 1) * 4

    def indexed(vals):
        flat = vals.reshape(-1).double().numpy()
        return sp.csr_matrix((flat[val_off], cols, row_ptr), shape=A.shape)

    _assert_same_csr(indexed(op.vals), A)
    C = sp.coo_matrix(sp.tril(A, -1))
    i, j = int(C.row[3]), int(C.col[3])
    op.set_edge(i, j, 0.0)
    A2 = A.copy()
    A2[i, j] = A2[j, i] = 0.0  # explicit zeros: the structure is frozen
    _assert_same_csr(indexed(op.vals), A2)
    other = op.with_values(2 * op.vals)
    assert other._val_off is op._val_off and other._row_ptr is op._row_ptr
    _assert_same_csr(indexed(other.vals), 2 * A2)
    with pytest.raises(ValueError, match="match"):
        op.with_values(op.vals[:-1])


def _hub_with_slots(seed: int = 5):
    """A small graph with hubs (expected degrees ~ (i + 5)^-0.9, up to ~60)
    and 30 explicit-zero candidate slots in both triangles, as make mode
    packs them."""
    rng = np.random.default_rng(seed)
    n = 900
    w = (np.arange(n) + 5.0) ** -0.9
    p = w / w.sum()
    src, dst = rng.choice(n, 4000, p=p), rng.choice(n, 4000, p=p)
    A = sp.coo_matrix((np.ones(4000), (src, dst)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float64).tolil()
    A.setdiag(0)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    r, c = rng.integers(0, n, 60), rng.integers(0, n, 60)
    keep = (r != c) & (np.asarray(A[r, c]).ravel() == 0)
    r, c = r[keep][:30], c[keep][:30]
    C = sp.coo_matrix(A)
    return sp.coo_matrix(
        (np.concatenate([C.data, np.zeros(2 * len(r))]),
         (np.concatenate([C.row, r, c]), np.concatenate([C.col, c, r]))),
        shape=A.shape).tocsr(), np.stack([r, c], axis=1)


@pytest.mark.parametrize("mode,dtype", [("f32", torch.float64),
                                        ("bf16x2", torch.float32)])
def test_csr_values_equal_scipy_through_edits(mode, dtype):
    """The CSR-order operator on a hub graph with make's zero slots equals
    scipy's A @ x: in f64 to round-off, and in bf16x2 to the product of A
    with x's two bf16 parts, to f32 round-off. ``set_edge`` (a slot's
    commit, a removal), ``update_entry_values`` and ``entry_values`` edit
    and read the same entries scipy's matrix holds."""
    A, slots = _hub_with_slots()
    op = SuperBsrOperator(A, dtype=dtype, device="cpu", mode=mode)
    n = A.shape[0]
    x = np.random.default_rng(6).standard_normal((n, 40))

    def held(M):
        xt = torch.as_tensor(x).to(dtype)
        got = (op @ xt).double().numpy()
        exact = M @ x
        if mode == "f32":
            assert np.abs(got - exact).max() <= 1e-13 * np.abs(exact).max()
            return
        parts = bf16_split(xt, 2).double().numpy()
        split = M @ (parts[:, :40] + parts[:, 40:])
        assert np.abs(got - split).max() <= 1e-6 * np.abs(split).max()
        assert np.abs(got - exact).max() <= 2e-5 * np.abs(exact).max()

    held(A)
    M = A.tolil()
    i, j = (int(v) for v in slots[0])
    L = sp.coo_matrix(sp.tril(A, -1))
    a, b = int(L.row[0]), int(L.col[0])
    op.set_edge(i, j, 1.0)  # a candidate slot committed
    M[i, j] = M[j, i] = 1.0
    op.set_edge(a, b, 0.0)  # an edge removed
    M[a, b] = M[b, a] = 0.0
    held(sp.csr_matrix(M))
    k = op.entry_index(np.array([a, int(slots[1][0])]),
                       np.array([b, int(slots[1][1])]))
    op.update_entry_values(k, [2.0, 0.5])
    vals = op.entry_values()
    assert vals[k[0]] == 2.0 and vals[k[1]] == 0.5
    M[a, b], M[int(slots[1][0]), int(slots[1][1])] = 2.0, 0.5
    M = sp.csr_matrix(M)
    held(M)
    want = sp.csr_matrix(A, copy=True)
    want.sort_indices()
    assert len(vals) == want.nnz  # the structure is frozen: slots stay
    C = sp.coo_matrix(want)
    np.testing.assert_array_equal(vals, np.asarray(M[C.row, C.col]).ravel())


def _index_graph(kind):
    """A banded graph, a random graph, or a banded graph with make mode's
    explicit-zero candidate slots (both triangles)."""
    if kind == "random":
        return random_graph(300, 0.03, seed=7)
    A = banded_graph(n=700, max_off=50, extra=120, weighted=False)
    if kind == "banded":
        return A
    C = sp.coo_matrix(A)
    rng = np.random.default_rng(8)
    r, c = rng.integers(0, 700, 40), rng.integers(0, 700, 40)
    keep = (r != c) & (np.asarray(A[r, c]).ravel() == 0)
    r, c = r[keep], c[keep]
    return sp.coo_matrix(
        (np.concatenate([C.data, np.zeros(2 * len(r))]),
         (np.concatenate([C.row, r, c]), np.concatenate([C.col, c, r]))),
        shape=A.shape).tocsr()


def _assert_same_csr(got, want):
    """Equal structure (explicit zeros count) and equal values."""
    want = sp.csr_matrix(want)
    want.sort_indices()
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)


def test_build_key_covers_the_shared_headers(monkeypatch, tmp_path):
    """A library is named by its source and every ``csrc/*.cuh`` beside it:
    a changed header gives another name, so no stale library is reused."""
    for path in cuda_build.SOURCES["bsr_super"].parent.glob("*.cu*"):
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setitem(cuda_build.SOURCES, "bsr_super",
                        tmp_path / "bsr_super.cu")
    header = tmp_path / "row_gather.cuh"
    before = cuda_build._target("bsr_super")
    assert cuda_build._target("bsr_super") == before
    header.write_text(header.read_text() + "\n// changed\n")
    changed = cuda_build._target("bsr_super")
    assert changed != before
    (tmp_path / "extra.cuh").write_text("#pragma once\n")
    assert cuda_build._target("bsr_super") != changed


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel build with no CUDA compiler raises instead of continuing."""
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_kernels(("bsr_super",))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        SuperBsrOperator(A, dtype=torch.float32, device="cuda")


def test_interop_super_bsr_from_jax_packing():
    """A port operator over the JAX operator's own packing computes the same
    product as the port's own packing."""
    from krylov_robustness_torch.interop import super_bsr_from_arrays

    A = banded_graph(n=700, max_off=50, extra=120, weighted=False)
    jop = jbsr.SuperBsrOperator(A, dtype=jnp.float32, interpret=True)
    op = super_bsr_from_arrays(
        np.asarray(jop.atiles.astype(jnp.float32)), jop._entry_tile,
        jop._entry_offset, jop._entry_rc, jop.n, jop.mode, torch.float32,
        "cpu")
    assert op.mode == "bf16x2"
    x = np.random.default_rng(5).standard_normal((700, 6)).astype(np.float32)
    got = (op @ torch.as_tensor(x)).numpy()
    want = (SuperBsrOperator(A, dtype=torch.float32, device="cpu")
            @ torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    yj = np.asarray(jop @ jnp.asarray(x))
    assert np.abs(got - yj).max() <= 1e-6 * np.abs(yj).max()


# -- split plans (ops/row_gather.py::split_plan) ---------------------------
L = row_gather.SPLIT_ENTRIES
R = row_gather.ROWS_PER_WARP


def _chung_lu_hubs(n: int = 3000, draws: int = 30000, seed: int = 11):
    """A Chung–Lu graph with hubs (expected degrees ~ (i + 3)^-0.9, the
    largest 938) in its own labels: rows past several L."""
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 3.0) ** -0.9
    src, dst = rng.choice(n, draws, p=w / w.sum()), rng.choice(
        n, draws, p=w / w.sum())
    A = sp.coo_matrix((np.ones(draws), (src, dst)), shape=(n, n))
    A = sp.csr_matrix(((A + A.T) > 0).astype(np.float64))
    A.setdiag(0)
    A.eliminate_zeros()
    return A


def _star_row(length: int = 3000):
    """Node 0 joined to ``length`` others: row 0 holds ``length`` entries."""
    n = length + 1
    A = sp.coo_matrix((np.ones(length), (np.zeros(length, int),
                                         np.arange(1, n))), shape=(n, n))
    return sp.csr_matrix(A + A.T)


def _path_with_chords(n: int = 2000, seed: int = 3):
    """A road network's shape: a path and short chords."""
    rng = np.random.default_rng(seed)
    i = np.arange(n - 1)
    src = np.concatenate([i, rng.integers(0, n - 300, n // 10)])
    dst = np.concatenate([i + 1, src[n - 1:] + rng.integers(2, 299, n // 10)])
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    return sp.csr_matrix(((A + A.T) > 0).astype(np.float64))


def _plan_graph(kind):
    """(row_ptr, the rows of make mode's explicit-zero slots or None)."""
    if kind == "hubs":
        return _chung_lu_hubs().indptr, None
    if kind == "star":
        return _star_row().indptr, None
    # make: explicit-zero slots in both triangles, 10 of them in the
    # largest hub's row
    A = _chung_lu_hubs()
    rng = np.random.default_rng(12)
    hub = int(np.argmax(np.diff(A.indptr)))
    r = np.concatenate([np.full(40, hub), rng.integers(0, A.shape[0], 40)])
    c = rng.integers(0, A.shape[0], 80)
    keep = (r != c) & (np.asarray(A[r, c]).ravel() == 0)
    r, c = r[keep], c[keep]
    C = sp.coo_matrix(A)
    M = sp.coo_matrix(
        (np.concatenate([C.data, np.zeros(2 * len(r))]),
         (np.concatenate([C.row, r, c]), np.concatenate([C.col, c, r]))),
        shape=A.shape).tocsr()
    op = SuperBsrOperator(M, dtype=torch.float32, device="cpu")
    assert op.nnz == A.nnz + 2 * len(r) and (r == hub).sum() >= 10
    return op._row_ptr.numpy(), op.entry_index(np.concatenate([r, c]),
                                               np.concatenate([c, r]))


def _hits(rp, plan):
    """How often each entry is summed: by the row groups (a run of at most
    L entries) or by a unit."""
    rp = np.asarray(rp, np.int64)
    n = len(rp) - 1
    hits = np.zeros(rp[-1], int)
    for r0 in range(0, n, R):
        e0, e1 = rp[r0], rp[min(r0 + R, n)]
        if e1 - e0 <= L:
            hits[e0:e1] += 1
    for row, begin, end in plan.units.numpy():
        assert rp[row] <= begin <= end <= rp[row + 1]
        hits[begin:end] += 1
    return hits


@pytest.mark.parametrize("kind", ["hubs", "star", "make"])
def test_split_plan_covers_every_entry_once(kind):
    """Every entry lies in one unit or in one run of the row groups; no
    unit holds more than L entries; a cut row's pieces are contiguous, in
    CSR order, of balanced length, and come first, row by row; every other
    row of a split run is one unit whole. In make mode the explicit-zero
    slots are covered as the graph's entries are."""
    rp, slots = _plan_graph(kind)
    plan = row_gather.split_plan(torch.as_tensor(rp), "cpu")
    units = plan.units.numpy()
    assert plan.units.dtype == plan.cut_end.dtype == torch.int32
    hits = _hits(rp, plan)
    np.testing.assert_array_equal(hits, 1)
    sizes = units[:, 2] - units[:, 1]
    assert sizes.max() <= L and plan.pieces == int(plan.cut_end[-1])
    assert plan.entries == sizes.sum() and plan.limit == L
    end = plan.cut_end.numpy()
    first = np.concatenate([[0], end[:-1]])
    lens = np.diff(rp)
    for f, e in zip(first, end):
        row = units[f, 0]
        assert (units[f:e, 0] == row).all() and lens[row] > L
        assert e - f == -(-lens[row] // L)
        assert units[f, 1] == rp[row] and units[e - 1, 2] == rp[row + 1]
        np.testing.assert_array_equal(units[f + 1:e, 1], units[f:e - 1, 2])
        assert np.ptp(sizes[f:e]) <= 1
    assert (np.diff(units[first, 0]) > 0).all()
    whole = units[plan.pieces:]
    assert (np.diff(whole[:, 0]) > 0).all() and (lens[whole[:, 0]] <= L).all()
    np.testing.assert_array_equal(whole[:, 1], rp[whole[:, 0]])
    np.testing.assert_array_equal(whole[:, 2], rp[whole[:, 0] + 1])
    if slots is not None:
        in_units = np.zeros(len(hits), bool)
        for _, begin, stop in units:
            in_units[begin:stop] = True
        assert in_units[slots].any()


@pytest.mark.parametrize("limit", [L // 2, L])
def test_split_plan_cuts_a_long_row(limit):
    """A row of 3,000 entries is cut into ⌈3000 / limit⌉ pieces; the other
    three rows of its run are one unit each."""
    plan = row_gather.split_plan(_star_row().indptr, "cpu", limit)
    assert plan.pieces == -(-3000 // limit) and len(plan.cut_end) == 1
    np.testing.assert_array_equal(plan.units[plan.pieces:, 0], [1, 2, 3])
    assert plan.entries == 3003 and (plan.limit, plan.run) == (limit, R)


@pytest.mark.parametrize("lengths,units", [
    ([L // 4] * 4 + [3] * 9, 0),  # the heaviest run holds exactly L
    ([L, 0, 0, 0, 7], 0),
    ([0, L + 1, 0, 0, 7], 5),     # one entry more: 2 pieces, 3 whole rows
    ([0, 0, 0, 0, 0], 0),
])
def test_split_plan_splits_runs_past_the_limit(lengths, units):
    rp = np.concatenate([[0], np.cumsum(lengths)])
    plan = row_gather.split_plan(rp, "cpu")
    assert plan.units.shape == (units, 3)
    assert plan.pieces == (2 if units else 0)


def test_split_plan_is_empty_on_a_road_network():
    """A path with chords (and a banded matrix) holds no run past L: the
    operator's plan is empty, holds no bytes, and its counters read 0."""
    for A in (_path_with_chords(), banded_graph(n=700, max_off=50, extra=120,
                                                weighted=False)):
        op = SuperBsrOperator(A, dtype=torch.float32, device="cpu")
        assert op.split_units == op.split_entries == op._split.pieces == 0
        assert op._split.units.numel() == op._split.cut_end.numel() == 0


def test_operator_holds_its_split_plan():
    """The hub operator's plan is built from its row index, shared by
    ``with_values``, and counted in its bytes."""
    A = _chung_lu_hubs()
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu")
    want = row_gather.split_plan(A.indptr, "cpu")
    np.testing.assert_array_equal(op._split.units, want.units)
    np.testing.assert_array_equal(op._split.cut_end, want.cut_end)
    assert op.split_units == len(want.units) > 0
    assert op.split_entries == want.entries > 0
    assert tracing.tensor_bytes(op) == A.nnz * (2 + 8) + (
        A.shape[0] + 1) * 4 + 4 * (want.units.numel() + want.cut_end.numel())
    assert op.with_values(op.vals * 2)._split is op._split


@pytest.mark.parametrize("mode,dtype,gate", [
    ("bf16x2", torch.float32, 2.0 ** -18),
    ("bf16x3", torch.float32, 2.0 ** -18),
    # two orders of f64 sums over rows of up to 938 entries part by a few
    # units of the last place of max|y| (1.5e-15 here)
    ("f32", torch.float64, 2.0 ** -48),
    ("f32", torch.float32, 2.0 ** -23),
])
def test_split_twin_matches_the_plain_version(mode, dtype, gate):
    """The plain twin of K1 and K2 in the split kernels' order (a cut row
    as the sum of its pieces' sums) agrees with the CSR-order plain version
    relative to max|y|, on the rows the plan cuts; every other row is the
    plain version's, bit for bit, and b < 32 takes no plan."""
    A = _chung_lu_hubs()
    op = SuperBsrOperator(A, dtype=dtype, device="cpu", mode=mode)
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (A.shape[0], 40))).to(dtype)
    index = (op._row_ptr, op._cols, op._val_off, op.vals)
    terms = op._terms()
    plain = op.matmul_plain(x)
    for b in (40, 16):
        got = bsr_super.split_spmm_plain(*index, x[:, :b], op._split, terms)
        want = plain[:, :b]
        cut = np.zeros(A.shape[0], bool)
        if b >= 32:
            cut[op._split.units[:op._split.pieces, 0].numpy()] = True
        assert cut.sum() == (len(op._split.cut_end) if b >= 32 else 0)
        np.testing.assert_array_equal(got[~cut], want[~cut])
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= gate, err
