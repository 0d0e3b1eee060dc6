"""Flat BSR operator of the PyTorch port (ops/bsr.py) against the JAX
package's BsrOperator in interpret mode, and against scipy.

On the CPU the port runs K4's plain version (batched block products and
``index_add_``); the CUDA kernel runs on the card (chip_smoke.py), where it
sums in another order and is held to error gates, not to bit equality."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch.ops import bsr, cuda_build
from krylov_robustness_torch.ops.bsr import (
    BsrOperator,
    bsr_block_count,
    make_bsr_operator,
    pack_bsr,
)
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_tpu.ops import pallas_bsr as jbsr
from test_pallas_spmm import banded_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(n=260, max_off=30, extra=40),  # a padding row block (n_pad = 384)
    dict(n=333, max_off=60, extra=100, weighted=False),
])
def test_pack_equals_jax(kw):
    A = sp.csr_matrix(banded_graph(**kw))
    want = jbsr.pack_bsr(A)
    ab, cb, rb, first, eb, eo = pack_bsr(A, device="cpu")
    np.testing.assert_array_equal(ab.numpy(), want[0])
    for got, ref in zip((cb, rb, first, eb, eo), want[1:]):
        np.testing.assert_array_equal(got, ref)
        assert got.dtype == ref.dtype
    nrb = -(-A.shape[0] // 128)
    assert set(rb.tolist()) == set(range(nrb))  # every row block has a block
    assert int(first.sum()) == nrb


@pytest.mark.parametrize("graph", ["banded", "random"])
@pytest.mark.parametrize("jdt,tdt,tol", [(jnp.float64, torch.float64, 1e-12),
                                         (jnp.float32, torch.float32, 1e-5)])
def test_matmul_matches_jax_and_scipy(graph, jdt, tdt, tol):
    """Matrix and vector x; relative to max|y|. f32 products are rounded in
    another order than JAX's and scipy's f64 product on f32-rounded x."""
    A = banded_graph() if graph == "banded" else random_graph(400, 0.05,
                                                              seed=4)
    n = A.shape[0]
    rng = np.random.default_rng(1)
    jop = jbsr.BsrOperator(A, dtype=jdt, interpret=True)
    op = BsrOperator(A, dtype=tdt, device="cpu")
    for x in (rng.standard_normal((n, 5)), rng.standard_normal(n)):
        x = x.astype(np.float32 if tdt == torch.float32 else np.float64)
        yt = (op @ torch.as_tensor(x)).double().numpy()
        yj = np.asarray(jop @ jnp.asarray(x, jdt))
        ref = A @ x.astype(np.float64)
        scale = np.abs(ref).max()
        assert yt.shape == ref.shape
        assert np.abs(yt - yj).max() <= tol * scale
        assert np.abs(yt - ref).max() <= tol * scale


def test_nonmultiple_n_vector_f64():
    A = banded_graph(n=333, max_off=60, extra=100)  # n % 128 != 0
    op = BsrOperator(A, dtype=torch.float64, device="cpu")
    x = np.random.default_rng(2).standard_normal(333)
    got = (op @ torch.as_tensor(x)).numpy()
    assert got.shape == (333,)
    np.testing.assert_allclose(got, A @ x, rtol=1e-12, atol=1e-12)


def test_plain_chunks_over_blocks(monkeypatch):
    """The plain version's block chunking changes no value."""
    A = banded_graph(n=1200, max_off=90, extra=200)
    op = BsrOperator(A, dtype=torch.float64, device="cpu")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal((1200, 4)))
    whole = op @ x
    monkeypatch.setattr(bsr, "PLAIN_CHUNK", 3)
    assert op.nblocks > 3
    torch.testing.assert_close(op @ x, whole, rtol=0, atol=1e-12)


def test_update_entry_values_equal_jax():
    A = banded_graph(n=256, max_off=40, extra=50)
    jop = jbsr.BsrOperator(A, dtype=jnp.float64, interpret=True)
    op = BsrOperator(A, dtype=torch.float64, device="cpu")
    idx, vals = np.array([0, 5, 17]), np.array([0.0, 7.5, -2.25])
    jop.update_entry_values(idx, vals)
    op.update_entry_values(idx, vals)
    np.testing.assert_array_equal(op.entry_values(), jop.entry_values())
    np.testing.assert_array_equal(op.ablocks.numpy(), np.asarray(jop.ablocks))
    x = np.random.default_rng(3).standard_normal((256, 3))
    np.testing.assert_allclose((op @ torch.as_tensor(x)).numpy(),
                               np.asarray(jop @ jnp.asarray(x)), rtol=1e-12,
                               atol=1e-12)


def test_set_edge_equal_jax_and_scipy():
    A = banded_graph(n=256, max_off=40, extra=50, weighted=False)
    jop = jbsr.BsrOperator(A, dtype=jnp.float32, interpret=True)
    op = BsrOperator(A, dtype=torch.float32, device="cpu")
    C = sp.coo_matrix(sp.tril(A, -1))
    i, j = int(C.row[0]), int(C.col[0])
    assert op.entry_index(i, j) == jop.entry_index(i, j)
    jop.set_edge(i, j, 0.0)
    op.set_edge(i, j, 0.0)
    vals = op.entry_values()
    assert vals.dtype == np.float32
    np.testing.assert_array_equal(vals, jop.entry_values())
    assert vals[op.entry_index(j, i)] == 0.0
    assert np.count_nonzero(vals) == A.nnz - 2
    A2 = A.copy().tolil()
    A2[i, j] = A2[j, i] = 0.0
    x = np.random.default_rng(4).standard_normal((256, 2)).astype(np.float32)
    ref = sp.csr_matrix(A2) @ x.astype(np.float64)
    got = (op @ torch.as_tensor(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    with pytest.raises(KeyError):
        op.entry_index(0, 255)


def test_block_count_equals_jax():
    A = random_graph(400, 0.05, seed=4)
    perm = np.random.default_rng(0).permutation(400)
    assert bsr_block_count(A) == jbsr.bsr_block_count(A)
    assert bsr_block_count(A, perm) == jbsr.bsr_block_count(A, perm)


def test_make_bsr_operator_dispatch_equals_jax():
    """A 1-byte budget falls back to COO with the identity permutation; the
    default budget packs under the same RCM permutation as JAX."""
    A = random_graph(400, 0.05, seed=4)
    op, perm = make_bsr_operator(A, device="cpu", max_storage_bytes=1)
    assert isinstance(op, CooMatrix)
    np.testing.assert_array_equal(perm, np.arange(400))
    op2, perm2 = make_bsr_operator(A, dtype=torch.float64, device="cpu")
    jop2, jperm2 = jbsr.make_bsr_operator(A, dtype=jnp.float64,
                                          interpret=True)
    assert isinstance(op2, BsrOperator)
    np.testing.assert_array_equal(perm2, jperm2)
    assert op2.nblocks == jop2.nblocks
    assert op2.storage_bytes() == jop2.storage_bytes()
    x = np.random.default_rng(5).standard_normal((400, 3))
    Ap = sp.csr_matrix(A)[perm2, :].tocsc()[:, perm2].tocsr()
    got = (op2 @ torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, Ap @ x, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jop2 @ jnp.asarray(x)),
                               rtol=1e-12, atol=1e-12)


def test_interop_bsr_from_jax_packing():
    """A port operator over the JAX operator's own packing computes the same
    product as the port's own packing."""
    from krylov_robustness_torch.interop import bsr_from_arrays

    A = banded_graph(n=700, max_off=50, extra=120)
    jop = jbsr.BsrOperator(A, dtype=jnp.float64, interpret=True)
    op = bsr_from_arrays(np.asarray(jop.ablocks), np.asarray(jop.cb),
                         np.asarray(jop.rb), np.asarray(jop.first),
                         jop._entry_block, jop._entry_offset, jop._entry_rc,
                         jop.n, torch.float64, "cpu")
    x = np.random.default_rng(6).standard_normal((700, 4))
    got = (op @ torch.as_tensor(x)).numpy()
    want = (BsrOperator(A, dtype=torch.float64, device="cpu")
            @ torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.asarray(jop @ jnp.asarray(x)),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="first"):
        bsr_from_arrays(np.asarray(jop.ablocks), np.asarray(jop.cb),
                        np.asarray(jop.rb), np.zeros_like(jop.first),
                        jop._entry_block, jop._entry_offset, jop._entry_rc,
                        jop.n, torch.float64, "cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("graph", ["banded", "random", "make_slots"])
def test_row_index_reads_the_packed_matrix(graph, dtype):
    """K4's row index over the flattened blocks is the packed matrix in CSR
    form, explicit zeros included, and stays so after ``set_edge``; every
    offset lies inside the blocks."""
    if graph == "random":
        A = random_graph(400, 0.05, seed=4)
    else:
        A = banded_graph(n=260, max_off=30, extra=40)  # a padding row block
    if graph == "make_slots":  # explicit-zero candidate slots
        C = sp.coo_matrix(A)
        r, c = np.array([0, 5, 17]), np.array([200, 150, 90])
        assert not np.asarray(A[r, c]).any()
        A = sp.coo_matrix(
            (np.concatenate([C.data, np.zeros(6)]),
             (np.concatenate([C.row, r, c]), np.concatenate([C.col, c, r]))),
            shape=A.shape)
    A = sp.csr_matrix(A).astype(np.float64)
    A.sort_indices()
    op = BsrOperator(A, dtype=dtype, device="cpu")
    row_ptr, cols, val_off = (t.numpy() for t in (op.row_ptr, op.cols,
                                                  op.val_off))
    assert all(t.dtype == torch.int32 for t in (op.row_ptr, op.cols,
                                                op.val_off))
    assert val_off.min() >= 0 and val_off.max() < op.ablocks.numel()

    def assert_reads(want):
        flat = op.ablocks.reshape(-1).double().numpy()
        got = sp.csr_matrix((flat[val_off], cols, row_ptr), shape=A.shape)
        np.testing.assert_array_equal(got.indptr, want.indptr)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.data, want.data.astype(
            np.float32 if dtype == torch.float32 else np.float64))

    assert_reads(A)
    C = sp.coo_matrix(sp.tril(A, -1))
    i, j = int(C.row[2]), int(C.col[2])
    op.set_edge(i, j, 0.0)
    A2 = A.copy()
    A2[i, j] = A2[j, i] = 0.0  # explicit zeros: the structure is frozen
    assert_reads(A2)


def test_kernel_wrapper_refuses_cpu_tensors():
    """K4 takes CUDA tensors only: a CPU call raises, it never falls back."""
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    op = BsrOperator(A, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        bsr.bsr_spmm(op.row_ptr, op.cols, op.val_off, op.ablocks,
                     torch.zeros((300, 4)))


def test_non_cpu_tensor_never_takes_the_plain_path(monkeypatch):
    """Dispatch: only a CPU tensor reaches the plain version; any other
    device goes to the kernel wrapper or raises."""
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    op = BsrOperator(A, dtype=torch.float32, device="cpu")
    called = []
    monkeypatch.setattr(bsr, "bsr_spmm_plain",
                        lambda *a: called.append(a) or a[-1])
    with pytest.raises(ValueError):
        op.matmul(torch.zeros((300, 4), device="meta"))
    assert not called


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A K4 build with no CUDA compiler raises instead of continuing."""
    assert "bsr_flat" in cuda_build.SOURCES
    monkeypatch.setattr(cuda_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_kernels(("bsr_flat",))


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BsrOperator(A, dtype=torch.float32, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_bsr_operator(A, device="cuda")
