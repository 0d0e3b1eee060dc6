"""Super-tile operator of the PyTorch port (ops/bsr_super.py) against the JAX
package's SuperBsrOperator in interpret mode, and against scipy.

On the CPU the port runs the kernels' plain versions; the CUDA kernels run
on the card (chip_smoke.py)."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from krylov_robustness_torch.ops import bsr_super
from krylov_robustness_torch.ops.bsr_super import (
    SuperBsrOperator,
    bf16_split,
    pack_bsr_super,
    super_tile_count,
)
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
            .atiles.dtype == torch.bfloat16)


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


def test_structural_bitmap_covers_every_entry():
    """The kernels skip sub-blocks the bitmap marks empty: every stored
    entry (explicit zeros included) must lie in a marked sub-block."""
    A = sp.csr_matrix(banded_graph(n=1200, max_off=90, extra=200))
    op = SuperBsrOperator(A, dtype=torch.float64, device="cpu", mode="f32")
    mask = op._blkmask.numpy()
    tile_c = op.atiles.shape[2]
    rows, cols = op._entry_offset // tile_c, op._entry_offset % tile_c
    kb = tile_c // bsr_super.MASK_BK
    assert mask[op._entry_tile, (rows // bsr_super.MASK_BM) * kb
                + cols // bsr_super.MASK_BK].all()
    flat = op.atiles.reshape(op.ntiles, -1).numpy()
    blocks = flat.reshape(op.ntiles, op.atiles.shape[1] // bsr_super.MASK_BM,
                          bsr_super.MASK_BM, kb, bsr_super.MASK_BK)
    nonzero = np.abs(blocks).sum(axis=(2, 4)) > 0
    assert np.all(mask.reshape(nonzero.shape)[nonzero])


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA kernels take CUDA tensors only: a CPU call raises, it never
    falls back."""
    A = banded_graph(n=300, max_off=30, extra=60, weighted=False)
    op = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode="bf16x2")
    x = torch.zeros((300, 4))
    with pytest.raises(ValueError, match="CUDA"):
        bsr_super.tile_spmm_bf16(op.atiles, op._slab, op._sup_ptr,
                                 op._blkmask, x, 2)
    op32 = SuperBsrOperator(A, dtype=torch.float32, device="cpu", mode="f32")
    with pytest.raises(ValueError, match="CUDA"):
        bsr_super.tile_spmm_full(op32.atiles, op32._slab, op32._sup_ptr,
                                 op32._blkmask, x)


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


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """A kernel build with no CUDA compiler raises instead of continuing."""
    monkeypatch.setattr(bsr_super, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(bsr_super.shutil, "which", lambda name: None)
    monkeypatch.setattr(bsr_super.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        bsr_super.build_kernels()


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
    slab, sup, start = (np.asarray(m) for m in jop.meta)
    op = super_bsr_from_arrays(
        np.asarray(jop.atiles.astype(jnp.float32)), slab, sup, start,
        jop._entry_tile, jop._entry_offset, jop._entry_rc, jop.n, jop.n_pad,
        jop.mode, torch.float32, "cpu")
    assert op.mode == "bf16x2"
    x = np.random.default_rng(5).standard_normal((700, 6)).astype(np.float32)
    got = (op @ torch.as_tensor(x)).numpy()
    want = (SuperBsrOperator(A, dtype=torch.float32, device="cpu")
            @ torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)
    yj = np.asarray(jop @ jnp.asarray(x))
    assert np.abs(got - yj).max() <= 1e-6 * np.abs(yj).max()
