"""The port's public surface against the JAX package's: every public
function, class and method of every JAX module has a counterpart in the port
(or an exemption below, with its reason), and the names this slice adds —
``EllMatrix``, ``ell_spmm``, ``spmm``, ``CooMatrix.astype/from_edges/
transpose``, ``from_scipy(pad_to=)``, ``trace_fun_update_single``,
``finite_mask``, ``checkified`` — compute what the JAX ones compute on
tests/test_sparse.py's shapes.

Tolerances: f64 products to 1e-12 relative (round-off of sums taken in
another order), the dense trace difference to 1e-10 (a difference of two
traces); exact equality for packings, masks and indices.
"""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import krylov_robustness_torch
import krylov_robustness_tpu
from helpers import random_graph
from krylov_robustness_torch.ops import sparse as tsparse
from krylov_robustness_torch.updates.trace_update import (
    trace_fun_update_single,
)
from krylov_robustness_torch.utils.guards import checkified, finite_mask
from krylov_robustness_tpu.ops import sparse as jsparse
from krylov_robustness_tpu.updates.trace_update import (
    trace_fun_update_single as jax_trace_fun_update_single,
)
from krylov_robustness_tpu.utils.guards import finite_mask as jax_finite_mask

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

# JAX module → the port's module of another name (the Pallas kernels' modules
# became the modules of their Hopper kernels)
RENAMED = {
    "krylov_robustness_tpu.ops.pallas_bsr": "krylov_robustness_torch.ops.bsr",
    "krylov_robustness_tpu.ops.pallas_bsr_super":
        "krylov_robustness_torch.ops.bsr_super",
    "krylov_robustness_tpu.ops.pallas_spmm":
        "krylov_robustness_torch.ops.banded_spmm",
}

# (JAX module, name) → why the port has no counterpart
EXEMPT = {
    ("krylov_robustness_tpu.native.graphpack", "*"):
        "the native C++ packer is not carried: the port packs in numpy "
        "(parallel/spmm_sharded.py::pack_ell, ops/banded_spmm.py), and "
        "tests hold the packings equal",
    ("krylov_robustness_tpu.parallel.mesh", "replicated"):
        "a replicated tensor is a plain tensor on every rank: there is no "
        "NamedSharding to describe (row_sharded returns a rank's rows)",
    ("*", "tree_flatten"): "JAX's pytree protocol; torch tensors in plain "
                           "objects need none",
    ("*", "tree_unflatten"): "JAX's pytree protocol",
    ("krylov_robustness_tpu.parallel.spmm_sharded", "interpret"):
        "Pallas interpret mode: in the port a CPU tensor runs the plain "
        "version and a CUDA tensor the kernel",
}


def _exempt(module: str, name: str) -> bool:
    leaf = name.split(".")[-1]
    return any(key in EXEMPT for key in ((module, "*"), ("*", leaf),
                                         (module, leaf)))


def _jax_modules():
    mods = [m.name for m in pkgutil.walk_packages(
        krylov_robustness_tpu.__path__, "krylov_robustness_tpu.")]
    # native/ has no __init__.py, so the walk does not see it
    return sorted(mods + ["krylov_robustness_tpu.native.graphpack"])


def _public(module):
    """(name, object) of the functions and classes a module defines, and its
    upper-case constants."""
    for name, obj in vars(module).items():
        if name.startswith("_"):
            continue
        defined = (inspect.isfunction(obj) or inspect.isclass(obj)) and \
            getattr(obj, "__module__", None) == module.__name__
        if defined or (name.isupper() and not callable(obj)
                       and not inspect.ismodule(obj)):
            yield name, obj


def test_port_has_every_public_name_of_the_jax_package():
    missing = []
    for name in _jax_modules():
        jm = importlib.import_module(name)
        tname = RENAMED.get(name, name.replace("krylov_robustness_tpu",
                                               "krylov_robustness_torch"))
        if _exempt(name, "*"):
            continue
        try:
            tm = importlib.import_module(tname)
        except ModuleNotFoundError:
            missing.append(f"{tname} (module)")
            continue
        for attr, obj in _public(jm):
            if _exempt(name, attr):
                continue
            if not hasattr(tm, attr):
                missing.append(f"{tname}.{attr}")
                continue
            if inspect.isclass(obj):
                port_cls = getattr(tm, attr)
                missing += [f"{tname}.{attr}.{a}" for a in vars(obj)
                            if not a.startswith("_")
                            and not _exempt(name, f"{attr}.{a}")
                            and not hasattr(port_cls, a)]
    # the top-level exports
    missing += [f"krylov_robustness_torch.{a}" for a in
                ("CooMatrix", "EllMatrix", "spmm")
                if not hasattr(krylov_robustness_torch, a)]
    assert not missing, missing


def test_every_exemption_names_something_real():
    """An exemption without its JAX name would hide nothing: each names a
    module, or a member, that the JAX package has."""
    mods = set(_jax_modules())
    for module, name in EXEMPT:
        assert module == "*" or module in mods, module
        if module != "*" and name != "*":
            jm = importlib.import_module(module)
            assert any(name == attr or (inspect.isclass(obj)
                                        and name in vars(obj))
                       for attr, obj in vars(jm).items()), (module, name)


@pytest.mark.parametrize("n,density", [(50, 0.1), (200, 0.02), (333, 0.05)])
def test_ell_matrix_matches_jax_and_scipy(n, density):
    """tests/test_sparse.py's shapes: the same ELL tables as JAX's, and
    y = A·x (``@``, ``ell_spmm`` and ``spmm``) to 1e-12."""
    A = random_graph(n, density, seed=n, weighted=True)
    X = np.random.default_rng(1).standard_normal((n, 7))
    jm = jsparse.EllMatrix.from_scipy(A)
    tm = tsparse.EllMatrix.from_scipy(A, device="cpu")
    np.testing.assert_array_equal(tm.cols.numpy(), np.asarray(jm.cols))
    np.testing.assert_array_equal(tm.vals.numpy(), np.asarray(jm.vals))
    assert (tm.n_pad, tm.slots, tm.nnz) == (jm.n_pad, jm.slots, jm.nnz)
    assert tm.padding_efficiency == jm.padding_efficiency
    Xt = torch.as_tensor(X)
    for y in (tm @ Xt, tsparse.ell_spmm(tm, Xt), tsparse.spmm(tm, Xt)):
        np.testing.assert_allclose(y.numpy(), A @ X, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.matmul(Xt[:, 0]).numpy(), A @ X[:, 0],
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        tsparse.spmm(tsparse.CooMatrix.from_scipy(A, device="cpu"),
                     Xt).numpy(),
        np.asarray(jsparse.spmm(jsparse.CooMatrix.from_scipy(A),
                                jnp.asarray(X))), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("pad_to", [1, 8, 64])
def test_from_scipy_pad_to_matches_jax(pad_to):
    """``pad_to``: the same padded arrays as JAX's (val-0 entries at (0, 0)),
    ``nnz`` the real count; products, ``todense`` and ``to_scipy``
    unchanged by the padding."""
    A = random_graph(40, 0.15, seed=7, weighted=True)
    jm = jsparse.CooMatrix.from_scipy(A, pad_to=pad_to)
    tm = tsparse.CooMatrix.from_scipy(A, device="cpu", pad_to=pad_to)
    if pad_to > 1:
        for a in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(tm, a).numpy(),
                                          np.asarray(getattr(jm, a)))
    else:  # the port's default: exactly the entries (JAX pads to max(nnz, 1))
        assert len(tm.vals) == A.nnz
    assert tm.nnz == jm.nnz == A.nnz
    X = np.random.default_rng(2).standard_normal((40, 3))
    np.testing.assert_allclose((tm @ torch.as_tensor(X)).numpy(), A @ X,
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tm.todense().numpy(), A.toarray(), rtol=1e-12)
    assert (tm.to_scipy() != A).nnz == 0


def test_from_edges_astype_transpose_match_jax():
    e = np.array([[0, 1], [1, 2], [2, 3], [0, 3], [4, 2]])
    w = np.array([1.0, 2.0, 0.5, 3.0, 1.5])
    for weights, sym in ((None, True), (w, True), (w, False)):
        jm = jsparse.CooMatrix.from_edges(e, 6, weights=weights,
                                          symmetrize=sym)
        tm = tsparse.CooMatrix.from_edges(e, 6, weights=weights,
                                          symmetrize=sym, device="cpu")
        assert (tm.to_scipy() != jm.to_scipy()).nnz == 0
        assert tm.nnz == jm.nnz
    t32 = tm.astype(torch.float32)
    assert t32.dtype == torch.float32 and tm.dtype == torch.float64
    np.testing.assert_array_equal(t32.vals.numpy(),
                                  np.asarray(jm.astype(jnp.float32).vals)[
                                      :jm.nnz])
    with pytest.raises(NotImplementedError):
        jm.transpose()
    with pytest.raises(NotImplementedError):
        tm.transpose()


def test_trace_fun_update_single_matches_jax():
    """The dense exact path on a rank-2 edge removal and a rank-1 self-loop
    update, exp and sinh, against JAX's and a dense eigendecomposition."""
    A = random_graph(60, 0.1, seed=5).toarray()
    i, j = np.argwhere(np.tril(A, -1))[0]
    U = np.zeros((60, 2))
    U[i, 0] = U[j, 1] = 1.0
    for B, fun in ((np.array([[0.0, -1.0], [-1.0, 0.0]]), "exp"),
                   (np.array([[0.5, 0.0], [0.0, 0.0]]), "sinh")):
        got = float(trace_fun_update_single(
            torch.as_tensor(A), torch.as_tensor(U), torch.as_tensor(B),
            fun))
        want = float(jax_trace_fun_update_single(
            jnp.asarray(A), jnp.asarray(U), jnp.asarray(B), fun))
        f = {"exp": np.exp, "sinh": np.sinh}[fun]
        dense = np.sum(f(np.linalg.eigvalsh(A + U @ B @ U.T))) - np.sum(
            f(np.linalg.eigvalsh(A)))
        # a difference of two traces whose terms reach e^λmax: round-off
        # of the two eigvalsh, relative to the difference, ~1e-12
        assert got == pytest.approx(want, rel=1e-10)
        assert got == pytest.approx(dense, rel=1e-10)


@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_finite_mask_matches_jax(axis):
    x = np.random.default_rng(0).standard_normal((4, 5, 3))
    x[1, 2, 0] = np.nan
    x[3, 0, 2] = np.inf
    got = finite_mask(torch.as_tensor(x), axis=axis).numpy()
    # a negative axis counts from the end (JAX's reduces over every axis
    # for one: no axis index equals -1)
    want = np.asarray(jax_finite_mask(
        jnp.asarray(x), axis=None if axis is None else axis % x.ndim))
    np.testing.assert_array_equal(got, want)


def test_checkified_reports_a_nan_that_reaches_the_result():
    def f(x):
        return {"y": torch.log(x), "count": torch.tensor([3])}

    err, out = checkified(f, torch.tensor([1.0, -1.0]))
    assert isinstance(err, FloatingPointError) and "f" in str(err)
    assert torch.isnan(out["y"][1])
    err, out = checkified(f, torch.tensor([1.0, 2.0]))
    assert err is None and out["y"][0] == 0
    # a NaN that does not reach the result goes unreported (documented)
    err, out = checkified(lambda x: torch.nan_to_num(torch.log(x)),
                          torch.tensor([-1.0]))
    assert err is None
