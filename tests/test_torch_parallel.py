"""The distributed layer of the PyTorch port (parallel/, the sharded greedy
backends, experiments/scaling.py) against the JAX package's on the same
seeded inputs.

The port runs one process per rank: worlds of 2 ranks (rows = 2) and of 4
(rows × cands = 2 × 2) are spawned with gloo on the CPU through
``parallel/selfcheck.py`` (a FileStore under tmp_path, one spawn per world,
each with a timeout of 120 s so that a hung rank fails its test); the JAX
side runs on the conftest's 8-device CPU mesh, on meshes of the same shape.
A world of one rank runs in-process.

Tolerances: products 1e-12 relative to scipy (f64 sums in another order);
packings equal array for array; greedy picks identical, rob_variation within
1e-10 relative and A_new identical (f64).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from helpers import random_graph
from krylov_robustness_torch import interop
from krylov_robustness_torch.graphs.centrality import compute_centrality_host
from krylov_robustness_torch.graphs.top_edges import find_top_missing_edges
from krylov_robustness_torch.optimize import greedy as tgreedy
from krylov_robustness_torch.optimize.greedy import greedy_krylov
from krylov_robustness_torch.parallel import mesh as tmesh
from krylov_robustness_torch.parallel import selfcheck
from krylov_robustness_torch.parallel.spmm_sharded import (
    BsrRowShardedMatrix,
    RowShardedMatrix,
    pack_ell,
    psum_dot,
)
from krylov_robustness_tpu.native.graphpack import pack_ell as jax_pack_ell
from krylov_robustness_tpu.optimize import greedy as jgreedy
from krylov_robustness_tpu.parallel import mesh as jmesh
from krylov_robustness_tpu.parallel.spmm_sharded import (
    BsrRowShardedMatrix as JBsrSharded,
)
from krylov_robustness_tpu.parallel.spmm_sharded import (
    RowShardedMatrix as JRowSharded,
)
from test_torch_greedy import path_graph

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

TIMEOUT = 120  # seconds per spawned world
F64 = torch.float64


def _graphs():
    """The row-sharded product graph (n = 333, not divisible by the mesh),
    the super-tile graph (n = 301, tiles 128 × 128) and the n = 150 greedy
    graphs of tests/test_greedy.py:243-253 (break) and :275-285 (make)."""
    A = random_graph(333, 0.05, seed=1, weighted=True)
    B = sp.random(301, 301, density=0.03, random_state=7, format="csr")
    B = ((B + B.T) > 0).astype(np.float64)
    B.setdiag(0)
    B.eliminate_zeros()
    return A, sp.csr_matrix(B), path_graph(5, 60), path_graph(12, 50)


A333, B301, G_BREAK, G_MAKE = _graphs()
X = np.random.default_rng(0).standard_normal((333, 6))

# (backend, mode, k, Q, fused_steps, dtype): odd Q = 13 pads the candidate
# batch to the cands axis
CASES = {
    "break": [(b, "break", 5, 13, 0, F64) for b in ("sharded", "sharded_bsr")]
    + [("sharded", "break", 5, 13, 3, F64)],
    "make": [(b, "make", 5, 13, 0, F64) for b in ("sharded", "sharded_bsr")],
}


def _plan(rows=None, batch=None):
    plan = {
        "row_sharded": ("check_row_sharded",
                        dict(A=A333, x=X, rows=rows, batch=batch)),
        "greedy_break": ("check_greedy", dict(
            A=G_BREAK, c=compute_centrality_host(G_BREAK, "eig"),
            cases=CASES["break"], rows=rows, batch=batch)),
        "greedy_make": ("check_greedy", dict(
            A=G_MAKE, c=compute_centrality_host(G_MAKE, "eig"),
            cases=CASES["make"], rows=rows, batch=batch)),
    }
    if rows is None:
        plan["bsr"] = ("check_bsr_packing", dict(A=B301, x=X[:301, :4]))
        plan["psum_scaling"] = ("check_psum_and_scaling", {})
    return plan


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return selfcheck.launch("run_checks", 2, tmp_path_factory.mktemp("w2"),
                            timeout=TIMEOUT, plan=_plan())


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """rows × cands = 2 × 2; the greedy cases on the automatic mesh, which
    is that mesh for four ranks."""
    plan = _plan(rows=2, batch=2)
    for key in ("greedy_break", "greedy_make"):
        plan[key][1]["rows"], plan[key][1]["batch"] = None, "auto"
    return selfcheck.launch("run_checks", 4, tmp_path_factory.mktemp("w4"),
                            timeout=TIMEOUT, plan=plan)


@pytest.mark.parametrize("world", ["world2", "world4"])
def test_row_sharded_products_match_scipy(world, request):
    """coo and ell, the replicated product and each rank's block of the
    sharded-in / sharded-out product (its column block on a cands axis)."""
    want = A333 @ X
    wpad = np.zeros((334, X.shape[1]))
    wpad[:333] = want
    for out in (r["row_sharded"] for r in request.getfixturevalue(world)):
        for layout in ("coo", "ell"):
            np.testing.assert_allclose(out[layout, "matmul"], want,
                                       rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(
                out[layout, "sharded"],
                wpad[out["row_block"]][:, out["col_block"]],
                rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(out["coo_todense"][:333, :333],
                                   A333.toarray(), rtol=1e-12)


def test_row_sharded_coo_slots_and_ell_packing_equal_jax(world2):
    """Each rank's COO slots are the JAX operator's shard (make_mesh(2)),
    and its ELL tables equal the native pack_ell of its rows."""
    J = JRowSharded.from_scipy(A333, jmesh.make_mesh(2))
    K = int(np.diff(A333.indptr).max())
    for d, out in enumerate(r["row_sharded"] for r in world2):
        for got, want in zip(out["coo_slots"], (J.rows_local, J.cols,
                                                J.vals)):
            np.testing.assert_array_equal(
                got, np.asarray(want).reshape(2, -1)[d])
        cols, vals = jax_pack_ell(A333[d * 167:min((d + 1) * 167, 333)],
                                  167, K)
        np.testing.assert_array_equal(out["ell_cols"], cols)
        np.testing.assert_array_equal(out["ell_vals"], vals)
    for rows in (slice(0, 167), slice(167, 333)):
        for got, want in zip(pack_ell(A333[rows], 167, K),
                             jax_pack_ell(A333[rows], 167, K)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("overlap", [True, False])
def test_bsr_row_sharded_packing_equals_jax(world2, overlap):
    J = JBsrSharded.from_scipy(B301, jmesh.make_mesh(2), dtype=jnp.float64,
                               tile=(128, 128), interpret=True,
                               overlap=overlap)
    for d, out in enumerate(r["bsr"][overlap] for r in world2):
        np.testing.assert_array_equal(out["atiles"], np.asarray(J.atiles)[d])
        for name in ("slab", "sup", "start"):
            np.testing.assert_array_equal(out[name],
                                          np.asarray(getattr(J, name))[d])
        np.testing.assert_array_equal(out["entry_positions"],
                                      J.entry_positions())
        np.testing.assert_array_equal(out["entry_rc"], J.entry_rc())
        assert (out["n_diag"], out["m_pad"], out["n_pad"], out["n"],
                out["mode"]) == (J.n_diag, J.m_pad, J.n_pad, J.n, J.mode)
        np.testing.assert_array_equal(out["entry_values"], J.entry_values())
    assert (world2[0]["bsr"][overlap]["n_diag"] > 0) == overlap


@pytest.mark.parametrize("overlap", [True, False])
def test_bsr_row_sharded_plain_product_matches_scipy(world2, overlap):
    """The plain passes (diag on the local x, off on the gathered x), then a
    symmetric value edit through ``set_flat`` on every rank."""
    x = X[:301, :4]
    for out in (r["bsr"][overlap] for r in world2):
        np.testing.assert_allclose(out["matmul"], B301 @ x, rtol=1e-12,
                                   atol=1e-12)
        i, j = out["edited"]
        B2 = B301.tolil()
        B2[i, j] = B2[j, i] = 0
        np.testing.assert_allclose(out["matmul_edited"],
                                   sp.csr_matrix(B2) @ x, rtol=1e-12,
                                   atol=1e-12)


def _jax_reference(A, mode, mesh, fused):
    c = compute_centrality_host(A, "eig")
    return jgreedy.greedy_krylov(A, 5, 13, c, order="min", tol=1e-8,
                                 mode=mode, backend="sharded", mesh=mesh,
                                 fused_steps=fused)


@pytest.mark.parametrize("world,mode", [("world2", "break"),
                                        ("world2", "make"),
                                        ("world4", "break"),
                                        ("world4", "make")])
def test_greedy_sharded_backends_match_jax(world, mode, request):
    """greedy sharded and sharded_bsr (per-step and one fused case) on every
    rank against the JAX package's backend='sharded' on a mesh of the same
    shape: identical picks on every rank, rob_variation within 1e-10,
    identical A_new."""
    A = G_BREAK if mode == "break" else G_MAKE
    jm = (jmesh.make_mesh(2) if world == "world2"
          else jmesh.make_mesh_2d(2, 2))
    refs = {f: _jax_reference(A, mode, jm, f)
            for f in sorted({c[4] for c in CASES[mode]})}
    for out in (r[f"greedy_{mode}"] for r in request.getfixturevalue(world)):
        for backend, _, k, Q, fused, _ in CASES[mode]:
            got, ref = out[backend, mode, fused], refs[fused]
            np.testing.assert_array_equal(got["edges"], ref.edges)
            np.testing.assert_allclose(got["rob_variation"],
                                       ref.rob_variation, rtol=1e-10)
            assert (sp.csr_matrix(got["A_new"]) != ref.A_new).nnz == 0
            assert got["operator"] == ("RowShardedMatrix" if backend ==
                                       "sharded" else
                                       "BsrRowShardedMatrix(f32)")
            assert (got["fused_accepted"] > 0) == (fused > 1)


def test_psum_dot_and_scaling_on_two_ranks(world2):
    """psum_dot sums Σ a·a over both ranks' blocks; measure_sharded_spmm
    returns a positive rate at D = 1 (rank 0 only) and D = 2."""
    want = float(np.sum(np.arange(8.0) ** 2))
    for rank, r in enumerate(world2):
        out = r["psum_scaling"]
        assert out["psum"] == want
        assert (out["world"], out["backend"]) == (2, "gloo")
        assert set(out["rates"]) == ({1, 2} if rank == 0 else {2})
        assert all(t > 0 and rate > 0 for t, rate in out["rates"].values())


def test_dry_run_on_a_two_by_two_mesh(tmp_path):
    """The counterpart of __graft_entry__.py's dryrun_multichip, in a world
    of four ranks of its own: fused sharded f32 greedy (k = 4, Q = 9,
    fused_steps = 2) on the rows × cands mesh, sharded_bsr picking the same
    edges (on K1's plain version)."""
    outs = selfcheck.launch("check_dryrun", 4, tmp_path, timeout=TIMEOUT)
    for out in outs:
        assert out["mesh"] == {"cands": 2, "rows": 2} and out["n"] == 194
        assert out["operators"] == ("RowShardedMatrix",
                                    "BsrRowShardedMatrix(bf16x2)")
        np.testing.assert_array_equal(out["edges"], outs[0]["edges"])
        assert out["rob_variation"] < 0


def test_maybe_init_distributed_from_torchrun_variables(tmp_path):
    outs = selfcheck.launch("check_env_init", 2, tmp_path, timeout=TIMEOUT,
                            init="env")
    assert [(o["world"], o["rank"], o["backend"]) for o in outs] == [
        (2, 0, "gloo"), (2, 1, "gloo")]
    assert all(o["psum"] == 6.0 for o in outs)


def test_world_of_one_in_process():
    """Without a process group: 1-rank meshes whose collectives are the
    identity; both sharded backends against JAX's on a 1-device mesh; the
    interop builders from the JAX operators' arrays."""
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"rows": 1} and mesh.groups == (None,)
    with pytest.raises(ValueError, match="need 4 ranks"):
        tmesh.make_mesh_2d(2, 2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(device="cuda")
    a = torch.arange(3.0, dtype=F64)
    assert float(psum_dot(a, a)) == 5.0
    c = compute_centrality_host(G_BREAK, "eig")
    ref = jgreedy.greedy_krylov(G_BREAK, 3, 13, c, order="min", tol=1e-8,
                                backend="sharded", mesh=jmesh.make_mesh(1))
    for backend in ("sharded", "sharded_bsr"):
        r = greedy_krylov(G_BREAK, 3, 13, c, order="min", tol=1e-8,
                          backend=backend, mesh=mesh, device="cpu")
        np.testing.assert_array_equal(r.edges, ref.edges)
        np.testing.assert_allclose(r.rob_variation, ref.rob_variation,
                                   rtol=1e-10)
    J = JRowSharded.from_scipy(A333, jmesh.make_mesh(1))
    M = interop.row_sharded_from_arrays(
        np.asarray(J.rows_local), np.asarray(J.cols), np.asarray(J.vals),
        J.n, J.n_orig, J.nnz, mesh)
    np.testing.assert_allclose((M @ torch.as_tensor(X)).numpy(), A333 @ X,
                               rtol=1e-12, atol=1e-12)
    JB = JBsrSharded.from_scipy(B301, jmesh.make_mesh(1), dtype=jnp.float64,
                                tile=(128, 128), interpret=True)
    S = interop.bsr_row_sharded_from_arrays(
        np.asarray(JB.atiles), np.asarray(JB.slab), np.asarray(JB.sup),
        np.asarray(JB.start), JB.entry_positions(), JB.entry_rc(), JB.n,
        JB.n_orig, JB.nnz, JB.m_pad, JB.n_pad, JB.n_diag, JB.mode,
        torch.float64, mesh)
    x = torch.as_tensor(X[:301, :4])
    np.testing.assert_allclose((S @ x).numpy(), B301 @ X[:301, :4],
                               rtol=1e-12, atol=1e-12)
    own = BsrRowShardedMatrix.from_scipy(B301, mesh, dtype=F64,
                                         tile=(128, 128))
    np.testing.assert_array_equal(own.atiles.numpy(), S.atiles.numpy())
    assert isinstance(M, RowShardedMatrix)


def test_make_mode_placeholders_do_not_block_k1():
    """The repaired fault of the JAX package (spmm_sharded.py:434-439): its
    bf16-exactness test sees make mode's 1e-300 placeholder slots, so a 0/1
    make sweep in f32 runs K2 ('f32'). The port's candidate slots hold
    explicit zeros from the start: 'bf16x2' (K1), and its make picks equal
    the single-chip 'bsr' backend's in f32."""
    A = G_MAKE
    c = compute_centrality_host(A, "eig")
    top = find_top_missing_edges(A, c, 15, "min")
    J = jgreedy._ShardedBsrFrozenMatrix(A, top, dtype=jnp.float32,
                                        mesh=jmesh.make_mesh(1),
                                        interpret=True)
    assert J.op.mode == "f32"
    T = tgreedy._ShardedBsrFrozenMatrix(A, top, dtype=torch.float32,
                                        device="cpu")
    assert T.op.mode == "bf16x2"
    # the candidate slots hold zeros: the operator is A itself
    assert (T.to_scipy() != A).nnz == 0
    tol = 1e-6 * float(np.exp(np.linalg.eigvalsh(A.toarray()).max()))
    kw = dict(order="min", tol=tol, mode="make", dtype=torch.float32,
              device="cpu")
    r_sh = greedy_krylov(A, 3, 12, c, backend="sharded_bsr", **kw)
    r_one = greedy_krylov(A, 3, 12, c, backend="bsr", **kw)
    assert r_sh.operator == "BsrRowShardedMatrix(bf16x2)"
    assert r_one.operator == "SuperBsrOperator(bf16x2)"
    np.testing.assert_array_equal(r_sh.edges, r_one.edges)
    np.testing.assert_allclose(r_sh.rob_variation, r_one.rob_variation,
                               rtol=1e-4)
