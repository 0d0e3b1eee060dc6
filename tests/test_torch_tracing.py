"""The port's spans and counters (``utils/tracing.py``): off, a sweep opens
no profiler range and computes what it computes with them on; on, the
``kr:`` ranges nest as the layers do and carry the shapes actually passed;
the Krylov step counters and the kernels' launch counters count what they
name, and nothing else."""

import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

from krylov_robustness_torch.graphs.centrality import compute_centrality_host
from krylov_robustness_torch.krylov import lanczos
from krylov_robustness_torch.ops import (
    banded_eig,
    banded_spmm,
    bsr,
    bsr_super,
    row_gather,
)
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_torch.optimize.greedy import greedy_krylov
from krylov_robustness_torch.updates import trace_update
from krylov_robustness_torch.utils import logging as tlogging
from krylov_robustness_torch.utils import tracing

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)

N, K, Q = 150, 3, 20


@pytest.fixture(autouse=True)
def _spans_off():
    tracing.disable()
    yield
    tracing.disable()


@pytest.fixture(scope="module")
def graph():
    """A path of N nodes and 60 short chords, its centrality and the break
    protocol's tolerance: n > 130, so the scorer takes the host-eigh lane."""
    rng = np.random.default_rng(5)
    i = np.arange(N - 1)
    src = np.concatenate([i, rng.integers(0, N - 21, 60)])
    dst = np.concatenate([i + 1, src[N - 1:] + rng.integers(2, 20, 60)])
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(N, N))
    A = sp.csr_matrix(((A + A.T) > 0).astype(np.float64))
    c = compute_centrality_host(A, "eig")
    lam = float(np.linalg.eigvalsh(A.toarray()).max())
    return A, c, 1e-6 * float(np.exp(lam))


def sweep(graph, k=K):
    A, c, tol = graph
    return greedy_krylov(A, k, Q, c, order="min", tol=tol, mode="break",
                         dtype=torch.float64, backend="coo", fused_steps=0,
                         device="cpu")


def ranges(prof) -> list:
    """(name, start, end) of the profiled ``kr:`` ranges, in start order."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name.startswith("kr:")]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def inside(r, outer) -> bool:
    return any(o[1] <= r[1] and r[2] <= o[2] for o in outer)


def test_off_opens_no_range_and_on_changes_nothing(graph, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counted(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert tracing.span("step", 1, 2) is tracing.span("krylov")
    assert not tracing.enabled()
    off = sweep(graph)
    assert calls == []
    tracing.enable()
    assert tracing.enabled()
    on = sweep(graph)
    assert calls and all(c.startswith("kr:") for c in calls)
    np.testing.assert_array_equal(on.edges, off.edges)
    np.testing.assert_array_equal(on.per_step_delta, off.per_step_delta)
    np.testing.assert_array_equal(on.per_step_iters, off.per_step_iters)
    assert tlogging.trace_annotation is tracing.span


def test_spans_nest_as_the_layers_and_carry_the_shapes(graph, monkeypatch):
    """kr:step carries its sweep and step ids; kr:scorer nests in it,
    kr:krylov in that, kr:spmm in kr:krylov, the host spectra in
    kr:scorer; the Krylov and SpMM tags are the shapes passed."""
    steps, products = [], []
    step, matmul = lanczos.lanczos_step, CooMatrix.matmul

    def recorded_step(A, state, *a, **k):
        steps.append(tuple(state.v_cur.shape) + (state.v_cur.element_size(),))
        return step(A, state, *a, **k)

    def recorded_matmul(self, x):
        products.append((self.n, self.nnz, x.shape[1], self.vals.
                         element_size(), x.element_size()))
        return matmul(self, x)

    monkeypatch.setattr(lanczos, "lanczos_step", recorded_step)
    monkeypatch.setattr(CooMatrix, "matmul", recorded_matmul)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sweep(graph, k=2)
    sweep_id = tracing.counters()["sweep.builds"]
    rs = ranges(prof)
    by = {}
    for r in rs:
        by.setdefault(r[0].split("|")[0], []).append(r)
    assert [r[0] for r in by["kr:step"]] == [
        f"kr:step|{sweep_id}|0", f"kr:step|{sweep_id}|1"]
    (build,) = by["kr:sweep.build"]
    assert build[2] <= by["kr:step"][0][1]
    assert [r[0] for r in by["kr:scorer"]] == [f"kr:scorer|{Q}"] * 2
    assert all(inside(r, by["kr:step"]) for r in by["kr:scorer"])
    assert all(inside(r, by["kr:scorer"]) for r in by["kr:krylov"])
    assert all(inside(r, by["kr:krylov"]) for r in by["kr:spmm"])
    for label in ("kr:spectra.band", "kr:spectra.eig"):
        assert by[label] and all(inside(r, by["kr:scorer"])
                                 for r in by[label])
    assert [r[0] for r in by["kr:krylov"]] == [
        "kr:krylov|" + "|".join(map(str, s)) for s in steps]
    assert [r[0] for r in by["kr:spmm"]] == [
        "kr:spmm|" + "|".join(map(str, p)) for p in products]
    assert len(steps) == len(products) > 0


@pytest.mark.parametrize("mode", ["break", "make"])
def test_candidate_range_and_sweep_counters(graph, monkeypatch, mode):
    """kr:sweep.candidates carries the mode and the Q + k candidates asked
    for and nests in kr:sweep.build; a sweep adds to sweep.candidates_s
    once, within what it adds to sweep.build_s, and to sweep.slots the
    entries its operator holds beyond A: on COO in make mode both triangles
    of each of the Q + k candidates, in break mode none."""
    A, c, tol = graph
    calls = []
    real = tracing.count

    def recorded(name, n=1):
        calls.append((name, n))
        return real(name, n)

    monkeypatch.setattr(tracing, "count", recorded)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        greedy_krylov(A, 2, Q, c, order="min", tol=tol, mode=mode,
                      dtype=torch.float64, backend="coo", fused_steps=0,
                      device="cpu")
    by = {}
    for r in ranges(prof):
        by.setdefault(r[0].split("|")[0], []).append(r)
    (cands,) = by["kr:sweep.candidates"]
    assert cands[0] == f"kr:sweep.candidates|{mode}|{Q + 2}"
    assert inside(cands, by["kr:sweep.build"])
    grew = {name: [n for m, n in calls if m == name] for name in (
        "sweep.candidates_s", "sweep.build_s", "sweep.slots")}
    assert len(grew["sweep.candidates_s"]) == 1
    assert 0 < grew["sweep.candidates_s"][0] <= grew["sweep.build_s"][0]
    assert grew["sweep.slots"] == [2 * (Q + 2) if mode == "make" else 0]


@pytest.mark.parametrize("mode", ["break", "make"])
@pytest.mark.parametrize("backend", ["bsr", "banded", "coo"])
def test_operator_range_carries_kind_and_slots(graph, backend, mode):
    """kr:sweep.operator|kind|slots opens once a sweep, inside
    kr:sweep.build and before its first step: kind the operator built
    (make mode takes the banded one as break does), slots both triangles of
    the Q + k candidates in make mode, 0 in break mode."""
    A, c, tol = graph
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = greedy_krylov(A, 2, Q, c, order="min", tol=tol, mode=mode,
                          dtype=torch.float64, backend=backend,
                          fused_steps=0, device="cpu")
    by = {}
    for rg in ranges(prof):
        by.setdefault(rg[0].split("|")[0], []).append(rg)
    (op,) = by["kr:sweep.operator"]
    slots = 2 * (Q + 2) if mode == "make" else 0
    assert op[0] == f"kr:sweep.operator|{backend}|{slots}"
    assert inside(op, by["kr:sweep.build"])
    assert op[2] <= by["kr:step"][0][1]
    assert r.operator.startswith({"bsr": "SuperBsrOperator",
                                  "banded": "BandedEllOperator",
                                  "coo": "CooMatrix"}[backend])


@pytest.mark.parametrize("backend", ["banded", "coo"])
def test_coo_counter_counts_each_coo_product(graph, monkeypatch, backend):
    """spmm.launches.coo is there before any product, and grows by one at
    each CooMatrix product, vector or block, and by none on another
    operator: a make sweep on the banded operator runs no COO product."""
    assert "spmm.launches.coo" in tracing.counters()
    calls = []
    real = CooMatrix.matmul

    def recorded(self, x):
        calls.append(x.shape)
        return real(self, x)

    monkeypatch.setattr(CooMatrix, "matmul", recorded)
    A, c, tol = graph
    M = CooMatrix.from_scipy(A, device="cpu")
    before = tracing.counters()["spmm.launches.coo"]
    M @ torch.ones(N, dtype=torch.float64)
    M.matmul(torch.ones(N, 3, dtype=torch.float64))
    assert tracing.counters()["spmm.launches.coo"] == before + 2
    calls.clear()
    before = tracing.counters()["spmm.launches.coo"]
    greedy_krylov(A, 2, Q, c, order="min", tol=tol, mode="make",
                  dtype=torch.float64, backend=backend, fused_steps=0,
                  device="cpu")
    grew = tracing.counters()["spmm.launches.coo"] - before
    assert grew == len(calls)
    assert (grew > 0) == (backend == "coo")


@pytest.mark.parametrize("backend", ["bsr", "banded", "coo"])
def test_operator_bytes_grow_by_each_build(graph, backend):
    """spmm.operator_bytes grows at each sweep build by the bytes of the
    operator it built, counted here from A's shapes: the super-tile
    operator's f64 values in CSR order, int32 columns, value offsets and
    row pointers (no tile); the banded operator's (K, n) int32 columns and
    f64 values (K the largest row) and its int32 row index; COO's int64
    rows and columns and f64 values. A path with chords holds no run of
    rows that K1/K2 split, so spmm.split_entries and spmm.split_units grow
    by 0 with every backend."""
    A, c, tol = graph
    n, nnz = A.shape[0], A.nnz
    K = int(np.diff(A.indptr).max())
    want = {"bsr": nnz * (8 + 4 + 4) + (n + 1) * 4,
            "banded": K * n * (4 + 8) + (n + 1) * 4 + nnz * (4 + 4),
            "coo": nnz * (8 + 8 + 8)}[backend]
    before = tracing.counters()
    for _ in range(2):
        greedy_krylov(A, 1, Q, c, order="min", tol=tol, mode="break",
                      dtype=torch.float64, backend=backend, fused_steps=0,
                      device="cpu")
    now = tracing.counters()
    grew = {k: now[k] - before.get(k, 0) for k in (
        "spmm.operator_bytes", "sweep.builds", "spmm.split_entries",
        "spmm.split_units")}
    assert grew == {"spmm.operator_bytes": 2 * want, "sweep.builds": 2,
                    "spmm.split_entries": 0, "spmm.split_units": 0}


@pytest.mark.parametrize("backend", ["bsr", "coo"])
def test_split_counters_read_each_build(monkeypatch, backend):
    """On a path of 600 nodes with a hub of 300 neighbours, each build of
    the super-tile operator adds its split plan to spmm.split_entries (the
    hub's 300 entries and the rest of its run of rows) and
    spmm.split_units (at least the hub row's two pieces); COO adds 0."""
    n = 600
    rng = np.random.default_rng(9)
    i = np.arange(n - 1)
    src = np.concatenate([i, np.zeros(300, int)])
    dst = np.concatenate([i + 1, rng.choice(np.arange(2, n), 300,
                                            replace=False)])
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    A = sp.csr_matrix(((A + A.T) > 0).astype(np.float64))
    lam = float(np.linalg.eigvalsh(A.toarray()).max())
    tol = 1e-6 * float(np.exp(lam))
    calls = []
    real = tracing.count

    def recorded(name, n=1):
        calls.append((name, n))
        return real(name, n)

    monkeypatch.setattr(tracing, "count", recorded)
    for _ in range(2):
        greedy_krylov(A, 1, Q, compute_centrality_host(A, "eig"),
                      order="min", tol=tol, mode="break",
                      dtype=torch.float64, backend=backend, fused_steps=0,
                      device="cpu")
    entries, units = ([n for m, n in calls if m == name] for name in (
        "spmm.split_entries", "spmm.split_units"))
    if backend == "coo":
        assert entries == units == [0, 0]
        return
    assert entries[0] == entries[1] > 300 and units[0] == units[1] >= 3


def test_sturm_span_carries_batch_and_order():
    G = torch.randn(3, 12, 12, dtype=torch.float64)
    G = G + G.transpose(-1, -2)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        banded_eig.eigvalsh_banded(G, w=2)
    assert [r[0] for r in ranges(prof)] == ["kr:spectra.sturm|3|12"]


@pytest.mark.parametrize("batch,cells", [(20, None), (70, 64 * N)])
def test_krylov_step_counters(graph, monkeypatch, batch, cells):
    """steps_run adds the carry's width × steps of every
    ``lanczos_continue`` (chunk padding included: 70 candidates in two
    chunks of 64); steps_used adds, for each candidate, the steps to its
    acceptance, never more; as each round runs for the candidates not yet
    accepted, the two are equal."""
    A, c, tol = graph
    if cells is not None:
        monkeypatch.setattr(trace_update, "MAX_SCORE_CELLS", cells)
    calls = []
    cont = trace_update.lanczos_continue

    def recorded(A, state, num_steps, *a, **k):
        calls.append(state.alive.shape[0] * num_steps)
        return cont(A, state, num_steps, *a, **k)

    monkeypatch.setattr(trace_update, "lanczos_continue", recorded)
    M = CooMatrix.from_scipy(A, device="cpu")
    C = sp.coo_matrix(sp.tril(A))
    edges = np.stack([C.row, C.col], axis=1)[:batch]
    before = tracing.counters()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        r = trace_update.trace_fun_update_edges(M, edges, sign=-1.0, tol=tol)
    after = tracing.counters()
    run = after["krylov.steps_run"] - before.get("krylov.steps_run", 0)
    used = after["krylov.steps_used"] - before.get("krylov.steps_used", 0)
    assert run == sum(calls) > 0
    assert 0 < used <= run
    assert used == run  # each round runs for the unaccepted only
    assert bool(r.converged.all())
    if cells is None:  # accepted at the round of its iterate
        assert used == int(r.iters.sum())
    assert [n for n, _, _ in ranges(prof) if n.startswith("kr:scorer")] \
        == [f"kr:scorer|{batch}"]


def _launch_free(monkeypatch, lib):
    """The launch wrappers with no card: the arguments pass, the library is
    ``lib``, the stream is 0."""
    monkeypatch.setattr(row_gather, "check_launch",
                        lambda *a: a[5].shape[0])
    for mod in (bsr_super, bsr):
        monkeypatch.setattr(mod, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: SimpleNamespace(cuda_stream=0))


def _launches():
    counts = tracing.counters()
    return [counts.get(f"spmm.launches.K{i}", 0) for i in (1, 2, 3, 4)]


@pytest.mark.parametrize("code", [0, 1])
def test_launch_counters_count_launches_only(monkeypatch, code):
    """One more a successful launch of K1, K2 (f32 and f64) and K4; none
    for a launch that fails, one the wrapper refuses, or a CPU product."""
    def entry(*args):
        return code

    lib = SimpleNamespace(**{name: entry for name in (
        "krt_bsr_super_bf16", "krt_bsr_super_f32", "krt_bsr_super_f64",
        "krt_bsr_flat_f32", "krt_bsr_flat_f64")})
    _launch_free(monkeypatch, lib)
    i32 = torch.zeros(4, dtype=torch.int32)
    x32, x64 = torch.ones(8, 3), torch.ones(8, 3, dtype=torch.float64)
    launches = (
        (0, lambda: bsr_super.tile_spmm_bf16(i32, i32, i32, i32, x32, 2)),
        (1, lambda: bsr_super.tile_spmm_full(i32, i32, i32, i32, x32)),
        (1, lambda: bsr_super.tile_spmm_full(i32, i32, i32, i32, x64)),
        (3, lambda: bsr.bsr_spmm(i32, i32, i32, i32, x64)))
    for k, launch in launches:
        before = _launches()
        if code:
            with pytest.raises(RuntimeError):
                launch()
        else:
            launch()
        grew = [a - b for a, b in zip(_launches(), before)]
        assert grew == [int(not code and j == k) for j in range(4)]
    before = _launches()
    with pytest.raises(ValueError):  # K3 takes CUDA tensors only
        banded_spmm.ell_spmm(i32[None], x64[:4].T.contiguous(), i32, i32,
                             i32, x64)
    with pytest.raises(ValueError):  # K1 takes 2 or 3 terms
        bsr_super.tile_spmm_bf16(i32, i32, i32, i32, x32, 4)
    A = sp.random(8, 8, density=0.3, random_state=1, format="csr")
    (CooMatrix.from_scipy(A + A.T, device="cpu") @ x64)
    assert _launches() == before


def test_device_busy_is_the_union_of_device_intervals():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(a, b, device=cuda, annotation=False):
        return SimpleNamespace(time_range=SimpleNamespace(start=a, end=b),
                               device_type=device,
                               is_user_annotation=annotation)

    prof = SimpleNamespace(events=lambda: [
        ev(0, 10), ev(5, 12), ev(20, 25), ev(21, 22), ev(0, 100, cpu),
        ev(0, 90, annotation=True)])
    assert tracing.device_busy_us(prof) == 17


def test_counters_are_a_snapshot():
    snap = tracing.counters()
    value = tracing.count("sweep.builds", 0)
    assert value == snap.get("sweep.builds", 0)
    snap["sweep.builds"] = -1
    assert tracing.counters().get("sweep.builds", 0) == value
