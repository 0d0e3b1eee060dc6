"""Multi-rank self-checks of the distributed layer — the counterpart of the
JAX package's ``__graft_entry__.py::dryrun_multichip``, and the rank-side
checks that the CPU tests and ``chip_smoke.py`` spawn.

:func:`dryrun` runs the production multi-rank greedy path on every rank of a
process group: ``greedy_krylov(backend='sharded', fused_steps=2)`` (k = 4,
Q = 9, f32) on the example graph of ``__graft_entry__.py``, then
``backend='sharded_bsr'`` (the K1/K2 local product) must pick the same
edges. :func:`launch` starts a world of ranks as fresh processes, runs one
function of this module on each and returns what each returned; a rank
that hangs fails the launch at its timeout instead of blocking its caller.
Functions given to :func:`launch` must live in an importable module (a
spawned process unpickles them by name), which is why the checks live here:
the distributed layer's, and CONFIG 5's — the weighted path on
``RowShardedMatrix`` (:func:`check_sharded_funm`,
:func:`check_config5_problem`) and the driver
``experiments/config5.py`` as a user runs it (:func:`run_config5`).
"""

from __future__ import annotations

import inspect
import multiprocessing
import os
import queue as queue_mod
import time
import traceback

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..utils import tracing
from .mesh import (
    default_mesh,
    from_first_rank,
    make_mesh,
    make_mesh_2d,
    row_sharded,
    same_on_every_rank,
)
from .spmm_sharded import BsrRowShardedMatrix, RowShardedMatrix, psum_dot


class SelfCheckFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SelfCheckFailure(msg)


def example_graph(n=256, seed=0) -> sp.csr_matrix:
    """``__graft_entry__.py::_example_graph``: a path plus 3n seeded short
    chords, symmetric, 0/1."""
    rng = np.random.default_rng(seed)
    i = np.arange(n - 2)
    chord_src = rng.integers(0, n - 9, 3 * n)
    src = np.concatenate([i, chord_src])
    dst = np.concatenate([i + 1, chord_src + rng.integers(1, 8, 3 * n)])
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float64)
    A.setdiag(0)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    return A


def dryrun(device) -> dict:
    """The multi-rank dry run (``__graft_entry__.py:61-103``), on every rank
    of the process group (or one rank without one)."""
    from ..graphs.centrality import compute_centrality_host
    from ..optimize.greedy import greedy_krylov

    mesh = default_mesh(device=device)
    A = example_graph(n=8 * mesh.shape["rows"] * 4 + 130)  # past n = 130
    cent = compute_centrality_host(A, "eig")
    kw = dict(order="min", tol=1e-6, mode="break", dtype=torch.float32,
              mesh=mesh, fused_steps=2, device=mesh.device)
    res = greedy_krylov(A, 4, 9, cent, backend="sharded", **kw)
    require(res.edges.shape == (4, 2), f"dry run picked {res.edges.shape}")
    require(bool(np.isfinite(res.rob_variation)), "dry run: non-finite Δ")
    require(res.rob_variation < 0.0, "dry run: break mode raised trace")
    require(A.nnz - res.A_new.nnz == 8, "dry run: not four symmetric "
            "deletions")
    res_bsr = greedy_krylov(A, 4, 9, cent, backend="sharded_bsr", **kw)
    require(np.array_equal(res.edges, res_bsr.edges),
            f"dry run: sharded_bsr picks {res_bsr.edges.tolist()} != "
            f"sharded {res.edges.tolist()}")
    return dict(mesh=mesh.shape, n=A.shape[0], edges=res.edges,
                rob_variation=res.rob_variation, operators=(
                    res.operator, res_bsr.operator),
                fused=(res.fused_accepted, res_bsr.fused_accepted))


# -- launching a world of ranks ----------------------------------------------
def _rank_entry(rank, world, init, device_kind, fn_name, kwargs, env,
                queue):
    try:
        os.environ.update(env)
        if device_kind == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(0)
        if init == "env":
            from .mesh import maybe_init_distributed

            maybe_init_distributed()
        else:
            dist.init_process_group("gloo", init_method=init, rank=rank,
                                    world_size=world)
        fn = globals()[fn_name]
        if "device_kind" in inspect.signature(fn).parameters:
            kwargs = dict(kwargs, device_kind=device_kind)
        try:
            out = fn(rank=rank, **kwargs)
        finally:
            dist.destroy_process_group()
        queue.put((rank, "ok", out))
    except BaseException:  # reported to the parent, which raises
        queue.put((rank, "error", traceback.format_exc()))


def launch(fn_name: str, world: int, root, *, timeout: float,
           device_kind: str = "cpu", init: str = "file", **kwargs) -> list:
    """Run ``fn_name(rank=r, **kwargs)`` (a function of this module; given
    ``device_kind`` too where it takes one) on each rank of a new world of
    ``world`` spawned processes: gloo through a ``FileStore`` under the
    directory ``root`` (``init="file"``), or from torchrun-style variables
    on localhost (``init="env"``, as :func:`.mesh.maybe_init_distributed`
    chooses). Returns the ranks' results in
    rank order; raises if a rank fails or ``timeout`` seconds pass first,
    and stops every process it started."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    if init == "file":
        path = os.path.join(str(root), f"store_{fn_name}_{time.time_ns()}")
        init_method, envs = f"file://{path}", [{}] * world
    else:
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        init_method = "env"
        envs = [dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK="0",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
                for r in range(world)]
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, world, init_method, device_kind,
                               fn_name, kwargs, envs[r], q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    results, errors = {}, []
    try:
        while len(results) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{fn_name}: {world - len(results)} of "
                                   f"{world} ranks did not finish in "
                                   f"{timeout} s")
            try:
                rank, status, out = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in
                        (None, 0)]
                if dead:
                    raise RuntimeError(f"{fn_name}: a rank exited with "
                                       f"{dead[0]} without a result")
                continue
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
        if errors:
            raise SelfCheckFailure(f"{fn_name} failed on "
                                   + "\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 0) if not errors
                   else 1)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5)
    return [results[r] for r in range(world)]


# -- rank-side checks ---------------------------------------------------------
def _device(kind: str) -> torch.device:
    return torch.device("cuda", 0) if kind == "cuda" else torch.device("cpu")


def check_row_sharded(rank, A, x, device_kind="cpu", rows=None,
                      batch=None) -> dict:
    """RowShardedMatrix in both layouts on a 1-D mesh over every rank (or
    ``rows`` × ``batch``): the replicated product, the rank's row block of
    the sharded product, and the rank's packing (its ELL tables)."""
    dev = _device(device_kind)
    mesh = (make_mesh(device=dev) if rows is None
            else make_mesh_2d(rows, batch, device=dev))
    ba = "cands" if batch else None
    out = {}
    for layout in ("coo", "ell"):
        M = RowShardedMatrix.from_scipy(A, mesh, batch_axis=ba,
                                        layout=layout)
        xt = torch.as_tensor(x, device=dev)
        out[layout, "matmul"] = M.matmul(xt).cpu().numpy()
        xp = torch.nn.functional.pad(xt, (0, 0, 0, M.n - xt.shape[0]))
        xl = xp[row_sharded(mesh, n=M.n)][:, M._col_block(x.shape[1])]
        out[layout, "sharded"] = M.spmm_sharded(xl).cpu().numpy()
        if layout == "ell":
            out["ell_cols"] = M.cols.cpu().numpy()
            out["ell_vals"] = M.vals.cpu().numpy()
        else:
            out["coo_todense"] = M.todense().cpu().numpy()
            out["coo_slots"] = tuple(t.cpu().numpy() for t in (
                M.rows_local, M.cols, M.vals[:M.nnz_shard]))
    out["row_block"] = row_sharded(mesh, n=M.n)
    out["col_block"] = M._col_block(x.shape[1])
    return out


def check_bsr_packing(rank, A, x, tile=(128, 128), dtype=torch.float64,
                      device_kind="cpu") -> dict:
    """BsrRowShardedMatrix with overlap on and off over every rank: the
    rank's packing arrays, its products, and a symmetric value edit."""
    dev = _device(device_kind)
    mesh = make_mesh(device=dev)
    out = {}
    for overlap in (True, False):
        S = BsrRowShardedMatrix.from_scipy(A, mesh, dtype=dtype, tile=tile,
                                           overlap=overlap)
        xt = torch.as_tensor(x, device=dev)
        out[overlap] = dict(
            atiles=S.atiles.double().cpu().numpy().copy(), slab=S.slab,
            sup=S.sup, start=S.start, entry_positions=S.entry_positions(),
            entry_rc=S.entry_rc(), n_diag=S.n_diag, m_pad=S.m_pad,
            n_pad=S.n_pad, n=S.n, mode=S.mode,
            entry_values=S.entry_values(),
            matmul=S.matmul(xt).cpu().numpy())
        rc, pos = S.entry_rc(), S.entry_positions()
        i, j = rc[3]
        sel = (((rc[:, 0] == i) & (rc[:, 1] == j))
               | ((rc[:, 0] == j) & (rc[:, 1] == i)))
        S.set_flat(pos[sel], 0.0)
        out[overlap]["edited"] = (int(i), int(j))
        out[overlap]["matmul_edited"] = S.matmul(xt).cpu().numpy()
    return out


def check_greedy(rank, A, c, cases, device_kind="cpu", rows=None,
                 batch=None) -> dict:
    """greedy_krylov on the sharded backends over every rank (1-D mesh, or
    ``rows`` × ``batch``, or the automatic mesh for rows=None and
    batch='auto') with centrality ``c``: for each (backend, mode, k, Q,
    fused_steps, dtype) of ``cases`` the picks, Δ, A_new and the
    operator."""
    from ..optimize.greedy import greedy_krylov

    dev = _device(device_kind)
    if batch == "auto":
        mesh = None
    elif rows is None:
        mesh = make_mesh(device=dev)
    else:
        mesh = make_mesh_2d(rows, batch, device=dev)
    out = {}
    for backend, mode, k, Q, fused, dtype in cases:
        r = greedy_krylov(A, k, Q, c, order="min", tol=1e-8, mode=mode,
                          dtype=dtype, backend=backend, mesh=mesh,
                          fused_steps=fused, device=dev)
        out[backend, mode, fused] = dict(
            edges=r.edges, rob_variation=r.rob_variation,
            A_new=sp.coo_matrix(r.A_new), operator=r.operator,
            fused_accepted=r.fused_accepted)
    return out


def check_psum_and_scaling(rank, device_kind="cpu", b=8, iters=3) -> dict:
    """psum_dot over every rank, and measure_sharded_spmm at D = 1 and at
    the world size, as rank 0 sees them."""
    from ..experiments.scaling import measure_sharded_spmm

    dev = _device(device_kind)
    mesh = make_mesh(device=dev)
    a = torch.arange(4, dtype=torch.float64, device=dev) + 4 * rank
    s = float(psum_dot(a, a, mesh.group("rows")))
    A = example_graph(200, seed=1)
    rates = measure_sharded_spmm(A, b=b, iters=iters, dtype=torch.float64,
                                 device=dev)
    return dict(psum=s, rates=rates, world=dist.get_world_size(),
                backend=dist.get_backend())


def check_env_init(rank) -> dict:
    """The process group that maybe_init_distributed joined from the
    torchrun-style variables, and psum_dot over it."""
    mesh = make_mesh(device="cpu")
    one = torch.ones(3, dtype=torch.float64)
    return dict(world=dist.get_world_size(), rank=dist.get_rank(),
                backend=dist.get_backend(),
                psum=float(psum_dot(one, one, mesh.group("rows"))))


def check_dryrun(rank, device_kind="cpu") -> dict:
    return dryrun(_device(device_kind))


# -- the weighted path on the row-sharded operator (CONFIG 5) ---------------
def check_sharded_funm(rank, A, X, omega, A_trace, edges,
                       device_kind="cpu") -> dict:
    """The host plan builders and the exp-family actions on the row-sharded
    COO operator of ``A`` over every rank: the Taylor plans at t = ±1 for
    X's width, ``expmv`` of X under each, ``entries_of_f_expmv`` (exp and
    sinh) at ``omega``, ``degree_centrality``; then
    ``trace_fun_update_edges`` (removal) of ``edges`` on the operator of
    ``A_trace``."""
    from ..funm.expmv import expmv, select_taylor_degree
    from ..graphs.centrality import degree_centrality
    from ..updates.entries import entries_of_f_expmv
    from ..updates.trace_update import trace_fun_update_edges

    dev = _device(device_kind)
    mesh = make_mesh(device=dev)
    M = RowShardedMatrix.from_scipy(A, mesh)
    xt = torch.as_tensor(X, device=dev)
    out = {"plans": {}, "expmv": {}, "entries": {}}
    for t in (1.0, -1.0):
        p = select_taylor_degree(M, t=t, b_cols=X.shape[1])
        out["plans"][t] = (p.m, p.s, p.mu)
        out["expmv"][t] = expmv(M, xt, t=t, plan=p).cpu().numpy()
    for fun in ("exp", "sinh"):
        out["entries"][fun] = entries_of_f_expmv(M, omega, fun=fun)[0] \
            .cpu().numpy()
    out["degree"] = degree_centrality(M).cpu().numpy()
    T = RowShardedMatrix.from_scipy(A_trace, mesh)
    out["delta"] = trace_fun_update_edges(T, edges, sign=-1.0, tol=1e-4) \
        .delta.cpu().numpy()
    return out


def check_config5_problem(rank, A, c, nrm, search_space, modifiable_edges,
                          maxiter, device_kind="cpu") -> dict:
    """The CONFIG 5 problem (rewire, sinh, expmv entries, ndense 0) at a
    small size on the row-sharded operator over every rank, with the
    centrality ``c`` and ‖A‖ ``nrm`` given: the search space, the
    optimizer's result, the exact Hessian at its x (a single-device copy of
    A + Δ on each rank), and two iterations with that Hessian."""
    from ..optimize.continuous import (
        build_problem,
        hessian,
        optimize_weights,
    )

    dev = _device(device_kind)
    M = RowShardedMatrix.from_scipy(A, make_mesh(device=dev))
    prob = build_problem(
        A, M, c, "rewire", fun="sinh", search_space=search_space,
        modifiable_edges=modifiable_edges, heur_order="min",
        total_weight=10.0, ndense=0, tol=1e-6 * float(np.sinh(nrm)),
        entries_method="expmv")
    kw = dict(fun="sinh", tol=1e-6, nrmA=nrm)
    res = optimize_weights(A, M, prob, maxiter=maxiter, **kw)
    res_h = optimize_weights(A, M, prob, maxiter=2, use_hessian=True, **kw)
    return dict(Omega=prob.Omega, dfA=prob.dfA, lb=prob.lb, ub=prob.ub,
                x=res.x, fval=res.fval, iterations=res.iterations,
                hessian=hessian(res.x, A, prob.Omega, fun="sinh", tol=1e-6,
                                device=dev),
                x_hessian=res_h.x, fval_hessian=res_h.fval)


def check_rank_agreement(rank) -> dict:
    """``same_on_every_rank`` over every rank on a value that differs
    between ranks (the error every rank raises) and on one that does not;
    ``from_first_rank`` of the rank's own number."""
    mesh = make_mesh(device="cpu")
    try:
        same_on_every_rank(mesh, "the rank", rank)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    same_on_every_rank(mesh, "a shared value", np.arange(4), 0.5)
    return dict(raised=raised, first=from_first_rank(mesh, lambda: rank))


def _launched(before: dict, kernels) -> dict:
    """Launches of each of ``kernels`` since the counters read ``before``."""
    now = tracing.counters()
    return {k: now.get(f"spmm.launches.{k}", 0)
            - before.get(f"spmm.launches.{k}", 0) for k in kernels}


def _evaluation_costs(M, prob, x, nrm, dev) -> dict:
    """One ``fun_and_grad`` at ``x`` (after a warm-up call) with every
    all-gather timed (synchronized before and after, so that it holds no
    product's kernels), then one under ``torch.profiler``: milliseconds,
    the all-gathers' share, and the device's busy share (the union of its
    events' intervals over the wall; None on the CPU)."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from ..optimize import continuous
    from . import spmm_sharded

    gathers = []
    gather = spmm_sharded._gather

    def timed(*args, **kwargs):
        _sync(dev)
        t = time.perf_counter()
        y = gather(*args, **kwargs)
        _sync(dev)
        gathers.append(time.perf_counter() - t)
        return y

    def call():
        _sync(dev)
        t = time.perf_counter()
        continuous.fun_and_grad(x, M, prob.Omega, prob.dfA, fun="sinh",
                                tol=1e-6, nrmA=nrm)
        _sync(dev)
        return time.perf_counter() - t

    call()
    with mock.patch.object(spmm_sharded, "_gather", timed):
        wall = call()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        wall_p = call()
    return dict(ms=wall * 1e3, gathers=len(gathers),
                gather_ms=sum(gathers) * 1e3,
                gather_share=sum(gathers) / wall,
                profiled_ms=wall_p * 1e3,
                busy_share=(tracing.device_busy_us(prof) / 1e6 / wall_p
                            if dev.type == "cuda" else None))


def run_config5(rank, dataset, out_dir, measure=False,
                device_kind="cpu") -> dict:
    """The CONFIG 5 driver as a user runs it (``config5.main``: ``dataset``
    from the data root, ``n_devices`` the world size, ``--cpu`` for
    ``device_kind='cpu'``) on every rank of the process group, recording
    each Taylor plan built (t, m, s, mu) and each objective evaluation (x,
    f, gradient, seconds). With ``measure``, the peak device memory of the
    run and :func:`_evaluation_costs` at its optimum."""
    from unittest import mock

    from ..experiments import config5
    from ..optimize import continuous
    from ..updates import entries

    dev = _device(device_kind)
    world = dist.get_world_size() if dist.is_initialized() else 1
    argv = [dataset, str(world), "--out-dir", str(out_dir)]
    argv += ["--cpu"] if dev.type == "cpu" else []
    plans, evals, kept = [], [], {}
    select, run = config5.select_taylor_degree, config5.run
    fun_and_grad = continuous.fun_and_grad

    def plan(A, t=1.0, **kwargs):
        p = select(A, t=t, **kwargs)
        plans.append((p.t, p.m, p.s, p.mu))
        return p

    def evaluation(x, *args, **kwargs):
        t = time.perf_counter()
        f, g = fun_and_grad(x, *args, **kwargs)
        evals.append((np.array(x), f, g, time.perf_counter() - t))
        return f, g

    def keep(*args, **kwargs):
        kept.update(run(*args, **kwargs))
        return kept

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with mock.patch.object(config5, "select_taylor_degree", plan), \
            mock.patch.object(entries, "select_taylor_degree", plan), \
            mock.patch.object(continuous, "fun_and_grad", evaluation), \
            mock.patch.object(config5, "run", keep):
        config5.main(argv)
    M, prob, res = kept["operator"], kept["problem"], kept["result"]
    got = dict(operator=type(M).__name__, world=M.mesh.shape["rows"],
               device=str(M.device), Omega=prob.Omega, dfA=prob.dfA,
               x=res.x, fval=res.fval, iterations=res.iterations,
               message=res.message, plans=plans, evals=evals,
               traces=kept["traces"], tr_sinh=kept["tr_sinh"],
               score=kept["score"], nrmA=kept["nrmA"],
               time_build=kept["time_build"], time_opt=kept["time_opt"])
    if measure:
        if dev.type == "cuda":
            got["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        got["costs"] = _evaluation_costs(M, prob, res.x, kept["nrmA"], dev)
    return got


def run_checks(rank, plan) -> dict:
    """Several checks of this module in one world: ``plan`` maps a name to
    (function name, keyword arguments); returns name → result."""
    return {name: globals()[fn](rank=rank, **kw)
            for name, (fn, kw) in plan.items()}


# -- the card's checks (chip_smoke.py's 2-rank phase) -------------------------
def _time_ms(fn, dev, reps: int = 5) -> float:
    """Median milliseconds of ``fn`` after one untimed call: CUDA events on
    the card, ``time.perf_counter`` on the CPU (a rehearsal there)."""
    fn()
    _sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _one_at_a_time(rank, dev, fn):
    """Run ``fn`` on each rank in turn (a barrier before and after each
    turn), so that ranks sharing one card time their work alone."""
    out = None
    for r in range(dist.get_world_size()):
        dist.barrier()
        if r == rank:
            out = fn()
            _sync(dev)
    dist.barrier()
    return out


def card_checks(rank, A, b, seed, gates, greedy_args,
                device_kind="cuda") -> dict:
    """On cuda:0, on a gloo world of ranks: BsrRowShardedMatrix in bf16x2
    (K1) and f64 (K2) with overlap on. One sharded-in / sharded-out product
    must launch the kernel twice (the diagonal pass on the local x, the off
    pass on the gathered x) and give the rank's row block of scipy's A·x;
    each pass is held against its plain version and timed (kernel, plain
    version, bound), one rank at a time; x (n, b) is drawn from ``seed``.
    Then RowShardedMatrix coo and ell against scipy, and greedy sharded_bsr
    break in f32 (``greedy_args``: k, Q, centrality, tol, shift), with its
    K1/K2 launch counts. With ``device_kind='cpu'`` it rehearses the same
    steps on the plain versions."""
    from ..bench import HBM_GBPS, speed_of_light_ms
    from ..optimize.greedy import greedy_krylov

    dev = _device(device_kind)
    mesh = make_mesh(device=dev)
    n = A.shape[0]
    x = np.random.default_rng(seed).standard_normal((n, b))
    out = {"products": {}, "errors": {}, "hbm_gbps": HBM_GBPS}
    for label, mode, dtype, kernel, unit in (
            ("bf16x2", "bf16x2", torch.float32, "K1", "ffma"),
            ("f64", "f32", torch.float64, "K2", "dfma")):
        S = BsrRowShardedMatrix.from_scipy(A, mesh, dtype=dtype, mode=mode)
        require(S.n_diag > 0, "the overlap split is off")
        xp = np.zeros((S.n, b))
        xp[:n] = x
        if dtype == torch.float32:
            xp = xp.astype(np.float32).astype(np.float64)
        rows = row_sharded(mesh, n=S.n)
        ref = np.zeros_like(xp)
        ref[:n] = A @ xp[:n]
        ref = ref[rows]
        scale = float(np.abs(ref).max())
        x_local = torch.as_tensor(xp[rows], device=dev).to(dtype)
        before = tracing.counters()
        y = S.spmm_sharded(x_local)
        _sync(dev)
        launched = _launched(before, (kernel,))[kernel]
        require(launched == (2 if dev.type == "cuda" else 0),
                f"rank {rank} {label}: the sharded product launched the "
                f"kernel {launched} times, not once per pass")
        err = float(np.abs(y.double().cpu().numpy() - ref).max()) / scale
        require(err <= gates[label], f"rank {rank} {label}: sharded "
                f"product error {err:.3e} over {gates[label]:.0e}")
        compute = torch.float32 if label == "bf16x2" else dtype
        xs = {"diag": x_local.to(compute).contiguous(),
              "off": torch.as_tensor(xp, device=dev).to(compute)
              .contiguous()}
        passes = {}
        for which, xw in xs.items():
            yk = S.local_pass(which, xw)
            yp = S.local_pass_plain(which, xw)
            diff = float((yk.double() - yp.double()).abs().max())
            require(diff <= gates[label] * scale, f"rank {rank} {label} "
                    f"{which} pass: kernel vs plain {diff / scale:.3e}")
            del yk, yp
            # the bound: the pass's entries as CSR, the x rows they read
            # (each once) and y written once, against 2·entries·b FMA flops
            cols = S._index[which][1]
            entries, x_read = int(cols.numel()), int(cols.unique().numel())
            m, size = S.rows_per_shard, xw.element_size()
            bound, bound_by = speed_of_light_ms(
                entries * (S.atiles.element_size() + 4) + (m + 1) * 4
                + (x_read + m) * b * size, 2.0 * entries * b, unit)
            timed = _one_at_a_time(rank, dev, lambda: (
                _time_ms(lambda: S.local_pass(which, xw), dev),
                _time_ms(lambda: S.local_pass_plain(which, xw), dev, 2)))
            passes[which] = dict(ms=timed[0], plain_ms=timed[1],
                                 max_abs_err=diff, bound_ms=bound,
                                 bound_by=bound_by, entries=entries,
                                 x_rows=xw.shape[0], x_read=x_read, y_rows=m)
        out["products"][label] = dict(
            err=err, launches=launched, passes=passes, rows=(rows.start,
                                                             rows.stop),
            # a collective: every rank at once
            sharded_ms=_time_ms(lambda: S.spmm_sharded(x_local), dev))
        del S, xs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for layout in ("coo", "ell"):
        M = RowShardedMatrix.from_scipy(A, mesh, dtype=torch.float64,
                                        layout=layout)
        xb = x[:, :8]
        y = M.matmul(torch.as_tensor(xb, device=dev)).cpu().numpy()
        ref = A @ xb
        err = float(np.abs(y - ref).max() / np.abs(ref).max())
        out["errors"][layout] = err
        require(err <= gates["f64"], f"rank {rank} {layout}: error {err:.3e}")
    k, Q, cent, tol, shift = greedy_args
    before = tracing.counters()
    t0 = time.perf_counter()
    r = greedy_krylov(A, k, Q, cent, order="min", tol=tol, mode="break",
                      dtype=torch.float32, backend="sharded_bsr",
                      shift=shift, mesh=mesh, fused_steps=0, device=dev)
    out["greedy"] = dict(edges=r.edges, rob_variation=r.rob_variation,
                         per_step_delta=r.per_step_delta,
                         per_step_time=r.per_step_time, operator=r.operator,
                         wall=time.perf_counter() - t0,
                         launches=_launched(before, ("K1", "K2")))
    return out
