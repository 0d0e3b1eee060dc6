"""CONFIG 5 (BASELINE.json): weighted rewiring of trace(sinh(A)) via
interior-point with Krylov gradient on the largest paper network, the
operator row-partitioned over the ranks — port of
``scripts/config5_sharded_sinh_rewire.py``.

Usage::

    python -m krylov_robustness_torch.experiments.config5 [dataset] [n_devices]
        [--cpu] [--out-dir DIR]
    torchrun --nproc-per-node 2 -m krylov_robustness_torch.experiments.config5 \\
        Vermont 2

One process a rank: a world of one without a launcher, else the world that
``torchrun`` describes (``parallel/mesh.py::maybe_init_distributed``: NCCL on
the card of ``LOCAL_RANK``); ``n_devices`` (default: the world size) must
equal the world size. It runs on the card unless given ``--cpu`` and raises
on a machine without CUDA; in float64 on either, as the JAX script runs with
x64. The dataset is read from ``$KRYLOV_ROBUSTNESS_DATA``
(``Transport/<dataset>.mat``). Problem, optimizer and score normalizer are
the script's: search space 30, 10 modifiable edges, expmv entries, maxiter
50, and trace(sinh(A)) as two Hutchinson runs over ``expmv`` at t = ±1 on the
same sharded operator, each drawing its probes from a generator seeded alike
on every rank. ‖A‖ and the centrality (ARPACK; the JAX package's start
vector is random in each process) are computed on the first rank and
broadcast, so every rank holds the same values. Only rank 0 prints and writes the result row (``ResultLog`` under
``--out-dir``, the script's columns).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from ..funm.expmv import expmv, select_taylor_degree
from ..funm.normest import normest2_host
from ..funm.trace import mc_trace
from ..graphs.centrality import compute_centrality_host
from ..optimize.continuous import build_problem, optimize_weights
from ..parallel.mesh import (
    from_first_rank,
    make_mesh,
    maybe_init_distributed,
    same_on_every_rank,
)
from ..parallel.spmm_sharded import RowShardedMatrix
from ..utils.logging import ResultLog

CONFIG5_COLUMNS = ["dataset", "n", "n_devices", "method", "fun", "score_pct",
                   "iterations", "time_build", "time_opt"]


def run(A, dataset: str, *, device, n_devices: int | None = None,
        out_dir="results") -> dict:
    """The script's protocol on the preprocessed graph ``A`` (scipy), row-
    sharded over every rank of the process group (one rank without one).
    Returns the operator, the problem, the optimizer's result, the Hutchinson
    traces and plans, the score and the build and optimize seconds."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_dev = world if n_devices is None else n_devices
    if n_dev != world:
        raise ValueError(f"n_devices = {n_dev}, but the world has {world} "
                         f"ranks (one rank a device)")
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    n = A.shape[0]
    mesh = make_mesh(n_dev, device=device)
    M = RowShardedMatrix.from_scipy(A, mesh, dtype=torch.float64)
    say(f"{dataset}: n={n} nnz={A.nnz} mesh={tuple(mesh.shape.items())}",
        flush=True)

    nrmA, centrality = from_first_rank(mesh, lambda: (
        float(normest2_host(A, tol=1e-2)), compute_centrality_host(A, "eig")))
    t0 = time.perf_counter()
    # the script's search-space sizes (power-grid protocol 100/30 scaled
    # down: n is 30-100x the largest grid)
    prob = build_problem(
        A, M, centrality, "rewire", fun="sinh", search_space=30,
        modifiable_edges=10, heur_order="min", total_weight=10.0, ndense=0,
        tol=1e-6 * float(np.sinh(nrmA)), entries_method="expmv")
    t_build = time.perf_counter() - t0
    say(f"search space built in {t_build:.1f}s ({len(prob.Omega)} "
        f"modifiable edges)", flush=True)

    t0 = time.perf_counter()
    res = optimize_weights(A, M, prob, fun="sinh", tol=1e-6,
                           use_hessian=False, maxiter=50, nrmA=nrmA)
    t_opt = time.perf_counter() - t0

    # score normalizer: trace(sinh(A)) = (tr exp(A) − tr exp(−A))/2 by
    # Hutchinson over expmv actions on the same sharded operator
    plans = [select_taylor_degree(M, t=t, b_cols=10) for t in (1.0, -1.0)]
    traces = [mc_trace(lambda x, p=p: expmv(M, x, t=p.t, plan=p), n,
                       tol=1e-3, maxit=1000, dtype=M.dtype,
                       generator=torch.Generator().manual_seed(0),
                       device=device)[0] for p in plans]
    same_on_every_rank(mesh, "the Hutchinson traces", traces)
    tr_sinh = (traces[0] - traces[1]) / 2
    score = -res.fval / tr_sinh

    if rank0:
        log = ResultLog(out_dir, "config5_sharded_sinh_rewire",
                        columns=CONFIG5_COLUMNS)
        log.append(dataset=dataset, n=n, n_devices=n_dev, method="rewire",
                   fun="sinh", score_pct=score * 100,
                   iterations=res.iterations, time_build=t_build,
                   time_opt=t_opt)
    say(f"rewire sinh: score={score * 100:.3f}%  it={res.iterations} "
        f"opt={t_opt:.1f}s  ({res.message})", flush=True)
    return dict(operator=M, problem=prob, result=res, nrmA=nrmA,
                plans=plans, traces=traces, tr_sinh=tr_sinh, score=score,
                time_build=t_build, time_opt=t_opt)


def main(argv=None) -> int:
    from ..graphs.io import load_transport
    from ..graphs.preprocess import preprocess_unweighted
    from .__main__ import _setup_device

    p = argparse.ArgumentParser(
        prog="krylov_robustness_torch.experiments.config5")
    p.add_argument("dataset", nargs="?", default="Vermont")
    p.add_argument("n_devices", nargs="?", type=int, default=None,
                   help="ranks of the row partition (default: the world "
                   "size, which it must equal)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--out-dir", default="results")
    args = p.parse_args(argv)
    joined = not dist.is_initialized()
    # before the device is chosen: under torchrun each rank takes the card
    # of its LOCAL_RANK
    maybe_init_distributed()
    joined = joined and dist.is_initialized()
    try:
        dev, _ = _setup_device(args.cpu)
        A = preprocess_unweighted(load_transport(args.dataset))
        run(A, args.dataset, device=dev, n_devices=args.n_devices,
            out_dir=args.out_dir)
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
