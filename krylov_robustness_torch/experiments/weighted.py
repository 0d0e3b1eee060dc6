"""Weighted continuous experiment drivers (paper §6, Tables 5-6) — port of
``krylov_robustness_tpu/experiments/weighted.py``.

Reproduce the protocol of ``Tests/test_weighted_{exp,sinh,cosh}_{lbfgs,hessian}.m``:
10 power-grid countries, A normalized to max 1, exact trace via dense eig,
search-space construction, then tuning/rewire/add interior-point runs.
Scores are reported as −fval/trace(f(A)) like the reference
(``test_weighted_exp_lbfgs.m:201-210``). The operator is a ``CooMatrix`` of
the run's dtype on its device; trace(f(A)) is a host f64 value.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..funm.normest import normest2
from ..funm.scalar import get_fun, value_at
from ..graphs.centrality import compute_centrality
from ..graphs.io import POWERGRID_PAPER_SET_INDICES, load_power_grids
from ..graphs.preprocess import preprocess_weighted
from ..ops.sparse import CooMatrix
from ..optimize.continuous import build_problem, optimize_weights
from ..utils.config import WeightedConfig
from ..utils.device import resolve_device
from ..utils.logging import ResultLog, Timer

WEIGHTED_COLUMNS = [
    "dataset", "n", "method", "fun", "hessian", "score_pct", "iterations",
    "time",
]


def paper_countries() -> list[str]:
    grids = load_power_grids()
    names = list(grids.keys())
    return [names[i - 1] for i in POWERGRID_PAPER_SET_INDICES]


def run_country(A_dense: np.ndarray, name: str, cfg: WeightedConfig,
                log: ResultLog, dtype=torch.float64, verbose=True, *,
                device):
    fun = get_fun(cfg.fun)
    Ad = preprocess_weighted(A_dense)
    n = Ad.shape[0]
    A = sp.csr_matrix(Ad)
    M = CooMatrix.from_scipy(A, dtype=dtype, device=device)
    w = np.linalg.eigvalsh(Ad)
    tr_f = float(fun.fn(torch.from_numpy(w)).sum())
    nrmA = float(normest2(M, tol=1e-2))
    tol = cfg.tol_param * value_at(fun, nrmA)
    centrality = compute_centrality(M, "eig")
    out = {}
    for method in cfg.methods:
        if log.has(dataset=name, method=method):
            if verbose:
                print(f"{n}\t{name}\t{method}\t(resumed: row exists, skipping)")
            continue
        timer = Timer()
        prob = build_problem(
            A, M, centrality, method, fun=cfg.fun,
            search_space=cfg.search_space,
            modifiable_edges=cfg.modifiable_edges,
            heur_order=cfg.heur_method, total_weight=cfg.total_weight,
            ndense=cfg.ndense, tol=tol,
        )
        res = optimize_weights(
            A, M, prob, fun=cfg.fun, tol=cfg.tol_param,
            use_hessian=cfg.use_hessian, maxiter=cfg.maxiter, nrmA=nrmA,
        )
        t = timer.lap()
        score = -res.fval / tr_f
        log.append(
            dataset=name, n=n, method=method, fun=cfg.fun,
            hessian=cfg.use_hessian, score_pct=score * 100,
            iterations=res.iterations, time=t,
        )
        if verbose:
            print(
                f"{n}\t{name}\t{method}\t{score * 100:.2f}%\t{t:.2f}s "
                f"It: {res.iterations}"
            )
        out[method] = res
    return out


def run_paper_suite(cfg: WeightedConfig | None = None,
                    out_dir: str = "results",
                    countries: list[str] | None = None, dtype=torch.float64,
                    *, device):
    cfg = cfg or WeightedConfig()
    dev = resolve_device(device)
    tag = f"weighted_{cfg.fun}_{'hessian' if cfg.use_hessian else 'lbfgs'}"
    log = ResultLog(out_dir, tag, columns=WEIGHTED_COLUMNS,
                    key=("dataset", "method"))
    grids = load_power_grids()
    names = countries or paper_countries()
    results = {}
    for name in names:
        results[name] = run_country(grids[name], name, cfg, log, dtype=dtype,
                                    device=dev)
        if dev.type == "cuda":
            # every country is a new n: hand the cached blocks back
            torch.cuda.empty_cache()
    return results, log
