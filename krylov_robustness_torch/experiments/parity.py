"""Deterministic accuracy parity against the dense oracle — port of
``krylov_robustness_tpu/experiments/parity.py`` (north star: agreement
≤ ~1e-6 on the paper datasets).

1. ``expmv_parity`` — the expmv action is deterministic, so it is where the
   1e-6 north star is shown: max_j ‖expmv(A, e_j) − expm(A)·e_j‖₂ /
   ‖expm(A)·e_j‖₂ over unit vectors at the highest-degree nodes plus a dense
   Rademacher block, for every paper graph whose LCC has n ≤ dense_cutoff
   (oracle: scipy ``expm``; the reference computes the action in
   ``expmv.m:73-92``).
2. ``trace_exp_tight`` — the stochastic estimator (``trace_exp.m:5-6``) with
   its tolerance tightened to 1e-6, against the dense eigendecomposition.
3. ``trace_f32_lane`` — the σ-shifted f32 ``trace_exp`` lane beside the host
   f64 value on hub graphs; ``agree`` holds them within 3·tol.

The probes of the stochastic tables come from a torch ``Generator``, so their
traces differ from the JAX package's draws within the estimator's tol.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..funm.expmv import expmv
from ..funm.trace import trace_exp
from ..graphs.io import (
    MISC_PAPER_SET,
    TRANSPORT_PAPER_SET,
    load_misc,
    load_oregon,
    load_transport,
)
from ..graphs.preprocess import preprocess_unweighted
from ..ops.sparse import CooMatrix
from ..utils.device import resolve_device
from ..utils.logging import ResultLog
from .trace_bench import dataset_label, load_labeled

EXPMV_COLUMNS = ["dataset", "n", "nnz", "cols", "max_rel_err", "time"]
TRACE_COLUMNS = ["dataset", "n", "nnz", "tol", "trace", "rel_err_vs_dense",
                 "time"]
F32_LANE_COLUMNS = ["dataset", "n", "nnz", "platform", "sigma", "tol",
                    "trace_host_f64", "trace_f32_lane", "rel_diff", "agree"]


def _paper_graphs(dense_cutoff: int):
    """(label, loader) pairs for every paper graph + dt_oregon A0; the
    n-cutoff is applied after LCC preprocessing by the caller."""
    items = [("oregon-A0", lambda: load_oregon(0))]
    for name in MISC_PAPER_SET:
        items.append((name, lambda name=name: load_misc(name)))
    for name in TRANSPORT_PAPER_SET:
        items.append((name, lambda name=name: load_transport(name)))
    return items


def expmv_parity_row(label: str, A, n_unit: int = 8, n_rand: int = 4, *,
                     device) -> dict:
    """One row of the ``expmv_parity`` table for a preprocessed graph A:
    the f64 ``expmv`` action on ``device`` on n_unit unit vectors at the
    highest-degree nodes and n_rand seeded Rademacher columns, against scipy
    ``expm(A)`` applied to them."""
    import scipy.linalg

    n = A.shape[0]
    deg = np.asarray(A.sum(axis=1)).ravel()
    seeds = np.argsort(-deg)[:n_unit]
    B = np.zeros((n, n_unit + n_rand))
    B[seeds, np.arange(n_unit)] = 1.0
    rng = np.random.default_rng(0)
    B[:, n_unit:] = np.sign(rng.standard_normal((n, n_rand)))
    t0 = time.time()
    M = CooMatrix.from_scipy(A, dtype=torch.float64, device=device)
    got = expmv(M, torch.as_tensor(B, device=M.device)).cpu().numpy()
    dt = time.time() - t0
    want = scipy.linalg.expm(A.toarray()) @ B
    rel = float(np.max(np.linalg.norm(got - want, axis=0)
                       / np.linalg.norm(want, axis=0)))
    return dict(dataset=label, n=n, nnz=A.nnz, cols=B.shape[1],
                max_rel_err=rel, time=dt)


def run_expmv_parity(out_dir: str = "results", dense_cutoff: int = 2500,
                     n_unit: int = 8, n_rand: int = 4, verbose=True, *,
                     device):
    """The golden expmv-action parity table."""
    log = ResultLog(out_dir, "expmv_parity", columns=EXPMV_COLUMNS,
                    key=("dataset",))
    out = {}
    for label, loader in _paper_graphs(dense_cutoff):
        if log.has(dataset=label):
            continue
        A = preprocess_unweighted(loader())
        n = A.shape[0]
        if n > dense_cutoff:
            if verbose:
                print(f"{label:16s} n={n:6d} skipped (n > {dense_cutoff})")
            continue
        row = expmv_parity_row(label, A, n_unit, n_rand, device=device)
        log.append(**row)
        out[label] = row["max_rel_err"]
        if verbose:
            print(f"{label:16s} n={n:6d} cols={row['cols']} "
                  f"max_rel_err={row['max_rel_err']:.2e} "
                  f"[{row['time']:5.1f}s]")
    return out, log


def run_trace_f32_lane(datasets=("as_735", "ca-CondMat"),
                       out_dir: str = "results", tol: float = 1e-4,
                       verbose=True, *, device):
    """The σ-shifted f32 ``trace_exp`` lane on ``device`` next to the
    certified host f64 value on the hub graphs that once broke it; both in
    e^{-σ} units, ``agree`` when within 3·tol (``trace_exp.m:5-6``)."""
    from ..funm.normest import normest2_host
    from ..funm.trace import trace_exp_host

    dev = resolve_device(device)
    log = ResultLog(out_dir, "trace_f32_lane", columns=F32_LANE_COLUMNS,
                    key=("dataset",))
    out = {}
    for name in datasets:
        A = preprocess_unweighted(load_misc(name))
        sigma = float(normest2_host(A, tol=1e-2))
        host = trace_exp_host(A, tol=tol, sigma=sigma)
        M = CooMatrix.from_scipy(A, dtype=torch.float32, device=dev)
        t0 = time.time()
        lane = float(trace_exp(M, tol=tol, sigma=sigma))
        dt = time.time() - t0
        rel = abs(lane - host) / abs(host)
        agree = rel < 3 * tol
        log.append(dataset=name, n=A.shape[0], nnz=A.nnz, platform=dev.type,
                   sigma=sigma, tol=tol, trace_host_f64=host,
                   trace_f32_lane=lane, rel_diff=rel, agree=agree)
        out[name] = rel
        if verbose:
            print(f"{name:12s} sigma={sigma:.2f} host_f64={host:.6e} "
                  f"f32_lane={lane:.6e} rel_diff={rel:.2e} "
                  f"agree={agree} [{dt:.1f}s]")
    return out, log


def run_trace_tight(datasets=None, out_dir: str = "results",
                    tol: float = 1e-6, maxit: int = 10000, verbose=True, *,
                    device):
    """trace(exp(A)) in f64 on ``device`` with the stochastic tolerance
    tightened to the north-star 1e-6, against the dense
    eigendecomposition."""
    if datasets is None:
        datasets = [
            ("oregon", 0), ("transport", "Anaheim"),
            ("transport", "Barcelona"), ("misc", "london"),
            ("misc", "netscience"), ("misc", "Edinburgh"),
        ]
    log = ResultLog(out_dir, "trace_exp_tight", columns=TRACE_COLUMNS,
                    key=("dataset",))
    out = {}
    for coll, name in datasets:
        label = dataset_label(coll, name)
        if log.has(dataset=label):
            continue
        A = preprocess_unweighted(load_labeled(coll, name)[1])
        M = CooMatrix.from_scipy(A, dtype=torch.float64, device=device)
        t0 = time.time()
        tr = float(trace_exp(M, tol=tol, maxit=maxit))
        dt = time.time() - t0
        dense = float(np.sum(np.exp(np.linalg.eigvalsh(A.toarray()))))
        rel = abs(tr - dense) / dense
        log.append(dataset=label, n=A.shape[0], nnz=A.nnz, tol=tol, trace=tr,
                   rel_err_vs_dense=rel, time=dt)
        out[label] = rel
        if verbose:
            print(f"{label:16s} n={A.shape[0]:6d} trace={tr:.8e} "
                  f"rel_err={rel:.2e} [{dt:6.1f}s]")
    return out, log
