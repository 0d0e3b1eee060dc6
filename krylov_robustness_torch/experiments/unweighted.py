"""Unweighted break/make experiment drivers — port of
``krylov_robustness_tpu/experiments/unweighted.py``.

Reproduce the protocol of ``Tests/test_unweighted_break.m`` /
``test_unweighted_make.m`` (paper §5.1-5.2, Tables 2-3) and the budget
sweeps (``test_unweighted_*_budget.m``, Figures 1-4): per dataset —
preprocess, estimate exp(‖A‖) and trace(exp(A)), eig centrality, run
GREEDY_KRYLOV, MIOBI (rescored through trace_fun_update), EIGENV (rescored),
record edge-pick intersections, stream CSV/JSONL rows with the reference's
exact column schema.

On a CUDA device the normalizers and the centrality take the host f64 lanes
(``normest2_host``, ``trace_exp_host``, ``compute_centrality_host``), as the
JAX package does on the TPU, and the rows carry ``norm_lane='host-f64'``: a
handful of scalars whose device evaluation in f32 would cost more than it
saves and put f32 error into every row's normalizer. On the CPU the device
lanes run, as JAX on the CPU does.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..baselines.eigenv import eigenv_edges
from ..baselines.miobi import miobi_break, miobi_make
from ..funm.normest import normest2, normest2_host
from ..funm.trace import trace_exp, trace_exp_host
from ..graphs.centrality import compute_centrality, compute_centrality_host
from ..graphs.io import (
    MISC_PAPER_SET,
    TRANSPORT_PAPER_SET,
    load_misc,
    load_transport,
)
from ..graphs.preprocess import preprocess_unweighted
from ..ops.sparse import CooMatrix
from ..optimize.greedy import greedy_krylov
from ..updates.low_rank import edge2low_rank
from ..updates.trace_update import trace_fun_update_batched
from ..utils.config import UnweightedConfig
from ..utils.device import float_dtype, resolve_device
from ..utils.logging import ResultLog, Timer


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _release(dev: torch.device) -> None:
    """Hand cached device blocks back between datasets (their shapes never
    recur)."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _normalizers(A, M, dtype, dev, hub_shift: bool):
    """(lognrm, sigma, trexp, norm_lane) of the protocol: the host f64 lanes
    on CUDA, the device lanes otherwise. With ``hub_shift``, hub graphs
    score trace(exp(A−σI)) with σ = ‖A‖: in f32, exp(λmax) overflows above
    ~88 and norms of O(exp(λmax)) vectors above ~44 (tr_variation = Δ/trexp
    is σ-invariant)."""
    on_cuda = dev.type == "cuda"
    lognrm = float(normest2_host(A, tol=1e-2) if on_cuda
                   else normest2(M, tol=1e-2))
    f32 = dtype == torch.float32
    sigma = lognrm if hub_shift and ((f32 and lognrm > 20.0)
                                     or lognrm > 600.0) else 0.0
    if on_cuda:
        return lognrm, sigma, trace_exp_host(A, sigma=sigma), "host-f64"
    return (lognrm, sigma, trace_exp(M, sigma=sigma),
            f"device-{_dtype_name(dtype)}")


def _centrality(A, M, kind: str, dev) -> np.ndarray:
    return compute_centrality_host(A, kind) if dev.type == "cuda" \
        else compute_centrality(M, kind)


def rescore_edges(M, edges: np.ndarray, sign: float, tol: float,
                  shift: float = 0.0) -> float:
    """Uniform re-scoring of a joint edge edit through trace_fun_update —
    the cross-method evaluator invariant (``test_unweighted_break.m:93-95``).
    The block size is the number of distinct nodes the edges touch."""
    U, B, _ = edge2low_rank(edges, M.n, sign=sign)
    res = trace_fun_update_batched(
        M, torch.as_tensor(U, device=M.device).to(M.dtype)[None],
        torch.as_tensor(B, device=M.device).to(M.dtype)[None], tol=tol,
        shift=shift)
    return float(res.delta[0])


def _intersections(gkb: np.ndarray, miobi: np.ndarray, eigenv: np.ndarray):
    def rows(E):
        return {tuple(sorted(map(int, e))) for e in E}

    a, b, c = rows(gkb), rows(miobi), rows(eigenv)
    return [len(a & b), len(a & c), len(b & c), len(a & b & c)]


def gkb_method_label(cfg: UnweightedConfig, gkb_only: bool = False) -> str:
    """Method label for the GKB rows. GKB-only reruns at non-default search
    spaces get a ``_Q{Q}`` suffix (and non-'min' orders an ``_{order}``
    suffix), so they land as distinct rows next to the Q=250 paper-protocol
    rows instead of overwriting them."""
    base = f"GREEDY_KRYLOV_{cfg.mode.upper()}"
    if not gkb_only:
        return base
    if cfg.Q != 250:
        base += f"_Q{cfg.Q}"
    if cfg.order != "min":
        base += f"_{cfg.order}"
    return base


def run_dataset(A_raw, name: str, cfg: UnweightedConfig, log: ResultLog,
                dtype=torch.float64, checkpoint=None, verbose=True,
                inter_log: ResultLog | None = None, gkb_only: bool = False,
                *, device):
    """One dataset of the Tables 2-3 protocol on ``device``."""
    dev = resolve_device(device)
    dtype = float_dtype(dtype)
    A = preprocess_unweighted(A_raw)
    n = A.shape[0]
    m = A.nnz // 2
    M = CooMatrix.from_scipy(A, dtype=dtype, device=dev)
    lognrm, sigma, trexp, norm_lane = _normalizers(A, M, dtype, dev,
                                                   hub_shift=True)
    nrm = float(np.exp(min(lognrm, 709.0)))
    # units tag (JSONL-only; the CSV keeps the reference schema): rows of one
    # dataset are unit-consistent iff they share trexp
    units = dict(norm_lane=norm_lane, sigma=sigma, trexp=trexp)
    timer = Timer()
    centrality = _centrality(A, M, cfg.centrality, dev)
    time_centrality = timer.lap()
    tol_abs = cfg.tol * float(np.exp(lognrm - sigma))
    sign = -1.0 if cfg.mode == "break" else +1.0
    if verbose:
        shift_note = f" shift={sigma:.1f}" if sigma else ""
        print(f"Dataset: {name}\t n: {n}\t budget: {cfg.k}\t "
              f"||exp(A)||=e^{lognrm:.1f}{shift_note}")

    # ---- GREEDY_KRYLOV ---------------------------------------------------
    Q = min(m - cfg.k, cfg.Q) if cfg.mode == "break" else cfg.Q
    timer.lap()
    res = greedy_krylov(
        A, cfg.k, Q, centrality, order=cfg.order, tol=tol_abs,
        mode=cfg.mode, dtype=dtype, checkpoint=checkpoint, dataset=name,
        shift=sigma, rescore_every=cfg.rescore_every,
        rescore_frac=cfg.rescore_frac, fused_steps=cfg.fused_steps,
        device=dev)
    t_gkb = timer.lap() + time_centrality
    log.append(
        method=gkb_method_label(cfg, gkb_only), dataset=name, n=n, m=m,
        searchspace_size=Q + cfg.k, centrality_order=cfg.order, time=t_gkb,
        tr_variation=res.rob_variation / trexp, budget_size=cfg.k, **units)
    if gkb_only:
        if verbose:
            print(f"  {gkb_method_label(cfg, gkb_only)}="
                  f"{res.rob_variation / trexp:.4e}")
        return {"greedy": res, "trexp": trexp, "nrm": nrm}

    # ---- MIOBI (rescored) --------------------------------------------------
    timer.lap()
    if cfg.mode == "break":
        mi = miobi_break(A, cfg.k, topT=cfg.miobi_eigs)
    else:
        mi = miobi_make(A, cfg.k, topT=cfg.miobi_eigs)
    delta_miobi = rescore_edges(M, mi.edges, sign, tol_abs, shift=sigma)
    t_miobi = timer.lap() + time_centrality
    log.append(
        method="MIOBI", dataset=name, n=n, m=m, searchspace_size=m,
        centrality_order="--", time=t_miobi,
        tr_variation=delta_miobi / trexp, budget_size=cfg.k, **units)

    # ---- EIGENV (rescored) --------------------------------------------------
    timer.lap()
    ev = eigenv_edges(A, centrality, cfg.k, mode=cfg.mode)
    delta_ev = rescore_edges(M, ev, sign, tol_abs, shift=sigma)
    t_ev = timer.lap() + time_centrality
    log.append(
        method="EIGENV", dataset=name, n=n, m=m, searchspace_size=cfg.k,
        centrality_order="mult", time=t_ev,
        tr_variation=delta_ev / trexp, budget_size=cfg.k, **units)

    inter = _intersections(res.edges, mi.edges, ev)
    if inter_log is not None:
        # separate intersections table (the reference's dlmwrite .dat,
        # test_unweighted_break.m:157)
        inter_log.append(dataset=name, gkb_miobi=inter[0],
                         gkb_eigenv=inter[1], miobi_eigenv=inter[2],
                         all_three=inter[3], budget_size=cfg.k)
    if verbose:
        print(f"  GKB={res.rob_variation / trexp:.4e} "
              f"MIOBI={delta_miobi / trexp:.4e} "
              f"EIGENV={delta_ev / trexp:.4e} common: {inter}")
    return {
        "greedy": res, "miobi": mi, "eigenv_edges": ev,
        "intersections": inter, "trexp": trexp, "nrm": nrm,
    }


def _misc_path_exists(name: str) -> bool:
    from ..graphs.io import misc_path

    try:
        return misc_path(name).exists()
    except FileNotFoundError:
        return False


def run_paper_suite(cfg: UnweightedConfig | None = None,
                    out_dir: str = "results", collections=("misc", "transport"),
                    datasets: list[str] | None = None, dtype=torch.float64,
                    gkb_only: bool = False, force: bool = False, *, device):
    """Full Table-2/3 protocol over the paper's 22 unweighted graphs.
    ``force=True`` bypasses the completed-row resume skip so an existing row
    is regenerated in place (keyed replace)."""
    from ..utils.checkpoint import GreedyCheckpoint

    dev = resolve_device(device)
    cfg = cfg or UnweightedConfig()
    log = ResultLog(out_dir, f"unweighted_{cfg.mode}",
                    key=("method", "dataset"))
    inter_log = ResultLog(
        out_dir, f"unweighted_{cfg.mode}_intersections",
        columns=["dataset", "gkb_miobi", "gkb_eigenv", "miobi_eigenv",
                 "all_three", "budget_size"],
        key=("dataset", "budget_size"))
    results = {}
    names = []
    if datasets is not None:
        # route each named dataset through the right loader (misc first,
        # then transport — the CLI contract)
        names = [("misc" if d in MISC_PAPER_SET or _misc_path_exists(d)
                  else "transport", d) for d in datasets]
    else:
        if "misc" in collections:
            names += [("misc", d) for d in MISC_PAPER_SET]
        if "transport" in collections:
            names += [("transport", d) for d in TRANSPORT_PAPER_SET]
    ckpt_dir = Path(out_dir) / "checkpoints"
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    for coll, name in names:
        # resume check: EIGENV is logged last in full runs; gkb-only runs
        # complete once their (Q-suffixed) GKB row exists
        done_marker = gkb_method_label(cfg, gkb_only) if gkb_only else "EIGENV"
        if not force and log.has(method=done_marker, dataset=name):
            continue
        A = load_misc(name) if coll == "misc" else load_transport(name)
        # per-step greedy state survives a killed run; variant runs
        # (large-Q / non-default order) checkpoint separately
        q_tag = gkb_method_label(cfg, gkb_only).removeprefix(
            f"GREEDY_KRYLOV_{cfg.mode.upper()}")
        ckpt = GreedyCheckpoint(
            ckpt_dir / f"greedy_{cfg.mode}_{name}{q_tag}.json",
            fingerprint={"mode": cfg.mode, "k": cfg.k, "Q": cfg.Q,
                         "tol": cfg.tol, "order": cfg.order,
                         "dtype": _dtype_name(dtype),
                         # scoring-units version: v2 = spectral-shift scoring
                         "score_ver": 2})
        results[name] = run_dataset(A, name, cfg, log, dtype=dtype,
                                    inter_log=inter_log, checkpoint=ckpt,
                                    gkb_only=gkb_only, device=dev)
        _release(dev)
    return results, log


def run_budget_sweep(names: list[str], budgets, search_spaces,
                     mode: str = "break", tol: float = 1e-6,
                     out_dir: str = "results", dtype=torch.float64,
                     force: bool = False, *, device):
    """Budget sweep protocol (``test_unweighted_break_budget.m``): one
    k=max(budgets) greedy run per (dataset, Q), whose prefixes give every
    budget — the greedy sequence for budget k is the first k steps of the
    budget-100 sequence."""
    dev = resolve_device(device)
    dtype = float_dtype(dtype)
    log = ResultLog(out_dir, f"unweighted_{mode}_budget",
                    key=("method", "dataset", "searchspace_size",
                         "budget_size"))
    method = f"GREEDY_KRYLOV_{mode.upper()}"
    kmax = max(budgets)
    out = {}
    for name in names:
        A = preprocess_unweighted(load_transport(name))
        if not force and all(
                log.has(method=method, dataset=name,
                        searchspace_size=min(A.nnz // 2 - kmax, Q) + kmax,
                        budget_size=kmax) for Q in search_spaces):
            continue  # resumed: all sweeps for this dataset already logged
        M = CooMatrix.from_scipy(A, dtype=dtype, device=dev)
        lognrm, _, trexp, norm_lane = _normalizers(A, M, dtype, dev,
                                                   hub_shift=False)
        nrm = float(np.exp(lognrm))
        t_cent = time.perf_counter()
        centrality = _centrality(A, M, "eig", dev)
        t_cent = time.perf_counter() - t_cent
        units = dict(norm_lane=norm_lane, sigma=0.0, trexp=trexp)
        for Q in search_spaces:
            Qe = min(A.nnz // 2 - kmax, Q)
            if not force and log.has(method=method, dataset=name,
                                     searchspace_size=Qe + kmax,
                                     budget_size=kmax):
                continue  # resumed: this (dataset, Q) sweep already logged
            res = greedy_krylov(
                A, kmax, Qe, centrality, order="min", tol=tol * nrm,
                mode=mode, dtype=dtype,
                fused_steps=10 if dtype == torch.float32 else 0, device=dev)
            cum = np.cumsum(res.per_step_delta)
            # per-budget wall time = centrality + the first k greedy steps
            # (the reference reruns greedy per budget and times each run)
            cum_t = np.cumsum(res.per_step_time)
            for k in budgets:
                log.append(
                    method=method, dataset=name, n=A.shape[0],
                    m=A.nnz // 2, searchspace_size=Qe + kmax,
                    centrality_order="min", time=float(t_cent + cum_t[k - 1]),
                    tr_variation=float(cum[k - 1]) / trexp, budget_size=k,
                    **units)
            out[(name, Q)] = res
        _release(dev)
    return out, log
