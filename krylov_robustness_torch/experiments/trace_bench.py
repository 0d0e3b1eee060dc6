"""trace(exp(A)) wall-time benchmark across the paper datasets — port of
``krylov_robustness_tpu/experiments/trace_bench.py``.

Per dataset: preprocess, run ``trace_exp`` (its expmv plan built once) on
``device``, record the wall time and, where the dense oracle is feasible
(n ≤ ``dense_cutoff``), the relative error against the eigendecomposition.
The estimator is Monte-Carlo: its probes come from a torch ``Generator``
(seed 0), so the traces differ from the JAX package's draws within ``tol``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..funm.trace import trace_exp
from ..graphs.io import load_misc, load_oregon, load_transport
from ..graphs.preprocess import preprocess_unweighted
from ..ops.sparse import CooMatrix
from ..utils.logging import ResultLog

TRACE_COLUMNS = ["dataset", "n", "nnz", "time", "trace", "rel_err_vs_dense"]

DEFAULT_DATASETS = (
    ("oregon", 0), ("transport", "Anaheim"), ("transport", "Rome"),
    ("transport", "Barcelona"), ("misc", "jazz"), ("misc", "USAir97"),
    ("misc", "london"),
)


def dataset_label(coll: str, name) -> str:
    """The benches' label of one dataset of a collection ('oregon',
    'transport' or 'misc')."""
    return f"oregon-A{name}" if coll == "oregon" else str(name)


def load_labeled(coll: str, name):
    """(label, adjacency) of one dataset of a collection."""
    loader = {"oregon": load_oregon, "transport": load_transport,
              "misc": load_misc}[coll]
    return dataset_label(coll, name), loader(name)


def run(datasets=None, out_dir: str = "results", dtype=torch.float64,
        dense_cutoff: int = 2500, tol: float = 1e-4, verbose=True, *,
        device):
    """One ``trace_exp`` row per (collection, name) of ``datasets`` in the
    ``trace_exp`` table (keyed by dataset). Returns ({label: (trace, seconds,
    rel_err)}, log)."""
    log = ResultLog(out_dir, "trace_exp", columns=TRACE_COLUMNS,
                    key=("dataset",))
    out = {}
    for coll, name in (DEFAULT_DATASETS if datasets is None else datasets):
        label, A = load_labeled(coll, name)
        A = preprocess_unweighted(A)
        M = CooMatrix.from_scipy(A, dtype=dtype, device=device)
        t0 = time.time()
        tr = trace_exp(M, tol=tol)
        dt = time.time() - t0
        if A.shape[0] <= dense_cutoff:
            dense = float(np.sum(np.exp(np.linalg.eigvalsh(A.toarray()))))
            rel = abs(tr - dense) / dense
            rel_str = f"{rel:.2e}"
        else:
            # no silent nan: the dense oracle is intentionally not computed
            rel = rel_str = "skipped(n>cutoff)"
        log.append(dataset=label, n=A.shape[0], nnz=A.nnz, time=dt,
                   trace=tr, rel_err_vs_dense=rel)
        if verbose:
            print(f"{label:14s} n={A.shape[0]:6d} trace={tr:.6e} "
                  f"[{dt:6.2f}s] rel_err={rel_str}")
        out[label] = (tr, dt, rel)
    return out, log
