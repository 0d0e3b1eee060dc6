"""The port's layers as the benchmark spans them: for each span label, the
functions and operator methods (``module:qualname``) it wraps; and the
reductions that more than one per-layer reader shares."""

from __future__ import annotations

from .roofline import least_time_s

P = "krylov_robustness_torch"
OPERATORS = (f"{P}.ops.sparse:CooMatrix", f"{P}.ops.sparse:EllMatrix",
             f"{P}.ops.bsr_super:SuperBsrOperator",
             f"{P}.ops.banded_spmm:BandedEllOperator",
             f"{P}.ops.bsr:BsrOperator",
             f"{P}.parallel.spmm_sharded:_RowSharded")

SPMM = {"spmm": [f"{op}.{m}" for op in OPERATORS
                 for m in ("__matmul__", "matmul")],
        "distributed": [f"{P}.parallel.spmm_sharded:_gather"]}
SWEEP = {"sweep": [f"{P}.optimize.greedy:greedy_krylov"]}
SCORER = {"scorer": [f"{P}.updates.trace_update:trace_fun_update_edges"]}
KRYLOV = {"krylov": [f"{P}.krylov.lanczos:lanczos_step"]}
SPECTRA = {"spectra": [f"{P}.ops.banded_eig:eigvalsh_banded",
                       f"{P}.updates.trace_update:_eigvals_banded_batch"]}
EVALUATION = {"evaluation": [f"{P}.optimize.continuous:fun_and_grad"]}
OPTIMIZER = {"optimizer": [f"{P}.optimize.continuous:optimize_weights"],
             "search_space": [f"{P}.optimize.continuous:build_problem"]}


def spmm_roofline_pct(trace):
    """Σ least time / Σ device time over the outermost operator products of
    the stretch, in %: the least time from each product's n, nnz, b and
    value type (``roofline.least_time_s``), the device time of all it
    launched less its nested all-gathers. None without a product."""
    if trace is None:
        return None
    times = trace.per_span_device_s("spmm", excluding=("distributed",))
    bound = spent = 0.0
    for k, t in times.items():
        n, nnz, b, vsize, xsize = map(int, trace.spans[k][1].split("|"))
        bound += least_time_s(n, nnz, b, vsize, xsize)[0]
        spent += t
    return 100.0 * bound / spent if spent > 0 else None


def device_idle_pct(trace):
    """The share of the traced window in which no kernel, copy or memset
    ran on the device (the union of their intervals), in %."""
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
