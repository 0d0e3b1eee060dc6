"""Share of the window's sparse products that ran on COO (gather and
``index_add_`` in torch, no hand-written kernel), in %: 100 ·
Δ``spmm.launches.coo`` / (Δ``spmm.launches.coo`` + Σ Δ``spmm.launches.K1``
… ``K4``), the program's counters over the window. A program that does not
count its COO products, or a window without a product, reads nothing.
Layer: SpMM (``ops/sparse.py``; the operator is chosen in
``optimize/greedy.py::choose_operator``)."""

from benchmark.program import counters, since

SPANS = {}
AT_LOAD = counters()  # the window's start: readers load after the set-up
KERNELS = tuple(f"spmm.launches.K{i}" for i in (1, 2, 3, 4))


def read(ctx):
    grew = since(AT_LOAD)
    if not grew or "spmm.launches.coo" not in grew:
        return None
    coo = grew["spmm.launches.coo"]
    total = coo + sum(grew.get(k, 0) for k in KERNELS)
    return 100.0 * coo / total if total else None
