"""Dataset loaders for the paper's .mat graph collections — carried over from
``krylov_robustness_tpu/graphs/io.py``.

Handles both classic MATLAB files (scipy.io) and v7.3/HDF5 files (h5py) —
the Misc collection mixes formats (CollegeMsg, Drugs, as_735 are v7.3).
Mirrors the load conventions of the reference drivers
(``Tests/test_unweighted_break.m:42-47``, ``Tests/test_weighted_exp_lbfgs.m:29-41``,
``MIOBI Codes/howtorun.txt``): SuiteSparse-style ``Problem.A`` structs, the
flat power-grid struct in ``voltage_adjacencies_average_2.mat``, and the
``dt_oregon.mat`` A0..A8 arrays.

The datasets themselves are not vendored; ``data_root()`` resolves the
location from ``$KRYLOV_ROBUSTNESS_DATA``, read when this module is imported,
or ``data/`` at the root of the checkout. ``h5py`` is imported only to read a
v7.3 file.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import scipy.sparse as sp

DEFAULT_DATA_ROOTS = (
    os.environ.get("KRYLOV_ROBUSTNESS_DATA", ""),
    str(Path(__file__).resolve().parents[2] / "data"),
)

# Dataset indices used by the paper drivers are positions in a MATLAB
# ``dir`` listing, which sorts ASCIIbetically and includes ``.``/``..`` as
# entries 1-2 (``test_unweighted_break.m:28-31``: Misc range
# [3,4,6,9,10,11,12,15,16,17,18], Transport range [3:13]). We pin the
# resolved names for reproducibility.
MISC_PAPER_SET = [
    "Cardiff", "CollegeMsg", "Edinburgh", "as_735", "ca-AstroPh",
    "ca-CondMat", "ca-HepTh", "london", "netscience", "soc-Epinions1",
    "yeast",
]
TRANSPORT_PAPER_SET = [
    "Anaheim", "Austin", "Barcelona", "Birmingham", "ChicagoRegional", "DC",
    "Hawaii", "Philadelphia", "RhodeIsland", "Rome", "Sydney",
]
# Budget-sweep road networks (``test_unweighted_break_budget.m:22``:
# Transport dir indices [3,6,7,9,11,12] with the ./.. offset).
BUDGET_PAPER_SET = [
    "Anaheim", "Birmingham", "ChicagoRegional", "Hawaii", "RhodeIsland",
    "Rome",
]
POWERGRID_PAPER_SET_INDICES = [13, 5, 15, 19, 17, 4, 9, 11, 7, 1]  # 1-based


def data_root() -> Path:
    for root in DEFAULT_DATA_ROOTS:
        if root and Path(root).exists():
            return Path(root)
    raise FileNotFoundError(
        "No dataset root found; set KRYLOV_ROBUSTNESS_DATA to a directory "
        "containing datasets_paper/ and 'MIOBI Codes'/"
    )


def _h5_to_csc(h5file, group) -> sp.spmatrix:
    """Decode a MATLAB v7.3 sparse matrix group (CSC: data/ir/jc)."""
    data = np.asarray(group["data"]).ravel()
    ir = np.asarray(group["ir"]).ravel().astype(np.int64)
    jc = np.asarray(group["jc"]).ravel().astype(np.int64)
    n_cols = len(jc) - 1
    n_rows = int(ir.max()) + 1 if len(ir) else n_cols
    n = max(n_rows, n_cols)
    return sp.csc_matrix((data, ir, jc), shape=(n, n_cols)).tocsr()


def _load_mat_any(path: Path) -> dict:
    import scipy.io as sio

    try:
        return sio.loadmat(str(path), struct_as_record=False, squeeze_me=True)
    except NotImplementedError:
        # v7.3: fall through to h5py
        return {"__hdf5__": path}


def load_problem_adjacency(path: Path) -> sp.spmatrix:
    """Load the adjacency matrix from a SuiteSparse-style ``Problem.A`` file."""
    d = _load_mat_any(path)
    if "__hdf5__" in d:
        import h5py

        with h5py.File(str(path), "r") as f:
            prob = f["Problem"]
            A = prob["A"]
            if isinstance(A, h5py.Group):
                return _h5_to_csc(f, A)
            # dereference if stored as object reference
            return _h5_to_csc(f, f[A[()]])
    prob = d["Problem"]
    A = prob.A
    return sp.csr_matrix(A)


def misc_path(name: str) -> Path:
    """Single source of truth for the Misc collection layout (used by both
    the loader and the experiment drivers' routing check)."""
    return data_root() / "datasets_paper" / "Misc" / f"{name}.mat"


def load_misc(name: str) -> sp.spmatrix:
    return load_problem_adjacency(misc_path(name))


def load_transport(name: str) -> sp.spmatrix:
    return load_problem_adjacency(
        data_root() / "datasets_paper" / "Transport" / f"{name}.mat"
    )


def load_oregon(which: int = 0) -> sp.spmatrix:
    """dt_oregon.mat ships Oregon AS snapshots A0..A8."""
    import scipy.io as sio

    path = data_root() / "MIOBI Codes" / "dt_oregon.mat"
    d = sio.loadmat(str(path))
    key = f"A{which}"
    return sp.csr_matrix(d[key])


def load_power_grids(path: Path | None = None) -> dict[str, np.ndarray]:
    """Weighted country power-grid adjacencies (dense, max-normalized later).

    Returns an ordered dict name -> dense symmetric matrix.
    """
    import scipy.io as sio

    if path is None:
        path = data_root() / "datasets_paper" / "voltage_adjacencies_average_2.mat"
    d = sio.loadmat(str(path), struct_as_record=False, squeeze_me=True)
    out: dict[str, np.ndarray] = {}
    for key in d:
        if key.startswith("__"):
            continue
        entry = d[key]
        if isinstance(entry, np.ndarray) and entry.ndim == 2 and entry.shape[0] == entry.shape[1]:
            out[key] = np.asarray(entry, dtype=np.float64)
        elif sp.issparse(entry):
            out[key] = np.asarray(entry.todense(), dtype=np.float64)
        elif hasattr(entry, "_fieldnames"):
            # struct of matrices: flatten one level
            for f in entry._fieldnames:
                v = getattr(entry, f)
                if sp.issparse(v):
                    v = np.asarray(v.todense())
                if isinstance(v, np.ndarray) and v.ndim == 2:
                    out[f] = np.asarray(v, dtype=np.float64)
    return out
