"""Host 2-norm estimate — carried over from
``krylov_robustness_tpu/funm/normest.py::normest2_host`` (MATLAB
``normest``, ``Tests/test_unweighted_break.m:56``). The device estimators are
not ported yet."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla


def normest2_host(A_scipy, tol: float = 1e-2) -> float:
    """‖A‖₂ of a symmetric sparse matrix via scipy eigsh (largest |λ|)."""
    A = sp.csr_matrix(A_scipy).astype(np.float64)
    w = spla.eigsh(A, k=1, which="LM", return_eigenvectors=False,
                   tol=max(tol * 1e-2, 1e-10))
    return float(abs(w[0]))
