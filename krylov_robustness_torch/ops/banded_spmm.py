"""RCM helpers of the banded operator (``ops/pallas_spmm.py:244-258`` of the
JAX package). The banded-ELL operator and its kernel are not ported yet."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def rcm_permutation(A_scipy) -> np.ndarray:
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(sp.csr_matrix(A_scipy),
                                            symmetric_mode=True))


def rcm_bandwidth(A_scipy, perm: np.ndarray | None = None) -> int:
    C = sp.coo_matrix(A_scipy)
    if not C.nnz:
        return 0
    if perm is not None:
        pinv = np.empty_like(perm)
        pinv[perm] = np.arange(len(perm))
        return int(np.abs(pinv[C.row] - pinv[C.col]).max())
    return int(np.abs(C.row - C.col).max())
