"""K3 over the banded operator with make mode's candidate slots on the
card, against the operator's plain version: the slots are stored entries
(explicit zeros until a commit writes 1 into both triangles), so the row
gather (b ≥ ``GATHER_MIN_B``) and the one-thread-an-output ELL kernel
(narrower b) read them as any entry.

K3 has no CPU version, so every test here needs a CUDA card and skips
without one. This file imports no JAX, so that it runs on a machine
without it; from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m card -q \\
        tests/test_torch_banded_card.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_robustness_torch.graphs.centrality import compute_centrality_host
from krylov_robustness_torch.graphs.top_edges import find_top_missing_edges
from krylov_robustness_torch.ops.banded_spmm import GATHER_MIN_B, \
    BandedEllOperator, rcm_permutation
from krylov_robustness_torch.optimize import greedy

pytestmark = pytest.mark.card


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K3 has no CPU version")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def slotted():
    """A road-like graph of 20,000 nodes (a path and 2,000 chords of up to
    300 hops) with the 100 candidate slots of a make sweep at Q = 50,
    k = 50, relabeled as greedy relabels it. Returns (the relabeled CSR
    matrix, the slots in its labels)."""
    n, rng = 20000, np.random.default_rng(13)
    src = np.concatenate([np.arange(n - 1), rng.integers(0, n - 300, 2000)])
    dst = np.concatenate([np.arange(1, n), np.zeros(2000, np.int64)])
    dst[n - 1:] = src[n - 1:] + rng.integers(2, 300, 2000)
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    A = sp.csr_matrix(((A + A.T) > 0).astype(np.float64))
    top = find_top_missing_edges(A, compute_centrality_host(A, "eig"), 100,
                                 "min")
    Ap, pinv = greedy._relabel(greedy._with_zero_slots(A, top),
                               rcm_permutation(A))
    assert Ap.nnz == A.nnz + 200
    return Ap, pinv[top]


def _bound(B: sp.csr_matrix, x: np.ndarray, K: int, u: float):
    """How far two summation orders of a row's K slots may part, entry by
    entry: twice the bound of recursive summation, (K + 1)·u·Σ|a·x|
    (Higham, Accuracy and Stability of Numerical Algorithms, §4.2), plus
    two units of f32's last place for the rounding of an f32 y."""
    absy = abs(B) @ np.abs(x)
    extra = 2.0 ** -22 * np.abs(B @ x) if u > 2.0 ** -30 else 0.0
    return 2 * (K + 1) * u * absy + extra


@pytest.mark.parametrize("dtype,u", [(torch.float32, 2.0 ** -24),
                                     (torch.float64, 2.0 ** -53)])
@pytest.mark.parametrize("b", [100, 16])
def test_k3_over_slots_matches_plain(dev, slotted, b, dtype, u):
    """b = 100 runs the row gather, b = 16 the ELL kernel over K slots a row
    (K counts the candidate slots): both equal ``matmul_plain`` and scipy's
    product within the bound of two summation orders, before and after a
    commit writes 1 into the slots of two candidates."""
    Ap, slots = slotted
    op = BandedEllOperator(Ap, dtype=dtype, device=dev)
    assert op.K == int(np.diff(Ap.indptr).max())
    assert (b >= GATHER_MIN_B) == (b == 100)
    x = torch.as_tensor(np.random.default_rng(b).standard_normal(
        (op.n, b)), device=dev).to(dtype)
    xh = x.double().cpu().numpy()
    B = Ap.tolil()
    for i, j in ((None, None), *map(tuple, slots[:2].tolist())):
        if i is not None:
            op.set_edge(i, j, 1.0)
            B[i, j] = B[j, i] = 1.0
        got = op.matmul(x).double().cpu().numpy()
        plain = op.matmul_plain(x).double().cpu().numpy()
        C = B.tocsr()
        bound = _bound(C, xh, op.K, u)
        assert np.all(np.abs(got - plain) <= bound)
        assert np.all(np.abs(got - C @ xh) <= bound)
