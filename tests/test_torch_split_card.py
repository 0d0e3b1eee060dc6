"""K1 and K2 with a split plan (ops/row_gather.py::split_plan) on the card,
against the same kernels without one and against the plain twin in the
split order (ops/bsr_super.py::split_spmm_plain), on a hub graph with a
row of 3,000 entries.

The kernels have no CPU version, so every test here needs a CUDA card and
skips without one. This file imports no JAX, so that it runs on a machine
without it; from the root of a checkout:

    python -m pytest --noconftest -p no:cacheprovider -m card -q \\
        tests/test_torch_split_card.py
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_robustness_torch.ops import bsr_super, row_gather
from krylov_robustness_torch.ops.bsr_super import SuperBsrOperator

pytestmark = pytest.mark.card

# (mode, dtype, unit roundoff of the sums): K1's bf16 parts sum in f32, K2
# sums in f64 (and in f32 rounds once at the store)
MODES = [("bf16x2", torch.float32, 2.0 ** -24),
         ("bf16x3", torch.float32, 2.0 ** -24),
         ("f32", torch.float32, 2.0 ** -53),
         ("f32", torch.float64, 2.0 ** -53)]
WIDTHS = (32, 33, 100, 500, 520, 640)  # 33: two columns a lane, no vectors
HUB = 0  # the node with 3,000 neighbours


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 and K2 have no CPU version")
    return torch.device("cuda", 0)


def _hub_graph(n: int = 8000, draws: int = 80000, seed: int = 21):
    """A Chung–Lu graph with hubs, node HUB joined to 3,000 others, and 40
    explicit-zero candidate slots in both triangles, 20 of them in HUB's
    row (as make mode packs them). Returns (A, slots (k, 2))."""
    rng = np.random.default_rng(seed)
    w = (np.arange(n) + 3.0) ** -0.9
    src = np.concatenate([rng.choice(n, draws, p=w / w.sum()),
                          np.full(3000, HUB)])
    dst = np.concatenate([rng.choice(n, draws, p=w / w.sum()),
                          rng.choice(np.arange(1, n), 3000, replace=False)])
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
    A = sp.csr_matrix(((A + A.T) > 0).astype(np.float64))
    A.setdiag(0)
    A.eliminate_zeros()
    r = np.concatenate([np.full(60, HUB), rng.integers(0, n, 60)])
    c = rng.integers(0, n, 120)
    keep = (r != c) & (np.asarray(A[r, c]).ravel() == 0)
    r, c = r[keep][:40], c[keep][:40]
    C = sp.coo_matrix(A)
    M = sp.coo_matrix(
        (np.concatenate([C.data, np.zeros(2 * len(r))]),
         (np.concatenate([C.row, r, c]), np.concatenate([C.col, c, r]))),
        shape=A.shape).tocsr()
    return M, np.stack([r, c], axis=1)


@pytest.fixture(scope="module")
def graph():
    return _hub_graph()


def _kernel(op, x, split):
    index = (op._row_ptr, op._cols, op._val_off, op.vals, x)
    if op._terms():
        return bsr_super.tile_spmm_bf16(*index, op._terms(), split=split)
    return bsr_super.tile_spmm_full(*index, split=split)


def _twin(op, x):
    return bsr_super.split_spmm_plain(op._row_ptr, op._cols, op._val_off,
                                      op.vals, x, op._split, op._terms())


def _bound(op, x, y, u) -> torch.Tensor:
    """How far two orders of a row's sums may part, entry by entry: twice
    the bound of recursive summation, (len + 1)·u·Σ|a·x| a row of len
    entries (Higham, Accuracy and Stability of Numerical Algorithms, §4.2),
    and two units of the last place of an f32 y for its rounding."""
    lens = torch.diff(op._row_ptr).double()[:, None]
    absy = bsr_super.csr_spmm_full_plain(op._row_ptr, op._cols, op._val_off,
                                         op.vals.abs(), x.abs().double())
    out = 2 * (lens + 1) * u * absy
    if y.dtype == torch.float32:
        out = out + 2.0 ** -22 * y.abs().double()
    return out


def _within(y, want, bound) -> bool:
    return bool(((y.double() - want.double()).abs() <= bound).all())


def _cut_rows(op) -> torch.Tensor:
    cut = torch.zeros(op.n, dtype=torch.bool, device=op.device)
    cut[op._split.units[:op._split.pieces, 0].long()] = True
    return cut


@pytest.mark.parametrize("b", WIDTHS)
@pytest.mark.parametrize("mode,dtype,u", MODES)
def test_split_kernel_against_the_unsplit_kernel(dev, graph, mode, dtype,
                                                 u, b):
    """Rows the plan does not cut are the unsplit kernel's, bit for bit;
    cut rows part from it and from the plain twin within the bound of two
    summation orders; two launches give the same bits."""
    A, _ = graph
    op = SuperBsrOperator(A, dtype=dtype, device=dev, mode=mode)
    assert op._split.pieces >= -(-3000 // row_gather.SPLIT_ENTRIES)
    x = torch.as_tensor(np.random.default_rng(b).standard_normal(
        (op.n, b)), device=dev).to(dtype)
    y0 = _kernel(op, x, None)
    y1, y2 = _kernel(op, x, op._split), _kernel(op, x, op._split)
    assert torch.equal(y1, y2)
    cut = _cut_rows(op)
    assert bool(cut[HUB]) and torch.equal(y1[~cut], y0[~cut])
    bound = _bound(op, x, y0, u)
    assert _within(y1, y0, bound) and _within(y1, _twin(op, x), bound)


@pytest.mark.parametrize("mode,dtype,u", MODES)
def test_split_path_sees_value_edits(dev, graph, mode, dtype, u):
    """An edit in place of the values, a break (an edge of the hub set to
    0) and a make commit (a slot of the hub set to 1), reaches the product
    through the hub's cut row."""
    A, slots = graph
    op = SuperBsrOperator(A, dtype=dtype, device=dev, mode=mode)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (op.n, 500)), device=dev).to(dtype)
    before = op @ x
    j = int(A.indices[A.indptr[HUB]:A.indptr[HUB + 1]][
        A.data[A.indptr[HUB]:A.indptr[HUB + 1]] != 0][0])
    s = int(slots[slots[:, 0] == HUB][0, 1])
    op.set_edge(HUB, j, 0.0)
    op.set_edge(HUB, s, 1.0)
    after = op @ x
    assert _within(after, _twin(op, x), _bound(op, x, after, u))
    # the hub's row moved by x[s] − x[j] (to the sums' rounding: the check
    # to the bound is the one against the twin above)
    moved = (after[HUB] - before[HUB]).double()
    want = (x[s] - x[j]).double()
    assert float((moved - want).abs().max()) <= 1e-3 * float(
        want.abs().max())


@pytest.mark.parametrize("mode,dtype", [("bf16x2", torch.float32),
                                        ("f32", torch.float64)])
def test_narrow_width_takes_no_plan(dev, graph, mode, dtype):
    """b = 16 takes the narrow path, which the plan leaves alone."""
    A, _ = graph
    op = SuperBsrOperator(A, dtype=dtype, device=dev, mode=mode)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (op.n, 16)), device=dev).to(dtype)
    assert row_gather.launch_plan(op._split, x, 2, torch.float32) is None
    assert torch.equal(_kernel(op, x, op._split), _kernel(op, x, None))


@pytest.mark.parametrize("limit,run", [
    (row_gather.SPLIT_ENTRIES // 2, row_gather.ROWS_PER_WARP),
    (row_gather.SPLIT_ENTRIES, 2 * row_gather.ROWS_PER_WARP)])
def test_plan_for_other_constants_is_refused(dev, graph, limit, run):
    """A plan built for another split limit or run of rows than the
    kernel's is refused at the launch, before any work."""
    A, _ = graph
    op = SuperBsrOperator(A, dtype=torch.float32, device=dev, mode="bf16x2")
    other = row_gather.split_plan(op._row_ptr, dev, limit, run)
    x = torch.ones((op.n, 64), device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        _kernel(op, x, other)
