"""The block step after the SpMM (``ops/block_mgs.py``) on the CPU: which
version takes which input, the kernel's grid plan, and the
``krylov.steps_kernel`` and ``krylov.launches.MGS`` counts. The plain
version is held against the JAX package in tests/test_torch_lanczos.py; the
kernel itself runs on the card only (``chip_smoke.py``, its block_mgs
phase)."""

import numpy as np
import pytest
import torch

from helpers import random_graph
from krylov_robustness_torch.krylov import lanczos
from krylov_robustness_torch.ops import block_mgs, cuda_build
from krylov_robustness_torch.ops.sparse import CooMatrix
from krylov_robustness_torch.utils import tracing

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


def _random_case():
    A = random_graph(150, 0.05, seed=42, weighted=True)
    return A, np.random.default_rng(0).standard_normal((4, 150, 2))


def test_cpu_blocks_take_the_plain_version_and_count_no_kernel_step():
    A, U = _random_case()
    M = CooMatrix.from_scipy(A, device="cpu")
    state, _ = lanczos.lanczos_start(M, torch.as_tensor(U))
    assert not block_mgs.on_kernel_path(state.v_prev, state.v_cur,
                                        state.v_cur, state.alive)
    before = tracing.counters()
    lanczos.lanczos_continue(M, state, 3)
    after = tracing.counters()
    assert after.get("krylov.steps_kernel", 0) == \
        before.get("krylov.steps_kernel", 0)
    assert after["krylov.steps_run"] - before.get("krylov.steps_run", 0) \
        == 3 * U.shape[0]


class _Block:
    """A stand-in for a CUDA tensor: what the path rule reads, no card."""

    def __init__(self, shape, dtype=torch.float32, device="cuda:0",
                 contiguous=True, ptr=1 << 20):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device(device)
        self._contiguous = contiguous
        self._ptr = ptr

    def is_contiguous(self):
        return self._contiguous

    def data_ptr(self):
        return self._ptr


def _inputs(n=1000, batch=50, bs=2, **change):
    """(vp, vc, w, alive) stand-ins of the kernel's inputs; ``change`` maps
    a position to the stand-in that replaces it."""
    args = [_Block((n, batch, bs)) for _ in range(3)]
    args.append(_Block((batch,), dtype=torch.bool))
    for k, v in change.items():
        args["vp vc w alive".split().index(k)] = v
    return args


@pytest.mark.parametrize("dtype,bs", [(torch.float32, 2), (torch.float64, 2),
                                      (torch.float32, 1),
                                      (torch.float64, 4), (torch.float32, 5),
                                      (torch.float64, 8),
                                      (torch.float32, 60),
                                      (torch.float64, 200)])
def test_cuda_blocks_the_kernel_takes(dtype, bs):
    """Narrow blocks (bs ≤ 4) and wide ones (a joint edit's rescoring, the
    weighted objective) alike."""
    args = [_Block((500, 260, bs), dtype=dtype) for _ in range(3)]
    args.append(_Block((260,), dtype=torch.bool))
    assert block_mgs.on_kernel_path(*args)


BAD = {
    "not contiguous": {"vc": _Block((1000, 50, 2), contiguous=False)},
    "float16": {k: _Block((1000, 50, 2), dtype=torch.float16)
                for k in ("vp", "vc", "w")},
    "bfloat16": {k: _Block((1000, 50, 2), dtype=torch.bfloat16)
                 for k in ("vp", "vc", "w")},
    "mixed types": {"w": _Block((1000, 50, 2), dtype=torch.float64)},
    "empty columns": {k: _Block((1000, 50, 0)) for k in ("vp", "vc", "w")},
    "not 3-d": {k: _Block((1000, 100)) for k in ("vp", "vc", "w")},
    "wide batch past the grid": {
        **{k: _Block((10, 65536, 5)) for k in ("vp", "vc", "w")},
        "alive": _Block((65536,), dtype=torch.bool)},
    "wider than the grid": {k: _Block((10, 1, 32 * 182))
                            for k in ("vp", "vc", "w")},
    "shapes differ": {"vp": _Block((1000, 49, 2))},
    "empty batch": {**{k: _Block((1000, 0, 2)) for k in ("vp", "vc", "w")},
                    "alive": _Block((0,), dtype=torch.bool)},
    "alive not bool": {"alive": _Block((50,), dtype=torch.uint8)},
    "alive length": {"alive": _Block((49,), dtype=torch.bool)},
    "one on the CPU": {"vp": _Block((1000, 50, 2), device="cpu")},
    "two cards": {"vp": _Block((1000, 50, 2), device="cuda:1")},
    "not aligned": {"w": _Block((1000, 50, 2), ptr=(1 << 20) + 8)},
    "not CUDA": {**{k: _Block((1000, 50, 2), device="meta")
                    for k in ("vp", "vc", "w")},
                 "alive": _Block((50,), dtype=torch.bool, device="meta")},
}


@pytest.mark.parametrize("what", sorted(BAD))
def test_other_cuda_blocks_raise(what):
    """The path rule raises on what the kernel does not take; there is no
    fallback to the plain version for a CUDA tensor."""
    with pytest.raises(ValueError):
        block_mgs.on_kernel_path(*_inputs(**BAD[what]))


def test_kernel_steps_are_counted_in_member_steps(monkeypatch):
    """Each step that goes the kernel's way adds its batch to
    krylov.steps_kernel, in the member-steps of krylov.steps_run (the kernel
    replaced here by the plain version, the path rule by its verdict on a
    card)."""
    monkeypatch.setattr(block_mgs, "on_kernel_path", lambda *a: True)
    monkeypatch.setattr(block_mgs, "block_mgs_cuda",
                        block_mgs.block_mgs_plain)
    A, U = _random_case()
    M = CooMatrix.from_scipy(A, device="cpu")
    state, _ = lanczos.lanczos_start(M, torch.as_tensor(U))
    before = tracing.counters()
    lanczos.lanczos_continue(M, state, 5)
    after = tracing.counters()

    def grew(k):
        return after[k] - before.get(k, 0)

    assert grew("krylov.steps_kernel") == grew("krylov.steps_run") == 5 * 4
    assert grew("krylov.launches.MGS") == 5 * block_mgs.LAUNCHES["narrow"]


def test_wide_steps_count_the_wide_chains_launches(monkeypatch):
    monkeypatch.setattr(block_mgs, "on_kernel_path", lambda *a: True)
    monkeypatch.setattr(block_mgs, "block_mgs_cuda",
                        block_mgs.block_mgs_plain)
    A, _ = _random_case()
    M = CooMatrix.from_scipy(A, device="cpu")
    U = np.random.default_rng(2).standard_normal((1, 150, 12))
    state, _ = lanczos.lanczos_start(M, torch.as_tensor(U))
    before = tracing.counters()
    lanczos.lanczos_continue(M, state, 3)
    after = tracing.counters()
    assert after["krylov.steps_kernel"] - \
        before.get("krylov.steps_kernel", 0) == 3
    assert after["krylov.launches.MGS"] - \
        before.get("krylov.launches.MGS", 0) == 3 * block_mgs.LAUNCHES["wide"]


@pytest.mark.parametrize("n,batch,bs", [(95672, 250, 2), (95672, 50, 2),
                                        (18772, 260, 2), (150, 4, 2),
                                        (1, 1, 2), (95672, 1, 60),
                                        (95672, 3, 8), (3684, 1, 20),
                                        (95672, 1, 200)])
def test_plan_covers_the_rows_and_fills_the_card(n, batch, bs):
    """The slabs tile the rows, none empty; on 132 SMs about 4 CTAs an SM
    run whatever the batch and width, unless the rows run out first."""
    rows, slabs = block_mgs.plan(n, batch, 132, bs)
    assert rows * slabs >= n > rows * (slabs - 1)
    assert slabs <= -(-n // block_mgs.MIN_SLAB_ROWS)
    tiles = -(-batch // 32) if bs <= block_mgs.MAX_BS else \
        batch * 2 * (-(-bs // block_mgs.TILE)) ** 2
    if n >= block_mgs.MIN_SLAB_ROWS * 4 * 132:
        assert abs(slabs * tiles - 4 * 132) < tiles


def test_start_state_is_contiguous():
    """lanczos_start hands the step contiguous blocks, as the kernel takes
    them."""
    A, U = _random_case()
    M = CooMatrix.from_scipy(A, device="cpu")
    state, _ = lanczos.lanczos_start(M, torch.as_tensor(U))
    assert state.v_cur.is_contiguous() and state.v_prev.is_contiguous()


def test_source_is_registered():
    assert cuda_build.SOURCES["block_mgs"].name == "block_mgs.cu"
    assert cuda_build.SOURCES["block_mgs"].exists()
