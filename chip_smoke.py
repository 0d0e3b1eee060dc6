#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``krylov_robustness_torch``) on one GPU.

Usage, from the root of a checkout on a machine with an sm_90a card::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
2. build: compile the kernels K1/K2 (``csrc/bsr_super.cu``), K3
   (``csrc/banded_ell.cu``) and K4 (``csrc/bsr_flat.cu``; all four share the
   row gather of ``csrc/row_gather.cuh``, K3 from b = 32 on) and the block
   step (``csrc/block_mgs.cu``) with nvcc, one process per source, in
   parallel;
3. kernels: each kernel against its plain torch version and scipy, with
   CUDA-event times beside the plain version's, the COO SpMM's and one
   cuSPARSE call's (``torch.sparse.mm`` on a CSR tensor, the yardstick the
   port never calls) and the kernel's time over it, and its bound (the
   larger of the product's bytes — A as CSR, x read once, y written once —
   at the HBM rate and 2·nnz·b at its unit's peak) beside its design time
   (its stored tables in place of CSR) and the bytes its row gathers read
   and their rate, on a road network at Vermont's scale and a hub graph at
   ca-AstroPh's scale (both RCM-permuted), at b = 512 and at the main paths'
   widths (K1 also at b = 250, K3 at b = 1, 100, 512 in f32 and 100 in f64,
   K4 at b = 1, 100, 250, 500, 512 in f32 and 512 in f64, on the road
   graph; K2 f32 on the hub graph also on a second, independently drawn x);
   the hub graph's flat blocks exceed their budget, so
   ``make_bsr_operator`` falls back to COO there; the super-tile operator
   on the benchmark's soc-Epinions1-scale stand-in, whose tiles would take
   ~9 GB, holds its CSR-order values alone, and one K1 product at b = 500
   is held against ``coo_spmm``;
3b. block step (``ops/block_mgs.py``, ``csrc/block_mgs.cu``): the kernel
   chains against the einsum step and against that step in f64, in f32 and
   f64, the narrow chain at the main paths' widths (b = 500 and 100 on the
   road graph, 520 on the hub graph), the wide one at a rescored joint
   edit's, CONFIG 5's and the weighted objective's (bs = 5, 8, 20, 60), each
   also on a w that the first MGS pass nearly cancels (Q's overlap with the
   window then shows a missing second pass), with members dead on entry, on
   twin nodes that must deflate and on members that break down fully; two
   runs give identical bits; a 20-step recurrence through each chain held
   against the f64 recurrence (h, beta, loss of orthogonality); CUDA-event
   times of the chain and the einsum step beside the least time (four blocks
   at 3.35 TB/s); then ``krylov.steps_kernel`` equals ``krylov.steps_run``
   over the scoring call of the first step of ``road.break_q250`` and of
   ``hub.break_q250_perstep`` (the cells' graphs, candidates, σ and
   tolerance) and a weighted-width call; on those scoring calls
   ``krylov.steps_run`` equals ``krylov.steps_used`` (each round runs for
   the candidates not yet accepted: the carry shrinks on road, and on the
   hub every candidate is accepted at m = 12 with nothing dropped), and Δ
   of every candidate lies within the cell's ``delta_gap`` limit of the
   benchmark's f64 plain reference;
3c. spectra (``ops/banded_sturm.py``, ``csrc/banded_sturm.cu``): the
   Sturm kernel on 100-step f32 recurrences at the main path's shapes (road
   break at Q = 250 and 50, hub break at b = 520, hub make's positive B) at
   every round of the default schedule (M = 12 … 200), converged candidates
   left out, members dead on entry and broken down, against host LAPACK
   (eigenvalues within 1e-13·‖G‖, Δ within 1e-11 relative) and the plain
   version on the card; identical reruns; a NaN poisons its member only;
   the time a round beside its least time (the FP64 pipes' rate), the
   plain version's and LAPACK's; then ``spectra.members_kernel`` equals 4 ×
   the candidates of every round, one launch a round, ``members_host`` 0,
   over a scoring call on each graph and in make;
4. greedy path, road graph: ``greedy_krylov`` break/make on the per-step
   lane through K1 (f32) and K2 (f64), picks held against the COO backend;
5. greedy path, hub graph: the fused lane with σ-shift, picks held against
   the per-step lane, whose picks are held against the COO backend;
6. budget path (Figures 1-4): the paper CLI's ``budget`` sweep at Q = 50 on
   the road graph, written as a ``.mat`` into a temporary data root, which
   runs K3; then ``greedy_krylov`` with the sweep's arguments, picks held
   against the COO backend in f32 (its fused and per-step lanes) and f64;
7. tables path (Tables 2-3): the CLI's ``unweighted`` protocol on the hub
   graph (GKB on K1, MIOBI and EIGENV rescored, host f64 normalizers);
8. bench path: ``python3 -m krylov_robustness_torch.bench`` in this process
   (its SpMM lanes on the road graph: COO, K4 and K1; its greedy lanes on
   the hub graph), its JSON line printed as it is;
9. weighted path (Tables 5-6; a ``CooMatrix`` path that launches none of
   K1-K4): seeded stand-ins for three power grids (n = 94, 1,200, 3,684)
   written as ``voltage_adjacencies_average_2.mat`` into the temporary data
   root; ``build_problem``, ``fun_and_grad`` and ``hessian`` in f64 on the
   card held against the port's CPU f64 (and a dense scipy expm) on the two
   smaller grids, ``run_country`` on all three on the card and the CPU;
   the CLI's ``weighted`` subcommand on cuda:0 in f32 (and ``--hessian
   --fun sinh``); then the JAX package's Vermont-scale rewiring of
   trace(sinh(A)) (``scripts/config5_sharded_sinh_rewire.py``) on the road
   graph, its objective held against an independent evaluation and two
   gradient coordinates against central differences;
10. sharded path (the distributed layer, ``parallel/``): a 1-rank NCCL
   process group on the card runs the multi-rank dry run
   (``parallel/selfcheck.py::dryrun``, the JAX package's
   ``dryrun_multichip``) and, on the road graph, ``sharded_bsr`` break in
   f32 (K1, k = 3, Q = 250) and f64 (K2, k = 2) against the single-card
   ``bsr`` backend and ``sharded`` (COO) f64 against ``coo``; then 2 gloo
   ranks spawned on the one card (kernels built before): each rank's row
   block of ``BsrRowShardedMatrix.spmm_sharded`` at b = 512 in bf16x2 (K1)
   and f64 (K2) must launch its kernel once per pass (diagonal tiles on the
   local x while the all-gather is in flight, the others on the gathered
   x) and agree with scipy; each pass is held against its plain version and
   timed beside its bound; ``RowShardedMatrix`` coo and ell against scipy;
   ``sharded_bsr`` break k = 3 Q = 250 f32 picks as the 1-rank run's;
11. CONFIG 5 (launches none of K1-K4): the port's driver
   (``experiments/config5.py``, the JAX package's
   ``scripts/config5_sharded_sinh_rewire.py``) on the road graph as
   ``Transport/road_standin.mat``, rewiring of trace(sinh(A)) on
   ``RowShardedMatrix`` at the script's parameters (search space 30, 10
   edges, maxiter 50, f64): on a 1-rank NCCL group, held against phase 9's
   ``CooMatrix`` run (Omega identical, f'(A) entries within 1e-10, fval
   within 1e-8, the same iterations), then on 2 gloo ranks spawned on the
   card (Omega, every Taylor plan, iterate and fval identical on both,
   fval within 1e-8 of 1 rank); per run the ``[config5]`` lines give ms a
   ``fun_and_grad``, its all-gather share, the device's busy share, the
   peak device memory and the score with its Hutchinson normalizer;
12. scaling: ``measure_sharded_spmm`` at D = 1 on the road graph (coo and
   ell, b = 8 and 512) — one card shows a rate, not scaling;
13. surface: the ``trace`` bench (f64) on the stand-ins written as .mat and
   a small one below the dense cutoff, the ``expmv`` parity row on that one
   (≤ 1e-6), ``EllMatrix @ x`` on the card against scipy;
14. replay: copies of the inputs of the last launch of each kernel at each
   shape of phases 4-8 and 10 (outside the bench's timed lanes), rerun
   through the kernel and its plain version (for K1 and K2 over the same
   row index and values, for K4 over the blocks that its row index implies,
   for K3 over its ELL tables).

Each path (4-5, 6, 7, 8, 9, 10, 11) runs with every launch count set to 0
just before it and read just after (``MGS``: the launches of the block
step's kernel chain, which every path must take, and ``MGS steps`` the
member-steps through it; ``Sturm``, ``Sturm members`` and ``host members``:
the spectra kernel's launches and the matrices solved on the card and on the
host, where the greedy and budget paths must solve none on the host); the 2-rank halves of paths 10 and 11 run
in their own processes, which check and report their own counts. The line
before the last is a JSON object with one entry per kernel (its count on the path that
runs it, errors and times of phase 3); the last line is ``{"ok": true, "device": {...}}``. Without CUDA
the script exits with code 2 and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import csv
import io
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import scipy.sparse as sp
import torch

SOURCES = {"K1": "krylov_robustness_torch/csrc/bsr_super.cu",
           "K2": "krylov_robustness_torch/csrc/bsr_super.cu",
           "K3": "krylov_robustness_torch/csrc/banded_ell.cu",
           "K4": "krylov_robustness_torch/csrc/bsr_flat.cu",
           "MGS": "krylov_robustness_torch/csrc/block_mgs.cu",
           "Sturm": "krylov_robustness_torch/csrc/banded_sturm.cu"}
REPLACES = {
    "K1": "krylov_robustness_tpu/ops/pallas_bsr_super.py:97",
    "K2": "krylov_robustness_tpu/ops/pallas_bsr_super.py:82",
    "K3": "krylov_robustness_tpu/ops/pallas_spmm.py:51",
    "K4": "krylov_robustness_tpu/ops/pallas_bsr.py:49",
    "MGS": "none (XLA's einsums in krylov_robustness_tpu/krylov/lanczos.py)",
    "Sturm": "none (host LAPACK in krylov_robustness_tpu/updates/"
             "trace_update.py::_eigvals_banded_batch)",
}
# relative to max|A x|: the first two mirror tests/test_pallas_bsr_super.py
GATES = {"bf16x2": 3e-5, "bf16x3": 3e-7, "f32": 1e-6, "f64": 1e-12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    from krylov_robustness_torch import bench

    card = bench.card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is on")
    check(torch.get_float32_matmul_precision() == "highest",
          "float32 matmul precision is not 'highest'")
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} "
          f"allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"float32_matmul_precision={torch.get_float32_matmul_precision()}")
    return card


def phase_build():
    from krylov_robustness_torch.ops import cuda_build

    t0 = time.perf_counter()
    for name, (path, seconds) in cuda_build.build_kernels().items():
        print(f"[build] {path.name} built in {seconds:.2f} s")
    print(f"[build] all sources in {time.perf_counter() - t0:.2f} s")


# Kernel modes held against their plain versions in phase 3, per graph: every
# mode at b = 512, and the widths the main path gives the kernels — 2·Q = 500
# in a per-step scoring call, 2·(Q + R) = 520 in a fused block — in the modes
# it runs them (the capture of the main path checks that none is missed);
# b = 250, not a multiple of 4, takes K1's two-columns-a-lane path.
MODES = {"bf16x2": ("bf16x2", torch.float32), "bf16x3": ("bf16x3", torch.float32),
         "f32": ("f32", torch.float32), "f64": ("f32", torch.float64)}
KERNEL_CASES = {
    "road": (("bf16x2", (512, 500, 250)), ("bf16x3", (512,)), ("f32", (512,)),
             ("f64", (512, 500))),
    "hub": (("bf16x2", (500, 520)), ("f32", (500,))),
}


def hold(op, A, xh, dtype, dev, label: str, where: str):
    """One product through ``op``'s kernel and through its plain version, on
    x = ``xh`` rounded to ``dtype``: each held against scipy's f64 A·x, and
    the two against each other, within ``GATES[label]`` of max|A·x|.
    Returns (x on the card, the errors as text, max|kernel − plain|)."""
    if dtype == torch.float32:
        xh = xh.astype(np.float32).astype(np.float64)
    ref = A @ xh
    scale = float(np.abs(ref).max())
    x = torch.as_tensor(xh, device=dev).to(dtype)
    yk = op.matmul(x)
    yp = op.matmul_plain(x)
    torch.cuda.synchronize()
    err_k = float(np.abs(yk.double().cpu().numpy() - ref).max()) / scale
    err_p = float(np.abs(yp.double().cpu().numpy() - ref).max()) / scale
    diff = float((yk - yp).abs().max())
    gate = GATES[label]
    check(err_k <= gate, f"{where} kernel error {err_k:.3e}")
    check(err_p <= gate, f"{where} plain error {err_p:.3e}")
    check(diff <= gate * scale, f"{where} kernel vs plain {diff / scale:.3e}")
    return x, (f"rel err vs scipy kernel {err_k:.3e} plain {err_p:.3e}; "
               f"kernel-plain {diff / scale:.3e} (gate {gate:.0e})"), diff


def hold_set_edge(op, Ap, x64, dev, label: str, where: str,
                  widths=(8,)) -> None:
    """A frozen-structure edit on the card, then a product at each of
    ``widths`` held as in :func:`hold` against scipy on the edited
    matrix."""
    C = sp.coo_matrix(sp.tril(Ap, -1))
    i, j = int(C.row[7]), int(C.col[7])
    op.set_edge(i, j, 0.0)
    A2 = Ap.tolil()
    A2[i, j] = A2[j, i] = 0.0
    for b in widths:
        _, errs, _ = hold(op, sp.csr_matrix(A2), x64[:, :b], torch.float32,
                          dev, label, f"{where} after set_edge b={b}")
        print(f"[kernels] {where} set_edge({i},{j}) then product b={b}: "
              f"{errs}")


def library_ms(Ap, x) -> float:
    """The yardstick: one PyTorch call computing the same product,
    ``torch.sparse.mm`` on a CSR tensor of ``Ap`` in x's dtype (cuSPARSE),
    timed as the kernels are. The port never calls it."""
    Ap = sp.csr_matrix(Ap)
    Ap.sort_indices()
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(Ap.indptr.astype(np.int32)),
        torch.as_tensor(Ap.indices.astype(np.int32)),
        torch.as_tensor(Ap.data), size=Ap.shape, dtype=x.dtype,
        device=x.device)
    return cuda_ms(lambda: torch.sparse.mm(csr, x))


# the keys of a kernel's entry in the kernels line
ENTRY_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")


def timed_case(op, Ap, x, unit: str, diff: float) -> dict:
    """CUDA-event times of the kernel, its plain version and the yardstick
    on x, the kernel's bound (the least time the card could take for
    y = A·x: A as CSR, x read once and y written once at the HBM rate,
    against 2·nnz·b at the peak of ``unit``) and its design time (the same
    with the operator's stored tables in place of CSR); the phase-3 entry
    of one kernel case."""
    from krylov_robustness_torch.bench import bounds_ms

    n, b = x.shape
    return {"max_abs_err": diff, "ms": cuda_ms(lambda: op.matmul(x)),
            "plain_ms": cuda_ms(lambda: op.matmul_plain(x)),
            **bounds_ms(op, n, Ap.nnz, b, x.element_size(), unit),
            "library_ms": library_ms(Ap, x)}


def case_text(st: dict) -> str:
    """The yardstick, the kernel's time over it, the bound and the design
    time of one timed case, as text."""
    return (f"cusparse {st['library_ms']:.4f} ms (kernel "
            f"{st['ms'] / st['library_ms']:.2f}x cusparse) bound "
            f"{st['bound_ms']:.4f} "
            f"ms ({st['bound_by']}) design {st['design_bytes'] / 1e6:.1f} MB "
            f"{st['design_ms']:.4f} ms")


def gathers(rows: int, b: int, size: int, ms: float) -> str:
    """The x row slices a kernel gathers (``rows`` of them, b values of
    ``size`` bytes each, one a stored entry) and their rate in ``ms``."""
    nbytes = rows * b * size
    return f"gathers {nbytes / 1e6:.1f} MB at {nbytes / ms / 1e9:.3f} TB/s"


def phase_kernels(dev, graphs) -> dict:
    from krylov_robustness_torch.ops.banded_spmm import rcm_permutation
    from krylov_robustness_torch.ops.bsr_super import SuperBsrOperator
    from krylov_robustness_torch.ops.sparse import CooMatrix

    stats = {}
    for name, cases in KERNEL_CASES.items():
        A = graphs[name]
        perm = rcm_permutation(A)
        Ap = sp.csr_matrix(A[perm, :][:, perm], dtype=np.float64)
        n, nnz = Ap.shape[0], Ap.nnz
        rng = np.random.default_rng(1)
        x64 = rng.standard_normal((n, max(max(w) for _, w in cases)))
        coo = CooMatrix.from_scipy(Ap, dtype=torch.float32, device=dev)
        for b in sorted({b for _, widths in cases for b in widths}):
            x = torch.as_tensor(x64[:, :b], dtype=torch.float32, device=dev)
            ms = cuda_ms(lambda: coo.matmul(x))
            print(f"[kernels] {name} coo f32: n={n} nnz={nnz} b={b} {ms:.4f} "
                  f"ms ({nnz * b / (ms * 1e-3) / 1e9:.2f} Gnnz·b/s)")
        for label, widths in cases:
            mode, dtype = MODES[label]
            op = SuperBsrOperator(Ap, dtype=dtype, device=dev, mode=mode)
            # K2 sums in f64 in both of its modes
            unit = "ffma" if label.startswith("bf16") else "dfma"
            for b in widths:
                x, errs, diff = hold(op, Ap, x64[:, :b], dtype, dev, label,
                                     f"{name} {label} b={b}")
                st = timed_case(op, Ap, x, unit, diff)
                print(f"[kernels] {name} {label}: n={n} nnz={nnz} b={b} "
                      f"values {op.storage_bytes() / 1e6:.2f} MB ("
                      f"{gathers(nnz, b, x.element_size(), st['ms'])}) "
                      f"kernel {st['ms']:.4f} ms "
                      f"({nnz * b / (st['ms'] * 1e-3) / 1e9:.2f} Gnnz·b/s) "
                      f"plain {st['plain_ms']:.4f} ms {case_text(st)}; "
                      f"{errs}")
                stats[name, label, b] = st
                del x
            if (name, label) == ("road", "bf16x3"):
                hold_set_edge(op, Ap, x64, dev, label, "K1")
            if (name, label) == ("road", "f32"):
                hold_set_edge(op, Ap, x64, dev, label, "K2", (8, 512))
            if (name, label) == ("hub", "f32"):
                # a second, independent draw: on some x a sequential f32 sum
                # over a hub row sat at the gate (PERF.md)
                x2 = np.random.default_rng(2).standard_normal((n, 500))
                _, errs, _ = hold(op, Ap, x2, dtype, dev, label,
                                  "hub f32 b=500 second x")
                print(f"[kernels] hub f32: n={n} nnz={nnz} b=500 second x "
                      f"(seed 2): {errs}")
            del op
            torch.cuda.empty_cache()
    return stats


# (dtype, label, b) of the road-graph kernels. K3: a vector, the budget
# sweep's 2·Q = 100 at Q = 50, and b = 512. K4: a vector, b = 100, b = 250
# (not a multiple of 4: two columns a lane), the per-step scoring width
# 2·Q = 500 and the bench's b = 512; f64 at the bench's width.
BANDED_CASES = ((torch.float32, "f32", 1), (torch.float32, "f32", 100),
                (torch.float32, "f32", 512), (torch.float64, "f64", 100))
FLAT_CASES = ((torch.float32, "f32", 1), (torch.float32, "f32", 100),
              (torch.float32, "f32", 250), (torch.float32, "f32", 500),
              (torch.float32, "f32", 512),
              (torch.float64, "f64", 512))


def phase_road_kernel(dev, A, kernel: str, make_op, cases, describe) -> dict:
    """One kernel (K3, K4) on the RCM-permuted road graph against its plain
    version and scipy at each (dtype, label, b) of ``cases``, with
    CUDA-event times of the kernel, the plain version, the COO SpMM and the
    yardstick, and its bound; then a frozen-structure edit and products at
    b = 8 and 100 (for K3 its two paths).
    ``make_op(Ap, dtype)`` builds the operator; ``describe(op, n, nnz, b,
    ms)`` gives the kernel's own figures for its line."""
    from krylov_robustness_torch.ops.banded_spmm import rcm_permutation
    from krylov_robustness_torch.ops.sparse import CooMatrix

    perm = rcm_permutation(A)
    Ap = A[perm, :].tocsc()[:, perm].tocsr()
    n, nnz = Ap.shape[0], Ap.nnz
    x64 = np.random.default_rng(1).standard_normal((n, 512))
    stats = {}
    ops = {}
    for dtype, label, b in cases:
        if label not in ops:
            ops[label] = (make_op(Ap, dtype),
                          CooMatrix.from_scipy(Ap, dtype=dtype, device=dev))
        op, coo = ops[label]
        x, errs, diff = hold(op, Ap, x64[:, :b], dtype, dev, label,
                             f"road {kernel} {label} b={b}")
        st = timed_case(op, Ap, x, "ffma" if label == "f32" else "dfma",
                        diff)
        coo_ms = cuda_ms(lambda: coo.matmul(x))
        print(f"[kernels] road {kernel} {label}: n={n} nnz={nnz} b={b} "
              f"{describe(op, n, nnz, b, st['ms'])} kernel {st['ms']:.4f} ms "
              f"({nnz * b / (st['ms'] * 1e-3) / 1e9:.2f} Gnnz·b/s) plain "
              f"{st['plain_ms']:.4f} ms coo {coo_ms:.4f} ms {case_text(st)}; "
              f"{errs}")
        stats["road", f"{kernel} {label}", b] = st
    hold_set_edge(ops["f32"][0], Ap, x64, dev, "f32", kernel, (8, 100))
    del ops
    torch.cuda.empty_cache()
    return stats


def phase_road_kernels(dev, A) -> dict:
    """K3 and K4 through :func:`phase_road_kernel`."""
    from krylov_robustness_torch.ops.banded_spmm import (
        GATHER_MIN_B,
        BandedEllOperator,
        num_windows,
        rcm_bandwidth,
        rcm_permutation,
    )
    from krylov_robustness_torch.ops.bsr import BLK, BsrOperator

    bw = rcm_bandwidth(A, rcm_permutation(A))

    def banded(op, n, nnz, b, ms):
        # the row gather reads one x row slice per stored entry, the ELL
        # kernel one per slot, padding included
        path, rows = (("row gather", nnz) if b >= GATHER_MIN_B
                      else ("one thread per output over the ELL", op.K * n))
        return (f"K={op.K} bw={bw} windows={num_windows(bw)} ({path}, "
                f"{gathers(rows, b, op.vals.element_size(), ms)})")

    def flat(op, n, nnz, b, ms):
        return (f"blocks={op.nblocks} ({op.storage_bytes() / 1e6:.1f} MB, "
                f"fill {nnz / (op.nblocks * BLK * BLK):.4%}, "
                f"{gathers(nnz, b, op.ablocks.element_size(), ms)})")

    stats = phase_road_kernel(
        dev, A, "K3", lambda Ap, dt: BandedEllOperator(Ap, dtype=dt,
                                                       device=dev),
        BANDED_CASES, banded)
    stats.update(phase_road_kernel(
        dev, A, "K4", lambda Ap, dt: BsrOperator(Ap, dtype=dt, device=dev),
        FLAT_CASES, flat))
    return stats


def phase_flat_fallback(dev, H) -> None:
    """The hub graph's flat blocks exceed their budget: ``make_bsr_operator``
    counts them before packing and falls back to COO in the identity
    order."""
    from krylov_robustness_torch.ops.banded_spmm import rcm_permutation
    from krylov_robustness_torch.ops.bsr import (
        BLK,
        MAX_STORAGE_BYTES,
        bsr_block_count,
        make_bsr_operator,
    )
    from krylov_robustness_torch.ops.sparse import CooMatrix

    nblk = bsr_block_count(H, rcm_permutation(H))
    op, perm = make_bsr_operator(H, dtype=torch.float32, device=dev)
    print(f"[kernels] hub K4: {nblk} blocks = {nblk * BLK * BLK * 4 / 1e9:.2f} "
          f"GB in f32 > {MAX_STORAGE_BYTES / 2**20:.0f} MiB: "
          f"make_bsr_operator gave {type(op).__name__}")
    check(nblk * BLK * BLK * 4 > MAX_STORAGE_BYTES,
          "hub graph: the flat blocks fit the budget")
    check(isinstance(op, CooMatrix), f"hub graph: {type(op).__name__}, not "
          f"the COO fallback")
    check(np.array_equal(perm, np.arange(H.shape[0])),
          "hub graph: the COO fallback is not in the identity order")


def phase_epinions_operator(dev) -> None:
    """The super-tile operator on the benchmark's soc-Epinions1-scale
    stand-in (structure seed 0, RCM-ordered): its super-tiles would take
    ~9 GB in bf16, its CSR-order values and index take a few MB; one K1
    product at the cell's b = 500 held against ``coo_spmm`` in f32."""
    import importlib

    from benchmark.generators import run_graph
    from benchmark.harness import resolve
    from krylov_robustness_torch.ops.banded_spmm import rcm_permutation
    from krylov_robustness_torch.ops.bsr_super import (
        TILE_C,
        TILE_R,
        SuperBsrOperator,
        super_tile_count,
    )
    from krylov_robustness_torch.ops.sparse import CooMatrix, coo_spmm
    from krylov_robustness_torch.utils.tracing import tensor_bytes

    config = resolve("epinions.break_q250_perstep")[1]
    A = run_graph(config, importlib.import_module(
        f"benchmark.generators.{config['generator']}"), 0)
    perm = rcm_permutation(A)
    Ap = sp.csr_matrix(A[perm, :][:, perm], dtype=np.float64)
    tiles = super_tile_count(Ap) * TILE_R * TILE_C * 2
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    op = SuperBsrOperator(Ap, dtype=torch.float32, device=dev)
    held = tensor_bytes(op)
    coo = CooMatrix.from_scipy(Ap, dtype=torch.float32, device=dev)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (Ap.shape[0], 500)), dtype=torch.float32, device=dev)
    yk, yc = op @ x, coo_spmm(coo, x)
    torch.cuda.synchronize(dev)
    err = float((yk - yc).abs().max() / yc.abs().max())
    k1_ms, coo_ms = cuda_ms(lambda: op @ x), cuda_ms(lambda: coo_spmm(coo, x))
    print(f"[kernels] epinions K1 {op.mode}: n={op.n} nnz={op.nnz} b=500 "
          f"tiles would take {tiles / 1e9:.2f} GB, the operator holds "
          f"{held / 1e6:.2f} MB; K1 {k1_ms:.4f} ms, coo_spmm {coo_ms:.4f} ms, "
          f"rel err vs coo_spmm {err:.3e} (gate {GATES[op.mode]:.0e}); peak "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    check(op.mode == "bf16x2", f"epinions: mode {op.mode}")
    check(held < 64 * 2**20 < tiles, f"epinions: the operator holds {held} "
          f"bytes, its tiles {tiles}")
    check(err <= GATES["bf16x2"], f"epinions K1 vs coo_spmm {err:.3e}")
    del op, coo, x, yk, yc
    torch.cuda.empty_cache()


# The block step after the SpMM (ops/block_mgs.py). Its narrow chain at the
# main paths' widths b = 2·batch (bs = 2): the road break cell's 500, the
# budget cell's 100 and the hub's 520 (a fused block's Q + R); its wide chain
# at a joint edit's rescoring (bs = 5, and 8 for each of three members),
# CONFIG 5's 10 rewired edges (bs = 20) and the weighted objective's 30
# modifiable edges (bs = 60), one member each. Every check holds the kernel
# against the plain version in f64 and allows MGS_TIMES what the einsum step
# errs by there (in f32 the f32 step; in f64 the f64 step on the rows in
# reverse order, its own rounding), or MGS_FLOOR machine epsilons of the
# largest entry if that is more.
MGS_WIDTHS = (("road", 250), ("road", 50), ("hub", 260))
MGS_WIDE = ((1, 5), (3, 8), (1, 20), (1, 60))  # (batch, bs) on the road graph
MGS_TIMES, MGS_FLOOR = 4.0, 64.0
MGS_STEPS = 20  # the default schedule's first three rounds
# w = vp·C + vc·D + δ·Z: the first MGS pass cancels all but δ of w, so
# rounding leaves about eps/δ of [vp, vc] in its result, which only the
# second pass removes
MGS_CANCEL = {torch.float32: 1e-4, torch.float64: 1e-6}


def _test_helpers():
    """tests/helpers.py, where the CPU tests' twin-node and breakdown
    fixtures live."""
    import importlib.util

    path = Path(__file__).resolve().parent / "tests" / "helpers.py"
    spec = importlib.util.spec_from_file_location("krt_test_helpers", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def mgs_start(dev, A, U, dtype):
    """A COO operator of A and the start state from blocks U (batch, n, bs),
    both in ``dtype`` on the card."""
    from krylov_robustness_torch.krylov import lanczos
    from krylov_robustness_torch.ops.sparse import CooMatrix

    op = CooMatrix.from_scipy(A, dtype=dtype, device=dev)
    state, _ = lanczos.lanczos_start(
        op, torch.as_tensor(U, dtype=dtype, device=dev))
    return op, state


def mgs_run(op, state, steps: int, step):
    """``steps`` block steps from ``state``, each through ``step`` (the
    wrapper ``block_mgs`` or the plain version); returns (vp, vc, w = A·vc,
    alive) of the next step, the stacked h and beta, and the blocks V_1 …
    V_{steps+1}."""
    from krylov_robustness_torch.krylov import lanczos

    vp, vc, alive = state
    hs, betas, blocks = [], [], [vc]
    for _ in range(steps):
        w = lanczos._spmm_nb(op, vc)
        q, h, beta, alive = step(vp, vc, w, alive, lanczos.LUCKY_TOL)
        vp, vc = vc, q.contiguous()  # the einsums may leave it permuted
        hs.append(h)
        betas.append(beta)
        blocks.append(vc)
    nxt = (vp, vc, lanczos._spmm_nb(op, vc), alive)
    return (nxt, torch.stack(hs) if steps else None,
            torch.stack(betas) if steps else None, blocks)


def mgs_advance(op, state, steps: int):
    """(vp, vc, w, alive) after ``steps`` steps of the plain version (so the
    inputs never rest on the kernel)."""
    from krylov_robustness_torch.ops.block_mgs import block_mgs_plain

    return mgs_run(op, state, steps, block_mgs_plain)[0]


def mgs_blocks(n: int, batch: int, bs: int, A=None):
    """Start blocks (batch, n, bs) of unit columns: a scoring call's [e_i,
    e_j] on ``batch`` edges of A at bs = 2, else ``bs`` distinct nodes a
    member (a joint edit's or a weighted problem's touched nodes); drawn
    with the seed 1000·bs + batch."""
    rng = np.random.default_rng(1000 * bs + batch)
    U = np.zeros((batch, n, bs))
    if bs == 2:
        C = sp.coo_matrix(sp.triu(A, 1))
        pick = rng.choice(C.nnz, batch, replace=False)
        U[np.arange(batch), C.row[pick], 0] = 1.0
        U[np.arange(batch), C.col[pick], 1] = 1.0
        return U
    for m in range(batch):
        U[m, rng.choice(n, bs, replace=False), np.arange(bs)] = 1.0
    return U


def mgs_inputs(dev, A, batch: int, dtype, bs: int = 2):
    """(vp, vc, w, alive) four plain steps into a recurrence from
    :func:`mgs_blocks`."""
    U = mgs_blocks(A.shape[0], batch, bs, A)
    return mgs_advance(*mgs_start(dev, A, U, dtype), 4)


def mgs_yardstick(inputs):
    """The einsum step on ``inputs``: in f32 as it stands, in f64 on the
    rows in reverse order (Q put back in order)."""
    from krylov_robustness_torch.krylov.lanczos import LUCKY_TOL
    from krylov_robustness_torch.ops.block_mgs import block_mgs_plain

    vp, vc, w, alive = inputs
    if w.dtype == torch.float32:
        return block_mgs_plain(vp, vc, w, alive, LUCKY_TOL)

    def flip(t):
        return t.flip(0).contiguous()

    q, h, beta, a = block_mgs_plain(flip(vp), flip(vc), flip(w), alive,
                                    LUCKY_TOL)
    return flip(q), h, beta, a


def mgs_gate(label: str, what: str, ek: float, ep: float, dtype) -> None:
    gate = max(MGS_TIMES * ep, MGS_FLOOR * torch.finfo(dtype).eps)
    check(ek <= gate, f"block_mgs {label} {what}: kernel {ek:.3e}, einsum "
          f"step {ep:.3e}, gate {gate:.3e}")


def mgs_orth(vs, q) -> float:
    """max |[vp, vc]ᵀ Q| over the members, in f64."""
    q = q.double()
    return max(float(torch.einsum("nbk,nbl->bkl", v.double(), q).abs().max())
               for v in vs)


def mgs_hold(label: str, inputs) -> dict:
    """The kernel chain on ``inputs`` (vp, vc, w, alive) twice (identical
    bits), against the plain version in f64 beside the einsum step
    (:func:`mgs_yardstick`): Q, h and beta, and Q's overlap with [vp, vc];
    returns the kernel's and the einsum step's errors and the kernel's
    outputs."""
    from krylov_robustness_torch.krylov.lanczos import LUCKY_TOL
    from krylov_robustness_torch.ops import block_mgs as bm

    vp, vc, w, alive = inputs
    dtype = w.dtype
    check(bm.on_kernel_path(vp, vc, w, alive),
          f"block_mgs {label}: the inputs do not take the kernel")
    out = bm.block_mgs_cuda(vp, vc, w, alive, LUCKY_TOL)
    again = bm.block_mgs_cuda(vp, vc, w, alive, LUCKY_TOL)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"block_mgs {label}: two runs differ")
    plain = mgs_yardstick(inputs)
    ref = bm.block_mgs_plain(vp.double(), vc.double(), w.double(), alive,
                             LUCKY_TOL)
    check(torch.equal(out[3], ref[3]) and torch.equal(plain[3], ref[3]),
          f"block_mgs {label}: alive kernel {out[3].tolist()} plain "
          f"{plain[3].tolist()} f64 {ref[3].tolist()}")
    errs, worst = {}, 0.0
    for i, name in enumerate(("Q", "h", "beta")):
        scale = float(ref[i].abs().max()) or 1.0
        diff = float((out[i].double() - ref[i]).abs().max())
        worst = max(worst, diff)
        errs[name] = (diff / scale,
                      float((plain[i].double() - ref[i]).abs().max()) / scale)
    errs["[vp vc]'Q"] = (mgs_orth((vp, vc), out[0]),
                         mgs_orth((vp, vc), plain[0]))
    for name, (ek, ep) in errs.items():
        mgs_gate(label, name, ek, ep, dtype)
    print(f"[block_mgs] {label}: identical reruns; kernel / einsum step "
          f"error against f64 over the largest entry: " + ", ".join(
              f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in errs.items()))
    return {"errs": errs, "out": out, "max_abs_err": worst}


def mgs_cancel(dev, inputs, seed: int):
    """``inputs`` with w replaced by vp·C + vc·D + δ·Z (C, D, Z seeded
    normal, Z's columns of norm 1, δ from :data:`MGS_CANCEL`)."""
    vp, vc, w, alive = inputs
    n, batch, bs = w.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    C, D = (torch.randn((batch, bs, bs), generator=g, device=dev,
                        dtype=torch.float64) for _ in range(2))
    Z = torch.randn((n, batch, bs), generator=g, device=dev,
                    dtype=torch.float64)
    Z = Z / Z.norm(dim=0, keepdim=True)
    w = (torch.einsum("nbk,bkl->nbl", vp.double(), C) +
         torch.einsum("nbk,bkl->nbl", vc.double(), D) +
         MGS_CANCEL[w.dtype] * Z)
    return vp, vc, w.to(vp.dtype).contiguous(), alive


def mgs_orth_loss(blocks) -> float:
    """max over the members of |VᵀV − I| for V = [V_1 … V_k], in f64; a
    deflated (zero) column counts against 0, not 1."""
    V = torch.cat([b.double() for b in blocks], dim=2)
    G = torch.einsum("nbk,nbl->bkl", V, V)
    d = torch.diagonal(G, dim1=-2, dim2=-1)
    eye = torch.diag_embed((d > 0.5).to(G.dtype))
    return float((G - eye).abs().max())


def mgs_recurrence(dev, label: str, A, U, dtype) -> None:
    """MGS_STEPS steps through the kernel (the wrapper, as lanczos_step
    calls it) and through the einsum step, each from the start state in
    ``dtype``, against the plain recurrence in f64 (in f64 the yardstick
    runs on the rows in reverse order): h, beta and the loss of
    orthogonality of all the blocks."""
    from krylov_robustness_torch.ops import block_mgs as bm

    n = A.shape[0]
    op, state = mgs_start(dev, A, U, dtype)
    _, h, beta, V = mgs_run(op, state, MGS_STEPS, bm.block_mgs)
    if dtype == torch.float32:
        _, hp, betap, Vp = mgs_run(op, state, MGS_STEPS, bm.block_mgs_plain)
    else:
        rev = np.arange(n)[::-1]
        Ar = sp.csr_matrix(A)[rev][:, rev]
        opr, stater = mgs_start(dev, Ar, U[:, rev], dtype)
        _, hp, betap, Vp = mgs_run(opr, stater, MGS_STEPS,
                                   bm.block_mgs_plain)
    op64, state64 = mgs_start(dev, A, U, torch.float64)
    _, h64, beta64, _ = mgs_run(op64, state64, MGS_STEPS, bm.block_mgs_plain)
    errs = {}
    for name, k, p, r in (("h", h, hp, h64), ("beta", beta, betap, beta64)):
        scale = float(r.abs().max()) or 1.0
        errs[name] = (float((k.double() - r).abs().max()) / scale,
                      float((p.double() - r).abs().max()) / scale)
    errs["|V'V - I|"] = (mgs_orth_loss(V), mgs_orth_loss(Vp))
    for name, (ek, ep) in errs.items():
        mgs_gate(f"{label}, {MGS_STEPS} steps", name, ek, ep, dtype)
    print(f"[block_mgs] {label}, {MGS_STEPS} steps through the chain: "
          f"kernel / einsum step against the f64 recurrence: " + ", ".join(
              f"{k} {a:.2e} / {b:.2e}" for k, (a, b) in errs.items()))


def mgs_time(label: str, inputs) -> dict:
    """CUDA-event medians of the kernel chain and the einsum step on
    ``inputs``, beside the least time: four blocks (vp, vc and w read, Q
    written) at 3.35 TB/s."""
    from krylov_robustness_torch.krylov.lanczos import LUCKY_TOL
    from krylov_robustness_torch.ops import block_mgs as bm

    vp, vc, w, alive = inputs
    kernel = cuda_ms(lambda: bm.block_mgs_cuda(vp, vc, w, alive, LUCKY_TOL),
                     reps=21, warmup=3)
    plain = cuda_ms(lambda: bm.block_mgs_plain(vp, vc, w, alive, LUCKY_TOL))
    least = 4 * w.numel() * w.element_size() / 3.35e12 * 1e3
    print(f"[block_mgs] {label}: kernel chain {kernel:.4f} ms, einsum step "
          f"{plain:.4f} ms ({plain / kernel:.1f}x), least {least:.4f} ms "
          f"(kernel at {100 * least / kernel:.1f}% of it)")
    return {"kernel_ms": kernel, "plain_ms": plain, "least_ms": least}


def phase_block_mgs(dev, graphs) -> dict:
    """The block step's kernel chains against the plain version on the
    card: f32 and f64 at the main paths' widths (narrow chain) and at the
    rescoring and weighted widths (wide chain), each also on a w that the
    first MGS pass nearly cancels; members dead on entry, twin nodes that
    deflate, members that break down fully; identical reruns; a
    MGS_STEPS-step recurrence through each chain; per-step times; then
    krylov.steps_kernel against krylov.steps_run, and the chain's launches,
    over a scoring call on each graph and a weighted-width call; on the
    scoring calls the rounds' carry widths, steps run against steps used,
    the members dropped, and Δ against the f64 plain reference."""
    from benchmark.reference.greedy import delta_trace_exp
    from krylov_robustness_torch.ops import block_mgs as bm
    from krylov_robustness_torch.ops.sparse import CooMatrix
    from krylov_robustness_torch.updates import trace_update as tu
    from krylov_robustness_torch.updates.trace_update import (
        trace_fun_update_batched,
        trace_fun_update_edges,
    )
    from krylov_robustness_torch.utils import tracing

    helpers = _test_helpers()
    road = graphs["road"]
    stats = {}
    cases = [(name, batch, 2) for name, batch in MGS_WIDTHS] + \
        [("road", batch, bs) for batch, bs in MGS_WIDE]
    for name, batch, bs in cases:
        A = graphs[name]
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).split(".")[-1]
            inputs = mgs_inputs(dev, A, batch, dtype, bs)
            label = f"{name} n={A.shape[0]} batch={batch} bs={bs} {tag}"
            held = mgs_hold(label, inputs)
            stats[label] = {"max_abs_err": held["max_abs_err"],
                            **mgs_time(label, inputs)}
            mgs_hold(f"{label}, w nearly in [vp vc]",
                     mgs_cancel(dev, inputs, batch * bs))
            if (batch, bs) not in ((50, 2), (3, 8)):
                continue
            vp, vc, w, alive = inputs  # members dead on entry
            alive = alive.clone()
            alive[::2 if batch == 3 else 5] = False
            q, h, beta, alive_next = mgs_hold(
                f"{label}, members dead on entry", (vp, vc, w, alive))["out"]
            dead = ~alive
            check(not bool(alive_next[dead].any()) and
                  not bool(h[dead].any()) and not bool(beta[dead].any()) and
                  not bool(q[:, dead].any()),
                  "block_mgs: a dead member emitted a nonzero block")

    # twin nodes: one column deflates after the first step, nobody breaks;
    # the wide chain's member holds both twin pairs beside two random columns
    T, U = helpers.twin_graph()
    Uw = np.concatenate([U[0], U[1], U[2]], axis=1)[None]  # (1, n, 6)
    # full breakdown: see helpers.breakdown_graph; e_0 breaks down in f64,
    # in f32 its residual may stay at rounding level, so f32 leaves it out
    D, V = helpers.breakdown_graph()
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split(".")[-1]
        op, state = mgs_start(dev, T, U, dtype)
        held = mgs_hold(f"twins {tag}, step 1", mgs_advance(op, state, 0))
        _, _, beta, alive = held["out"]
        check(bool(alive.all()), "block_mgs twins: a member broke down")
        check(not bool(beta[:2, 1, :].any()),
              "block_mgs twins: the dependent column did not deflate")
        op, state = mgs_start(dev, T, Uw, dtype)
        _, _, beta, alive = mgs_hold(f"twins wide bs=6 {tag}, step 1",
                                     mgs_advance(op, state, 0))["out"]
        check(bool(alive.all()), "block_mgs wide twins: the member broke")
        check(int((beta[0].abs().sum(dim=1) == 0).sum()) == 2,
              f"block_mgs wide twins: not two rows deflated: {beta[0]}")
        f64 = dtype == torch.float64
        op, state = mgs_start(dev, D, V if f64 else V[1:], dtype)
        for steps in range(4):
            alive = mgs_hold(f"breakdown {tag}, step {steps + 1}",
                             mgs_advance(op, state, steps))["out"][3]
            check(alive.tolist()[-3:] == [True, False, False],
                  f"block_mgs breakdown {tag}, step {steps + 1}: alive "
                  f"{alive.tolist()}")
        check(not (f64 and bool(alive[0])),
              "block_mgs breakdown f64: e_0's member is alive after 4 steps")

    n = road.shape[0]
    mgs_recurrence(dev, "road batch=50 bs=2 float32", road,
                   mgs_blocks(n, 50, 2, road), torch.float32)
    hub = graphs["hub"]
    mgs_recurrence(dev, "hub batch=260 bs=2 float32", hub,
                   mgs_blocks(hub.shape[0], 260, 2, hub), torch.float32)
    for dtype in (torch.float32, torch.float64):
        mgs_recurrence(dev, f"road batch=1 bs=60 {dtype}".replace(
            "torch.", ""), road, mgs_blocks(n, 1, 60), dtype)

    def grew_over(fn):
        keys = ("krylov.steps_kernel", "krylov.steps_run",
                "krylov.launches.MGS", "krylov.steps_used",
                "scorer.members_dropped")
        before = tracing.counters()
        out.append(fn())
        after = tracing.counters()
        return {k: after.get(k, 0) - before.get(k, 0) for k in keys}

    out = []
    cont = tu.lanczos_continue
    for cell in ("road.break_q250", "hub.break_q250_perstep"):
        A, edges, sigma, tol, limit = cell_first_step(cell)
        op = CooMatrix.from_scipy(A, dtype=torch.float32, device=dev)
        rounds = []

        def record(A, state, steps, *a, **kw):
            rounds.append((state.alive.shape[0], steps))
            return cont(A, state, steps, *a, **kw)

        with mock.patch.object(tu, "lanczos_continue", record):
            grew = grew_over(lambda: trace_fun_update_edges(
                op, edges, sign=-1.0, tol=tol, shift=sigma))
        ref, _ = delta_trace_exp(A, edges, sign=-1.0, shift=sigma,
                                 device=dev)
        gap = float(np.abs(out[-1].delta.numpy() - ref).max()) / \
            abs(float(ref.min()))
        dropped = grew["scorer.members_dropped"]
        print(f"[block_mgs] scoring call of {cell}'s first step, "
              f"{len(edges)} edges: {grew}; rounds (carry width, steps) "
              f"{rounds}; Δ gap to the f64 reference {gap:.3e} (limit "
              f"{limit:g})")
        check(grew["krylov.steps_kernel"] == grew["krylov.steps_run"] > 0,
              f"block_mgs: a step on {cell} did not take the kernel: {grew}")
        check(grew["krylov.steps_run"] == grew["krylov.steps_used"],
              f"scorer: {cell} ran steps no lag test read: {grew}")
        check(dropped > 0 if cell.startswith("road") else dropped == 0,
              f"scorer: {cell} dropped {dropped} members at round "
              f"boundaries, rounds {rounds}")
        check(gap <= limit, f"scorer: Δ on {cell} {gap:.3e} from the f64 "
              f"reference, beyond the cell's limit {limit:g}")
    op = CooMatrix.from_scipy(road, dtype=torch.float64, device=dev)
    U = torch.as_tensor(mgs_blocks(n, 1, 60), dtype=torch.float64,
                        device=dev)
    B = torch.zeros((1, 60, 60), dtype=torch.float64, device=dev)
    B[0, np.arange(0, 60, 2), np.arange(1, 60, 2)] = 0.5
    B = B + B.transpose(1, 2)
    grew = grew_over(lambda: trace_fun_update_batched(op, U, B, fun="sinh",
                                                      tol=1e-3))
    print(f"[block_mgs] weighted-width call on road, bs=60 f64: {grew}")
    check(grew["krylov.steps_kernel"] == grew["krylov.steps_run"] > 0 and
          grew["krylov.launches.MGS"] ==
          bm.LAUNCHES["wide"] * grew["krylov.steps_run"],
          f"block_mgs: a wide step did not take the kernel: {grew}")
    main = stats[f"road n={n} batch=250 bs=2 float32"]
    return {"max_abs_err": main["max_abs_err"], "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["least_ms"],
            "bound_by": "bytes", "library_ms": None}


# the main path's spectra shapes: (graph, candidates, sign of B) — road
# break at Q = 250 and 50, hub break at b = 520, hub make's positive B
STURM_CASES = (("road", 250, -1.0), ("road", 50, -1.0), ("hub", 260, -1.0),
               ("hub", 250, 1.0))
STURM_STEPS = 100  # the schedule's sum: M up to 200 at bs = 2
STURM_EIG_GATE = 1e-13  # over ‖G‖ (its largest |eigenvalue|)
STURM_DELTA_GATE = 1e-11  # relative, Δ = Σ exp(d1)(−expm1(d2 − d1))
# the FP64 pipes' instruction rate: 132 SMs × 64 a clock at 1.98 GHz (the
# 33.5 TFLOP/s data-sheet peak counts an FMA as two)
F64_RATE = 132 * 64 * 1.98e9


def sturm_ops(n: int, bs: int = 2) -> int:
    """f64 operations (an FMA, a division or a square root one each) that
    one n-column matrix needs on the kernel's path: each rotation of its
    band reduction (a² + b², the square root, the reciprocal, c and s; 4 a
    pair of entries left of and below the 2 × 2 block, 11 for the block),
    then ITERS sweeps of n steps for each of its n lanes (d − x, the
    division, the subtraction, the pivot's test, the count's test)."""
    from krylov_robustness_torch.ops.banded_sturm import ITERS, _rotations

    rot = sum(6 + 4 * (min(p - 1, k) + min(n - 2 - p, k)) + 11
              for k, p, _ in _rotations(n, 2 * bs - 1))
    return rot + n * ITERS * n * 5


def sturm_least_ms(n_act: int, m: int, m_lag: int, bs: int = 2) -> float:
    """The least time of a round at the FP64 pipes' rate: the four matrices
    (two of m·bs columns, two of m_lag·bs) of each candidate."""
    ops = 2 * sturm_ops(m * bs, bs) + 2 * sturm_ops(m_lag * bs, bs)
    return n_act * ops / F64_RATE * 1e3


def cell_first_step(workload: str):
    """(graph, candidates, σ, tolerance, ``delta_gap`` limit) of the first
    greedy step of a benchmark cell at structure seed 0, as
    ``benchmark/drivers/greedy.py`` makes them: the preprocessed stand-in,
    its first Q 'min' edges, the f32 σ shift and tolerance."""
    import importlib

    from benchmark.generators import protocol_inputs, run_graph
    from benchmark.harness import resolve
    from benchmark.reference import top_edges_min

    _, config, mix, _, _ = resolve(workload)
    generator = importlib.import_module(
        f"benchmark.generators.{config['generator']}")
    A = run_graph(config, generator, 0)
    lam, c = protocol_inputs(A)
    sigma = lam if mix["hub_shift"] and lam > 20.0 else 0.0
    tol = mix["tol"] * float(np.exp(lam - sigma))
    return (A, top_edges_min(A, c, mix["Q"]), sigma, tol,
            mix["limits"]["delta_gap"])


def sturm_edges(A, count: int, sign: float):
    """The main path's ``count`` candidates of A: the top existing edges for
    a break (sign −1), the top missing ones for a make (+1), by eigenvector
    centrality in the order ``min``, as the cells choose them (the scorer's
    Δ of an edge far from the leading eigenvector sits below its own
    rounding, exp(λmax)·eps·‖G‖)."""
    from krylov_robustness_torch.graphs.centrality import (
        compute_centrality_host,
    )
    from krylov_robustness_torch.graphs.top_edges import (
        find_top_edges,
        find_top_missing_edges,
    )

    c = compute_centrality_host(A, "eig")
    find = find_top_edges if sign < 0 else find_top_missing_edges
    return find(A, c, count, "min")


def sturm_lapack(h, beta, Cm, act, m: int, m_lag: int, pool):
    """(tG_lag, G_lag, tG, G) by host LAPACK on the scorer's bands, as the
    scorer computes them for CPU blocks."""
    from krylov_robustness_torch.updates import trace_update as tu

    band_t, band_g = tu._band_from_blocks(
        tu._to_host(h)[:, act], tu._to_host(beta)[:, act],
        Cm.cpu().numpy()[act], m, h.shape[-1])
    ML = m_lag * h.shape[-1]
    return (tu._eigvals_lapack(band_t[:, :, :ML], pool),
            tu._eigvals_lapack(band_g[:, :, :ML], pool),
            tu._eigvals_lapack(band_t, pool), tu._eigvals_lapack(band_g, pool))


def sturm_split(eig, M: int, ML: int):
    """The kernel's lanes [tG(M) | G(M) | tG(ML) | G(ML)] as the scorer's
    entry returns them: (tG_lag, G_lag, tG, G), each sorted, on the host."""
    eig = eig.cpu().numpy()
    return tuple(np.sort(p, axis=1) for p in (
        eig[:, 2 * M:2 * M + ML], eig[:, 2 * M + ML:], eig[:, :M],
        eig[:, M:2 * M]))


def sturm_hold(label: str, got, want, dense=None) -> tuple[float, float]:
    """Eigenvalues within STURM_EIG_GATE·‖G‖ of ``want``'s, matrix by
    matrix; Δ at the lag and at the round within STURM_DELTA_GATE relative,
    or, where Δ is too ill-conditioned for that (on the hub: an edge that
    moves the top eigenvalue by 1e-4 of it), within what the eigenvalue gate
    admits, STURM_EIG_GATE·‖G‖·Σ exp(λ) over both spectra. ``dense`` (the
    same four spectra by another solver, dense ``eigvalsh``) prints how far
    LAPACK's own solvers part on Δ. Returns the largest eigenvalue error
    over ‖G‖ and the largest relative Δ error."""
    from krylov_robustness_torch.updates.trace_update import (
        _trace_fun_difference_np,
    )

    worst, norms = 0.0, []
    for g, w in zip(got, want):
        check(g.shape == w.shape and np.isfinite(g).all(),
              f"spectra {label}: {g.shape} against {w.shape}, or not finite")
        norm = np.abs(w).max(axis=1, keepdims=True) if w.size else \
            np.zeros((len(w), 1))
        norms.append(norm)
        if not w.size:
            continue
        err = np.abs(g - w)
        rel = float((err / np.maximum(norm, 1e-300)).max())
        check(bool(np.all(err <= STURM_EIG_GATE * norm)),
              f"spectra {label}: eigenvalue error {rel:.3e} over ‖G‖")
        worst = max(worst, rel)
    dworst, tight, total, apart = 0.0, 0, 0, 0.0
    for a, b in ((0, 1), (2, 3)):
        if not want[a].size:
            continue
        x = _trace_fun_difference_np(got[a], got[b], "exp")
        y = _trace_fun_difference_np(want[a], want[b], "exp")
        err = np.abs(x - y)
        rel = err / np.maximum(np.abs(y), 1e-300)
        norm = np.maximum(norms[a], norms[b])[:, 0]
        admits = STURM_EIG_GATE * norm * (np.exp(want[a]).sum(axis=1) +
                                          np.exp(want[b]).sum(axis=1))
        past = err > np.maximum(STURM_DELTA_GATE * np.abs(y), admits)
        check(not past.any(), f"spectra {label}: Δ error "
              f"{float(rel[past].max()) if past.any() else 0.0:.3e} "
              f"relative, past what the eigenvalue gate admits")
        dworst = max(dworst, float(rel.max()))
        tight += int((err <= STURM_DELTA_GATE * np.abs(y)).sum())
        total += len(y)
        if dense is not None:
            z = _trace_fun_difference_np(dense[a], dense[b], "exp")
            apart = max(apart, float(np.max(np.abs(z - y) /
                                            np.maximum(np.abs(y), 1e-300))))
    if dense is not None:
        print(f"[spectra] {label}: Δ within {STURM_DELTA_GATE:.0e} relative "
              f"of LAPACK's for {tight} of {total}, the rest within the "
              f"eigenvalue gate's reach; worst {dworst:.2e}, where dense "
              f"eigvalsh parts from LAPACK by {apart:.2e}")
    return worst, dworst


def phase_spectra(dev, graphs) -> dict:
    """The spectra kernel (``ops/banded_sturm.py``, ``csrc/banded_sturm.cu``)
    on the card, at the main path's shapes (:data:`STURM_CASES`), on a
    100-step f32 recurrence of each, at every round boundary of the default
    schedule (M = 12 … 200), converged candidates left out from the second
    round on, members dead on entry and members broken down (lucky) at
    step 5: held against host LAPACK (every round) and the plain version on
    the card (three rounds of the first case, the third round of the
    others), two launches giving identical bits, a NaN that poisons its
    member's matrices only; the time a round beside its least time (the
    FP64 pipes' rate), the plain version's and LAPACK's; then, over a
    scoring call on each graph, ``spectra.members_kernel`` equals 4 × the
    candidates of every round, one launch a round, ``members_host`` 0."""
    import concurrent.futures

    from krylov_robustness_torch.krylov.lanczos import (
        lanczos_continue,
        lanczos_start,
    )
    from krylov_robustness_torch.ops import banded_sturm as bst
    from krylov_robustness_torch.ops.sparse import CooMatrix
    from krylov_robustness_torch.updates import trace_update as tu
    from krylov_robustness_torch.utils import tracing

    rounds = np.cumsum(tu.DEFAULT_SCHEDULE)
    lag = 2
    stats = {}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=8)
    for case, (name, batch, sign) in enumerate(STURM_CASES):
        A = graphs[name]
        edges = sturm_edges(A, batch, sign)
        op = CooMatrix.from_scipy(A, dtype=torch.float32, device=dev)
        U0 = tu.edge_start_blocks(A.shape[0], edges, torch.float32, dev)
        B = tu.edge_B(edges, sign, 1.0, torch.float32, dev)
        state, R0 = lanczos_start(op, U0)
        blocks, _ = lanczos_continue(op, state, STURM_STEPS)
        h, beta = blocks.h.clone(), blocks.beta.clone()
        R0n = tu._to_host(R0)
        Cm = np.einsum("bkl,blm,bpm->bkp", R0n, tu._to_host(B), R0n)
        # member 2 dead on entry (zero blocks, zero R0); members 1 and 4
        # broken down at step 5 (zero blocks from there on)
        h[:, 2], beta[:, 2], Cm[2] = 0.0, 0.0, 0.0
        beta[4:, [1, 4]] = 0.0
        h[5:, [1, 4]] = 0.0
        Cm = torch.from_numpy(Cm).to(dev)
        label0 = f"{name} batch={batch} sign={sign:+.0f}"
        for r, m in enumerate(int(x) for x in rounds):
            keep = np.arange(batch) if r == 0 else \
                np.nonzero(np.arange(batch) % (r + 1) == 0)[0]
            act = torch.as_tensor(keep.astype(np.int32), device=dev)
            M, ML = 2 * m, 2 * (m - lag)
            label = f"{label0} m={m} ({len(keep)} active)"
            out = bst.spectra_cuda(h, beta, Cm, act, m, m - lag)
            again = bst.spectra_cuda(h, beta, Cm, act, m, m - lag)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"spectra {label}: two launches "
                  f"differ")
            got = sturm_split(out, M, ML)
            tG, G = bst.projections(h.cpu(), beta.cpu(), Cm.cpu(),
                                    act.cpu(), m)
            dense = [torch.linalg.eigvalsh(X).numpy() for X in (
                tG[:, :ML, :ML], G[:, :ML, :ML], tG, G)]
            err, derr = sturm_hold(label, got, sturm_lapack(
                h, beta, Cm, keep, m, m - lag, pool), dense)
            line = (f"[spectra] {label}: identical reruns; against LAPACK "
                    f"{err:.2e} of ‖G‖, Δ {derr:.2e}")
            if (case == 0 and m in (6, 20, 100)) or (case and m == 20):
                sub = act[:8]
                plain = bst.spectra_plain(h, beta, Cm, sub, m, m - lag)
                perr, _ = sturm_hold(f"{label} plain",
                                     sturm_split(out[:8], M, ML),
                                     sturm_split(plain, M, ML))
                line += f"; against the plain version {perr:.2e}"
                stats["plain_err"] = max(stats.get("plain_err", 0.0), perr)
            if case == 0:
                ms = cuda_ms(lambda: bst.spectra_cuda(h, beta, Cm, act, m,
                                                      m - lag), reps=11)
                least = sturm_least_ms(len(keep), m, m - lag)
                line += (f"; {ms:.4f} ms a round, least {least:.4f} ms "
                         f"({100 * least / ms:.1f}%)")
            print(line)
        if case == 0:  # every candidate at rounds 1 and 3, timed
            every = torch.arange(batch, dtype=torch.int32, device=dev)
            for m in (6, 20):
                ms = cuda_ms(lambda: bst.spectra_cuda(h, beta, Cm, every, m,
                                                      m - lag), reps=21)
                least = sturm_least_ms(batch, m, m - lag)
                t0 = time.perf_counter()
                sturm_lapack(h, beta, Cm, np.arange(batch), m, m - lag, pool)
                lapack_ms = (time.perf_counter() - t0) * 1e3
                plain_ms = cuda_ms(lambda: bst.spectra_plain(
                    h, beta, Cm, every, m, m - lag), reps=1, warmup=1)
                print(f"[spectra] {label0} m={m}, all {batch}: kernel "
                      f"{ms:.4f} ms, least {least:.4f} ms "
                      f"({100 * least / ms:.1f}%), plain version "
                      f"{plain_ms:.1f} ms, host LAPACK {lapack_ms:.1f} ms "
                      f"(8 threads)")
                stats[f"m={m}"] = {"ms": ms, "least_ms": least,
                                   "plain_ms": plain_ms,
                                   "lapack_ms": lapack_ms}
            for m in (6, 20, STURM_STEPS):
                one = cuda_ms(lambda: bst.spectra_cuda(h, beta, Cm, every[:1],
                                                       m, m - lag), reps=5)
                print(f"[spectra] one candidate at m={m} (M = {2 * m}, "
                      f"{bst.plan(4 * (m - 1) * 2)[0]} CTAs): {one:.4f} ms, "
                      f"the chains alone")
            bad = h.clone()
            bad[10, 0, 3, 1] = float("nan")
            for m in (6, 20):
                act = torch.arange(batch, dtype=torch.int32, device=dev)
                clean = bst.spectra_cuda(h, beta, Cm, act, m, m - lag)
                poisoned = bst.spectra_cuda(bad, beta, Cm, act, m, m - lag)
                if m == 6:
                    check(torch.equal(clean, poisoned),
                          "spectra: a NaN past the round moved the spectra")
                else:
                    check(bool(poisoned[0].isnan().all()) and
                          torch.equal(clean[1:], poisoned[1:]),
                          "spectra: a NaN did not poison its member only")
            print("[spectra] a NaN at step 10 of member 0: NaN in its "
                  "matrices at m=20, nothing moved at m=6 or elsewhere")
    pool.shutdown()

    entry = tu._eigvals_banded_batch
    for name, sign in (("road", -1.0), ("hub", -1.0), ("hub", 1.0)):
        A = graphs[name]
        edges = sturm_edges(A, 250, sign)
        op = CooMatrix.from_scipy(A, dtype=torch.float32, device=dev)
        seen = []

        def record(h, beta, Cm, act, *rest):
            seen.append(len(act))
            return entry(h, beta, Cm, act, *rest)

        keys = ("spectra.members_kernel", "spectra.members_host",
                "spectra.launches.sturm")
        before = tracing.counters()
        with mock.patch.object(tu, "_eigvals_banded_batch", record):
            tu.trace_fun_update_edges(op, edges, sign=sign, tol=1e-3)
        after = tracing.counters()
        grew = {k: after.get(k, 0) - before.get(k, 0) for k in keys}
        print(f"[spectra] scoring call on {name}, 250 edges, sign "
              f"{sign:+.0f}: {grew}, candidates a round {seen}")
        check(grew == {"spectra.members_kernel": 4 * sum(seen),
                       "spectra.members_host": 0,
                       "spectra.launches.sturm": len(seen)} and seen,
              f"spectra: the scoring call on {name} did not take the "
              f"kernel every round: {grew}")
    main = stats["m=20"]
    return {"max_abs_err": stats["plain_err"], "ms": main["ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["least_ms"],
            "bound_by": "f64 operations", "library_ms": None,
            "lapack_ms": main["lapack_ms"]}


class MainPathCapture:
    """While active, keeps copies of the inputs of the last launch of each
    kernel at each (tiles, n, b, mode) the main path gives it, so that
    ``replay`` can hold every such shape, on the inputs it was launched on,
    against the plain version. The last launch carries the deepest Lanczos
    block, the densest x of the run. The kernels' row index (and K3's ELL
    columns) is frozen (edits change values only), so it is copied once per
    shape. Inside
    :meth:`pause` (the bench's timed lanes) it keeps nothing, so that it adds
    no device work to what is timed. The wrappers keep their own launch
    counts; this adds none."""

    def __init__(self):
        from krylov_robustness_torch.ops import banded_spmm, bsr, bsr_super

        self.mod, self.ell, self.flat = bsr_super, banded_spmm, bsr
        self.k1, self.k2 = bsr_super.tile_spmm_bf16, bsr_super.tile_spmm_full
        self.k3 = banded_spmm.ell_spmm
        self.k4 = bsr.bsr_spmm
        self.kept = {}
        self.paused = False

    @contextlib.contextmanager
    def pause(self):
        self.paused = True
        try:
            yield
        finally:
            self.paused = False

    def _keep(self, key, args, frozen: int = 0):
        """Copies of a launch's inputs ``args`` under ``key``. The first
        ``frozen`` of them (a row index) are copied again only when other
        tensors than the last launch's arrive."""
        if self.paused:
            return
        prev = self.kept.pop(key, None)
        head = args[:frozen]
        if prev is not None and all(a is b for a, b in zip(head, prev[0])):
            copies = prev[1][:frozen]
        else:
            copies = tuple(a.clone() for a in head)
        self.kept[key] = (head, copies + tuple(a.clone()
                                               for a in args[frozen:]))

    def __enter__(self):
        def k1(row_ptr, cols, val_off, vals, x, terms):
            self._keep(("K1", f"bf16x{terms}", vals.numel(), *x.shape),
                       (row_ptr, cols, val_off, vals, x), frozen=3)
            return self.k1(row_ptr, cols, val_off, vals, x, terms)

        def k2(row_ptr, cols, val_off, vals, x):
            label = "f32" if x.dtype == torch.float32 else "f64"
            self._keep(("K2", label, vals.numel(), *x.shape),
                       (row_ptr, cols, val_off, vals, x), frozen=3)
            return self.k2(row_ptr, cols, val_off, vals, x)

        def k3(cols, vals, row_ptr, entry_cols, val_off, x):
            label = "f32" if x.dtype == torch.float32 else "f64"
            self._keep(("K3", label, cols.shape[0], *x.shape),
                       (row_ptr, entry_cols, val_off, cols, vals, x),
                       frozen=4)
            return self.k3(cols, vals, row_ptr, entry_cols, val_off, x)

        def k4(row_ptr, cols, val_off, ablocks, x):
            label = "f32" if x.dtype == torch.float32 else "f64"
            self._keep(("K4", label, ablocks.shape[0], *x.shape),
                       (row_ptr, cols, val_off, ablocks, x), frozen=3)
            return self.k4(row_ptr, cols, val_off, ablocks, x)

        self.mod.tile_spmm_bf16, self.mod.tile_spmm_full = k1, k2
        self.ell.ell_spmm = k3
        self.flat.bsr_spmm = k4
        return self

    def __exit__(self, *exc):
        self.mod.tile_spmm_bf16, self.mod.tile_spmm_full = self.k1, self.k2
        self.ell.ell_spmm = self.k3
        self.flat.bsr_spmm = self.k4

    def replay(self) -> dict:
        """Each kept launch, rerun through its kernel and its plain version;
        returns the largest kernel-plain difference per kernel."""
        worst = {}
        for key, (_, args) in self.kept.items():
            kernel, label, size, n, b = key
            if kernel == "K3":
                row_ptr, entry_cols, val_off, cols, vals, x = args
                yk = self.k3(cols, vals, row_ptr, entry_cols, val_off, x)
                yp = self.ell.ell_spmm_plain(cols.long(), vals, x)
                where = f"{kernel} {label} K={size} n={n} b={b}"
            elif kernel == "K4":
                row_ptr, cols, val_off, ablocks, x = args
                blk = self.flat.BLK
                rb, cb = self._owners(row_ptr, cols, val_off, ablocks.shape)
                x_pad = torch.zeros((-(-n // blk) * blk, b), dtype=x.dtype,
                                    device=x.device)
                x_pad[:n] = x
                yk = self.k4(row_ptr, cols, val_off, ablocks, x)
                yp = self.flat.bsr_spmm_plain(ablocks, cb, rb, x_pad)[:n]
                where = f"{kernel} {label} blocks={size} n={n} b={b}"
            else:
                row_ptr, cols, val_off, vals, x = args
                if kernel == "K1":
                    terms = int(label[-1])
                    yk = self.k1(row_ptr, cols, val_off, vals, x, terms)
                    yp = self.mod.csr_spmm_bf16_plain(row_ptr, cols, val_off,
                                                      vals, x, terms)
                else:
                    yk = self.k2(row_ptr, cols, val_off, vals, x)
                    yp = self.mod.csr_spmm_full_plain(row_ptr, cols, val_off,
                                                      vals, x)
                where = f"{kernel} {label} values={size} n={n} b={b}"
            worst[kernel] = max(worst.get(kernel, 0.0),
                                self._check(where, label, x, yk, yp))
        return worst

    @staticmethod
    def _owners(row_ptr, cols, val_off, shape):
        """(row group, column group) of each block of ``shape`` (count,
        height, width), from a row index into its flattened storage: every
        entry lies in its own. One without entries (the packing's fill-in
        for an empty row group) is all zero, so it adds nothing wherever it
        is placed: (0, 0)."""
        count, height, width = shape
        n = row_ptr.numel() - 1
        rows = torch.repeat_interleave(
            torch.arange(n, device=row_ptr.device), torch.diff(row_ptr).long())
        t = val_off.long() // (height * width)
        rg = torch.zeros(count, dtype=torch.long, device=row_ptr.device)
        cg = torch.zeros_like(rg)
        rg[t] = rows // height
        cg[t] = cols.long() // width
        return rg, cg

    @staticmethod
    def _check(where, label, x, yk, yp) -> float:
        nonzero = float((x != 0).float().mean())
        check(nonzero > 0, f"main-path {where}: x is all zero, so the replay "
              f"checks nothing")
        diff = float((yk - yp).abs().max())
        scale = float(yp.abs().max())
        rel = diff / scale if scale else diff
        print(f"[replay] {where}, x {nonzero:.3f} nonzero: kernel-plain "
              f"{rel:.3e} (gate {GATES[label]:.0e})")
        check(diff <= GATES[label] * scale,
              f"main-path {where}: kernel vs plain {rel:.3e}")
        return diff


def protocol(A, dtype):
    """Centrality, σ and the absolute tolerance as the paper experiment takes
    them (experiments/unweighted.py:94-126 of the JAX package)."""
    from krylov_robustness_torch.funm.normest import normest2_host
    from krylov_robustness_torch.graphs.centrality import (
        compute_centrality_host,
    )

    c = compute_centrality_host(A, "eig")
    lognrm = float(normest2_host(A, tol=1e-2))
    f32 = dtype == torch.float32
    sigma = lognrm if (f32 and lognrm > 20.0) or lognrm > 600.0 else 0.0
    return c, lognrm, sigma, 1e-6 * float(np.exp(lognrm - sigma))


def same_picks_or_floor(label, ra, rb, tol, lane_floor=0.0):
    """Picks must be identical. A near-tie may flip a pick between two f32
    runs whose scores differ by rounding: then the runs must agree up to the
    first differing step, and there the committed Δ values must agree within
    twice the f32 acceptance floor — max(tol, 32·eps·|Δ|) of the per-step
    lane, and ``lane_floor`` (the fused lane's eigenvalue-noise floor) where
    a fused run takes part."""
    if np.array_equal(ra.edges, rb.edges):
        print(f"[{label}] picks identical ({len(ra.edges)} edges)")
        return
    s = int(np.argmax(np.any(ra.edges != rb.edges, axis=1)))
    check(s == 0 or np.array_equal(ra.edges[:s], rb.edges[:s]),
          f"{label}: runs differ before step {s}")
    da, db = float(ra.per_step_delta[s]), float(rb.per_step_delta[s])
    eps = float(np.finfo(np.float32).eps)
    floor = 2 * max(tol, 32 * eps * max(abs(da), abs(db)), lane_floor)
    print(f"[{label}] FLOOR FALLBACK: picks differ from step {s}: "
          f"{ra.edges[s].tolist()} Δ={da!r} vs {rb.edges[s].tolist()} "
          f"Δ={db!r}, |ΔΔ|={abs(da - db):.3e} <= floor {floor:.3e}?")
    check(abs(da - db) <= floor, f"{label}: Δ gap beyond the f32 floor")


def fused_floor(A, lognrm: float, sigma: float) -> float:
    """The fused lane's f32 eigenvalue-noise floor F32_FLOOR_REL·eps·gnorm·
    fscale (optimize/fused.py), with gnorm ≈ ‖A‖ and fscale ≈ Σ exp(λ−σ)
    over A's top eigenvalues."""
    import scipy.sparse.linalg as spla

    from krylov_robustness_torch.optimize.fused import F32_FLOOR_REL

    top = spla.eigsh(sp.csr_matrix(A, dtype=np.float64), k=6, which="LA",
                     return_eigenvectors=False)
    fscale = float(np.sum(np.exp(top - sigma)))
    return F32_FLOOR_REL * float(np.finfo(np.float32).eps) * lognrm * fscale


def step_ms(r) -> list:
    return [round(float(t) * 1e3, 2) for t in r.per_step_time]


def phase_road(dev, A) -> None:
    from krylov_robustness_torch.optimize.greedy import greedy_krylov

    c, lognrm, sigma, tol = protocol(A, torch.float32)
    print(f"[road] n={A.shape[0]} edges={A.nnz // 2} lognrm={lognrm:.4f} "
          f"sigma={sigma} tol={tol:.4e}")
    for mode, k in (("break", 10), ("make", 5)):
        before = launches("K1")
        r = greedy_krylov(A, k, 250, c, order="min", tol=tol, mode=mode,
                          dtype=torch.float32, backend="auto", shift=sigma,
                          fused_steps=10, device=dev)
        grew = launches("K1") - before
        print(f"[road] {mode} k={k} f32 auto: {r.operator}, fused steps "
              f"{r.fused_accepted}, K1 launches +{grew}, per-step ms "
              f"{step_ms(r)}")
        check(r.operator == "SuperBsrOperator(bf16x2)",
              f"road {mode} ran on {r.operator}")
        check(grew > 0, f"road {mode}: K1 was not launched")
        rc = greedy_krylov(A, k, 250, c, order="min", tol=tol, mode=mode,
                           dtype=torch.float32, backend="coo", shift=sigma,
                           fused_steps=10, device=dev)
        check(rc.operator == "CooMatrix", f"coo run used {rc.operator}")
        print(f"[road] {mode} k={k} f32 coo: per-step ms {step_ms(rc)}")
        same_picks_or_floor(f"road {mode} K1 vs coo", r, rc, tol)
    c64, _, sigma64, tol64 = protocol(A, torch.float64)
    before = launches("K2")
    r = greedy_krylov(A, 5, 250, c64, order="min", tol=tol64, mode="break",
                      dtype=torch.float64, backend="bsr", shift=sigma64,
                      device=dev)
    grew = launches("K2") - before
    rc = greedy_krylov(A, 5, 250, c64, order="min", tol=tol64, mode="break",
                       dtype=torch.float64, backend="coo", shift=sigma64,
                       device=dev)
    print(f"[road] break k=5 f64 bsr: {r.operator}, K2 launches +{grew}, "
          f"per-step ms {step_ms(r)}; coo per-step ms {step_ms(rc)}")
    check(r.operator == "SuperBsrOperator(f32)", f"f64 bsr ran on {r.operator}")
    check(grew > 0, "road f64: K2 was not launched")
    check(np.array_equal(r.edges, rc.edges),
          f"f64 K2 picks {r.edges.tolist()} != coo {rc.edges.tolist()}")
    print("[road] f64 K2 vs coo: picks identical")


def phase_hub(dev, A) -> None:
    from krylov_robustness_torch.optimize.greedy import greedy_krylov

    c, lognrm, sigma, tol = protocol(A, torch.float32)
    deg = np.asarray(A.sum(axis=1)).ravel()
    print(f"[hub] n={A.shape[0]} edges={A.nnz // 2} max degree "
          f"{int(deg.max())} lognrm={lognrm:.4f} sigma={sigma:.4f} "
          f"tol={tol:.4e}")
    check(lognrm > 20, "hub graph: lognrm <= 20, σ-shift would be off")
    before = launches("K1")
    t0 = time.perf_counter()
    r = greedy_krylov(A, 20, 250, c, order="min", tol=tol, mode="break",
                      dtype=torch.float32, backend="auto", shift=sigma,
                      fused_steps=10, device=dev)
    wall = time.perf_counter() - t0
    grew = launches("K1") - before
    fused_ms = float(np.median(r.per_step_time)) * 1e3
    print(f"[hub] break k=20 f32 fused_steps=10: {r.operator}, fused steps "
          f"{r.fused_accepted}/20, K1 launches +{grew}, median step "
          f"{fused_ms:.2f} ms, wall {wall:.2f} s")
    check(r.operator == "SuperBsrOperator(bf16x2)", f"hub ran on {r.operator}")
    check(r.fused_accepted > 0, "hub: no fused block was accepted")
    check(grew > 0, "hub: K1 was not launched")
    t0 = time.perf_counter()
    rs = greedy_krylov(A, 20, 250, c, order="min", tol=tol, mode="break",
                       dtype=torch.float32, backend="auto", shift=sigma,
                       fused_steps=0, device=dev)
    wall = time.perf_counter() - t0
    print(f"[hub] break k=20 f32 per-step: median step "
          f"{float(np.median(rs.per_step_time)) * 1e3:.2f} ms, wall "
          f"{wall:.2f} s")
    same_picks_or_floor("hub fused vs per-step", r, rs, tol,
                        fused_floor(A, lognrm, sigma))
    # the per-step lane on the plain COO SpMM: holds K1 on the hub graph
    # against an SpMM that shares no code with it
    rc = greedy_krylov(A, 20, 250, c, order="min", tol=tol, mode="break",
                       dtype=torch.float32, backend="coo", shift=sigma,
                       fused_steps=0, device=dev)
    check(rc.operator == "CooMatrix", f"coo run used {rc.operator}")
    print(f"[hub] break k=20 f32 per-step coo: median step "
          f"{float(np.median(rc.per_step_time)) * 1e3:.2f} ms")
    same_picks_or_floor("hub K1 vs coo", rs, rc, tol)


def write_mat(root: Path, collection: str, name: str, A) -> Path:
    """A graph as a v5 ``.mat`` (a ``Problem`` struct holding A) in the
    loader's layout under a data root (graphs/io.py)."""
    import scipy.io

    path = root / "datasets_paper" / collection / f"{name}.mat"
    path.parent.mkdir(parents=True, exist_ok=True)
    scipy.io.savemat(str(path), {"Problem": {"A": sp.csc_matrix(A)}})
    return path


def run_cli(argv) -> float:
    """The port's paper CLI, in this process (so that the launch counts
    see its kernels); returns its wall seconds."""
    from krylov_robustness_torch.experiments.__main__ import main as cli

    print(f"[cli] python -m krylov_robustness_torch.experiments "
          f"{' '.join(argv)}")
    t0 = time.perf_counter()
    check(cli(argv) == 0, f"the CLI failed: {argv}")
    return time.perf_counter() - t0


def phase_budget(dev, A, root: Path) -> None:
    """Figures 1-4: the budget sweep at Q = 50 on the road graph through the
    CLI (K3, per-step lane), then greedy_krylov with the sweep's arguments
    held against the COO backend."""
    from krylov_robustness_torch.funm.normest import normest2_host
    from krylov_robustness_torch.graphs.centrality import (
        compute_centrality_host,
    )
    from krylov_robustness_torch.graphs.preprocess import (
        preprocess_unweighted,
    )
    from krylov_robustness_torch.optimize.greedy import greedy_krylov

    name = "road_standin"
    write_mat(root, "Transport", name, A)
    out = root / "out"
    before = launches("K3")
    wall = run_cli(["--out-dir", str(out), "budget", "--mode",
                    "break", "--datasets", name, "--search-spaces", "50",
                    "--budgets", "5", "10"])
    grew = launches("K3") - before
    with open(next(out.glob("results_unweighted_break_budget_*.csv")),
              newline="") as f:
        rows = list(csv.DictReader(f))
    for r in rows:
        print(f"[budget] {r['method']} {r['dataset']} n={r['n']} m={r['m']} "
              f"searchspace={r['searchspace_size']} k={r['budget_size']} "
              f"time={float(r['time']):.3f} s "
              f"tr_variation={float(r['tr_variation']):.6e}")
    print(f"[budget] CLI wall {wall:.2f} s, K3 launches +{grew}")
    check(grew > 0, "budget sweep: K3 was not launched")
    check(len(rows) == 2, f"budget sweep wrote {len(rows)} rows, not 2")
    check(all(float(r["time"]) > 0 and float(r["tr_variation"]) < 0
              for r in rows), "budget sweep: a row has time <= 0 or "
          "tr_variation >= 0")

    # the sweep's own arguments (experiments/unweighted.py::run_budget_sweep)
    A = preprocess_unweighted(A)
    c = compute_centrality_host(A, "eig")
    lognrm = float(normest2_host(A, tol=1e-2))
    tol = 1e-6 * float(np.exp(lognrm))
    Q = min(A.nnz // 2 - 10, 50)
    kw = dict(order="min", tol=tol, mode="break", device=dev)
    r = greedy_krylov(A, 10, Q, c, dtype=torch.float32, fused_steps=10, **kw)
    # the sweep's request on COO takes the fused lane (COO has the fused
    # hooks); the per-step COO run holds K3 against COO on the same lane
    rc = greedy_krylov(A, 10, Q, c, dtype=torch.float32, fused_steps=10,
                       backend="coo", **kw)
    rs = greedy_krylov(A, 10, Q, c, dtype=torch.float32, fused_steps=0,
                       backend="coo", **kw)
    print(f"[budget] break k=10 Q={Q} f32 auto: {r.operator}, fused steps "
          f"{r.fused_accepted}, per-step ms {step_ms(r)}; coo fused_steps=10 "
          f"(fused steps {rc.fused_accepted}) per-step ms {step_ms(rc)}; coo "
          f"fused_steps=0 per-step ms {step_ms(rs)}")
    print(f"[budget] median step: K3 per-step "
          f"{float(np.median(r.per_step_time)) * 1e3:.2f} ms, coo per-step "
          f"{float(np.median(rs.per_step_time)) * 1e3:.2f} ms, coo fused "
          f"{float(np.median(rc.per_step_time)) * 1e3:.2f} ms")
    check(r.operator == "BandedEllOperator", f"budget ran on {r.operator}")
    check(r.fused_accepted == 0, "budget: the banded operator ran fused")
    check(rc.operator == "CooMatrix" and rs.operator == "CooMatrix",
          f"coo runs used {rc.operator}, {rs.operator}")
    same_picks_or_floor("budget K3 vs coo fused", r, rc, tol,
                        fused_floor(A, lognrm, 0.0))
    same_picks_or_floor("budget K3 vs coo per-step", r, rs, tol)
    r64 = greedy_krylov(A, 5, Q, c, dtype=torch.float64, backend="banded",
                        **kw)
    rc64 = greedy_krylov(A, 5, Q, c, dtype=torch.float64, backend="coo", **kw)
    print(f"[budget] break k=5 f64 banded: {r64.operator}, per-step ms "
          f"{step_ms(r64)}; coo per-step ms {step_ms(rc64)}")
    check(r64.operator == "BandedEllOperator", f"f64 ran on {r64.operator}")
    check(np.array_equal(r64.edges, rc64.edges),
          f"f64 K3 picks {r64.edges.tolist()} != coo {rc64.edges.tolist()}")
    print("[budget] f64 K3 vs coo: picks identical")


def phase_tables(A, root: Path) -> None:
    """Tables 2-3: the CLI's unweighted protocol on the hub graph: GKB, MIOBI
    and EIGENV rows on host f64 normalizers, and the intersections row."""
    name = "hub_standin"
    write_mat(root, "Misc", name, A)
    out = root / "out"
    wall = run_cli(["--out-dir", str(out), "unweighted", "--mode",
                    "break", "--datasets", name, "--k", "5"])
    path = next(p for p in out.glob("results_unweighted_break_*.jsonl")
                if "budget" not in p.name and "intersections" not in p.name)
    rows = [json.loads(line) for line in open(path) if line.strip()]
    for r in rows:
        print(f"[tables] {r['method']} {r['dataset']} n={r['n']} m={r['m']} "
              f"time={r['time']:.3f} s tr_variation={r['tr_variation']:.6e} "
              f"norm_lane={r['norm_lane']} sigma={r['sigma']:.4f}")
    with open(next(out.glob("results_unweighted_break_intersections_*.csv")),
              newline="") as f:
        inter = list(csv.DictReader(f))
    print(f"[tables] intersections {inter}, CLI wall {wall:.2f} s")
    check([r["method"] for r in rows] == ["GREEDY_KRYLOV_BREAK", "MIOBI",
                                          "EIGENV"],
          f"tables rows {[r['method'] for r in rows]}")
    check(all(np.isfinite(r["tr_variation"]) and r["tr_variation"] < 0
              for r in rows), "tables: a tr_variation is not finite and < 0")
    check(all(r["norm_lane"] == "host-f64" and r["sigma"] > 0 for r in rows),
          "tables: a row is not on the host f64 lane with σ > 0")
    check(len(inter) == 1 and inter[0]["dataset"] == name,
          f"tables: intersections {inter}")


def phase_bench(card: str, capture: MainPathCapture) -> None:
    """The port's bench through its entry point, in this process (so that
    the launch counts see its kernels), its JSON line printed as it is. The
    capture keeps nothing inside the bench's timed lanes, so that the
    bench's times are those it has alone, and the bench pauses no other
    process (``KRT_BENCH_NO_PAUSE``): another checkout's runs on the same
    machine go on."""
    from krylov_robustness_torch import bench

    def untraced(fn):
        def run(*args, **kwargs):
            with capture.pause():
                return fn(*args, **kwargs)
        return run

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for name in ("time_chain", "scoring_lane", "fused_lane"):
            stack.enter_context(mock.patch.object(
                bench, name, untraced(getattr(bench, name))))
        stack.enter_context(mock.patch.dict(os.environ,
                                            KRT_BENCH_NO_PAUSE="1"))
        stack.enter_context(contextlib.redirect_stdout(buf))
        code = bench.main([])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="")
    check(code == 0, f"the bench exited with {code}")
    payload = json.loads(out.strip().splitlines()[-1])
    print(f"[bench] python3 -m krylov_robustness_torch.bench: wall "
          f"{wall:.1f} s")
    keys = {"metric", "value", "unit", "vs_baseline", "greedy_step_ms",
            "greedy_step_shape", "greedy_scoring_ms", "card"}
    check(set(payload) == keys, f"bench payload keys {sorted(payload)}")
    check(payload["metric"] == "spmm_throughput_synthetic-road_b512",
          f"bench metric {payload['metric']}")
    check(payload["greedy_step_shape"] == "synthetic-hub_b250_bs2_fusedR10",
          f"bench greedy shape {payload['greedy_step_shape']}")
    check(payload["card"] == card, f"bench card {payload['card']!r}")
    check(all(np.isfinite(payload[k]) and payload[k] > 0
              for k in ("value", "vs_baseline", "greedy_step_ms",
                        "greedy_scoring_ms")),
          "bench: a number is not finite and > 0")


# -- weighted path (paper §6, Tables 5-6) ------------------------------------
# seeded stand-ins for voltage_adjacencies_average_2.mat: the smallest and the
# largest of the paper's power grids (n = 94, 3,684), and one grid between
# the n ≤ 130 dense fallback of fun_update and ndense = 500 of build_problem
GRIDS = {"grid94": (94, 1), "grid1200": (1200, 2), "grid3684": (3684, 3)}
METHODS = ("tuning", "rewire", "add")
# card f64 against the port's CPU f64 on the same inputs, relative to the
# CPU value's largest magnitude
WEIGHTED_GATES = {"objective": 1e-10, "gradient": 1e-9, "hessian": 1e-8,
                  "dfA": 1e-10, "dense": 1e-6, "score": 1e-6}


def grid_standin(n: int, seed: int, mean_degree: float = 2.7):
    """A weighted power-grid-like graph: n seeded points in the unit square,
    the Euclidean spanning tree of their Delaunay triangulation (connected,
    planar) plus its shortest other edges up to ``mean_degree``, weights
    uniform in [0.1, 1]."""
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import Delaunay

    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    tri = Delaunay(pts).simplices
    e = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [0, 2]]])
    e = np.unique(np.sort(e, axis=1), axis=0)
    length = np.linalg.norm(pts[e[:, 0]] - pts[e[:, 1]], axis=1)
    T = sp.coo_matrix(minimum_spanning_tree(
        sp.coo_matrix((length, (e[:, 0], e[:, 1])), shape=(n, n))))
    tree = set(zip(T.row.tolist(), T.col.tolist()))
    rest = [k for k in np.argsort(length, kind="stable")
            if (e[k, 0], e[k, 1]) not in tree]
    extra = e[rest[:int(round((mean_degree / 2 - 1) * n)) + 1]]
    E = np.concatenate([np.stack([T.row, T.col], 1), extra])
    A = sp.coo_matrix((rng.uniform(0.1, 1.0, len(E)), (E[:, 0], E[:, 1])),
                      shape=(n, n))
    return sp.csr_matrix(A + A.T)


def write_grids(root: Path) -> dict:
    """The stand-ins as one ``.mat`` in the layout ``load_power_grids``
    reads (one sparse matrix a grid); returns name → dense matrix as the
    loader gives it back."""
    import scipy.io

    from krylov_robustness_torch.graphs.io import load_power_grids

    path = root / "datasets_paper" / "voltage_adjacencies_average_2.mat"
    path.parent.mkdir(parents=True, exist_ok=True)
    scipy.io.savemat(str(path), {name: sp.csc_matrix(grid_standin(n, seed))
                                 for name, (n, seed) in GRIDS.items()})
    grids = load_power_grids()
    check(list(grids) == list(GRIDS), f"the loader read {list(grids)}")
    for name, Ad in grids.items():
        A = sp.csr_matrix(Ad)
        ncomp = sp.csgraph.connected_components(A, directed=False)[0]
        print(f"[weighted] {name}: n={A.shape[0]} edges={A.nnz // 2} mean "
              f"degree {A.nnz / A.shape[0]:.3f} components {ncomp} weights "
              f"{A.data.min():.3f}..{A.data.max():.3f}")
        check(ncomp == 1 and A.data.min() > 0, f"{name}: not connected or "
              f"a weight <= 0")
    return grids


def rel(a, b) -> float:
    """max|a − b| over max|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def gate(what: str, err: float, where: str) -> str:
    check(err <= WEIGHTED_GATES[what], f"{where}: {what} {err:.3e} over "
          f"{WEIGHTED_GATES[what]:.0e}")
    return f"{what} {err:.3e}"


@contextlib.contextmanager
def operators_seen():
    """The type of every operator that the Arnoldi and Lanczos steps and
    the expmv recurrence multiply with, while active."""
    from krylov_robustness_torch.funm import expmv
    from krylov_robustness_torch.krylov import arnoldi, lanczos

    seen = set()

    def spy(mod, name):
        fn = getattr(mod, name)

        def run(A, *args, **kwargs):
            seen.add(type(A).__name__)
            return fn(A, *args, **kwargs)
        return mock.patch.object(mod, name, run)

    with spy(arnoldi, "_spmm_batch"), spy(lanczos, "_spmm_nb"), \
            spy(expmv, "_expmv_core"):
        yield seen


class Problems:
    """While active, keeps every ``ContinuousProblem`` that
    ``experiments/weighted.py`` builds, by (n, method)."""

    def __enter__(self):
        from krylov_robustness_torch.experiments import weighted

        build = weighted.build_problem
        self.kept = {}

        def keep(A, M, c, method, **kw):
            self.kept[A.shape[0], method] = p = build(A, M, c, method, **kw)
            return p
        self._patch = mock.patch.object(weighted, "build_problem", keep)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def check_x(where: str, x, prob) -> None:
    """x within its bounds and the budget."""
    check(np.all(x >= prob.lb - 1e-8) and np.all(x <= prob.ub + 1e-8),
          f"{where}: x outside its bounds")
    check(np.sum(x) <= prob.budget + 1e-6, f"{where}: x over the budget")


def weighted_f64(dev, grids, root: Path) -> dict:
    """The continuous path in f64 on the card against the port's CPU f64 on
    the same inputs: build_problem, fun_and_grad and hessian on the n = 94
    and ~1,200 grids for each method (the objective also against a dense
    scipy expm), then run_country on every grid at maxiter = 20. Returns
    (grid, method) → the card's score in %."""
    import scipy.linalg

    from krylov_robustness_torch.experiments.weighted import (
        WEIGHTED_COLUMNS,
        run_country,
    )
    from krylov_robustness_torch.funm.normest import normest2_host
    from krylov_robustness_torch.graphs.centrality import compute_centrality
    from krylov_robustness_torch.graphs.preprocess import preprocess_weighted
    from krylov_robustness_torch.ops.sparse import CooMatrix
    from krylov_robustness_torch.optimize.continuous import (
        build_problem,
        fun_and_grad,
        hessian,
    )
    from krylov_robustness_torch.updates.low_rank import weights_to_low_rank
    from krylov_robustness_torch.utils.config import WeightedConfig
    from krylov_robustness_torch.utils.logging import ResultLog

    cpu = torch.device("cpu")
    for name in ("grid94", "grid1200"):
        Ad = preprocess_weighted(grids[name])
        A, n = sp.csr_matrix(Ad), Ad.shape[0]
        nrm = normest2_host(A)
        ops = {d: CooMatrix.from_scipy(A, device=d) for d in (dev, cpu)}
        cent = {d: compute_centrality(M, "eig") for d, M in ops.items()}
        tr0 = float(np.trace(scipy.linalg.expm(Ad)))
        for method in METHODS:
            where = f"{name} {method}"
            t0 = time.perf_counter()
            p = {d: build_problem(A, M, cent[d], method,
                                  tol=1e-12 * float(np.exp(nrm)))
                 for d, M in ops.items()}
            check(np.array_equal(p[dev].Omega, p[cpu].Omega)
                  and np.array_equal(p[dev].lb, p[cpu].lb)
                  and np.array_equal(p[dev].ub, p[cpu].ub),
                  f"{where}: Omega or bounds differ from the CPU's")
            errs = [f"Omega ({len(p[cpu].Omega)} edges) identical",
                    gate("dfA", rel(p[dev].dfA, p[cpu].dfA), where)]
            X = 0.3 * p[cpu].ub
            fg = {d: fun_and_grad(X, M, p[cpu].Omega, p[cpu].dfA, tol=1e-12,
                                  nrmA=nrm) for d, M in ops.items()}
            H = {d: hessian(X, A, p[cpu].Omega, tol=1e-12, device=d)
                 for d in ops}
            U, B, _ = weights_to_low_rank(p[cpu].Omega, X, n)
            dense = -(float(np.trace(scipy.linalg.expm(Ad + U @ B @ U.T)))
                      - tr0)
            errs += [gate("objective", rel(fg[dev][0], fg[cpu][0]), where),
                     gate("gradient", rel(fg[dev][1], fg[cpu][1]), where),
                     gate("hessian", rel(H[dev], H[cpu]), where),
                     gate("dense", rel(fg[dev][0], dense), where + " card"),
                     gate("dense", rel(fg[cpu][0], dense), where + " cpu")]
            print(f"[weighted] f64 card vs cpu, {where}, x = 0.3·ub: "
                  f"objective {fg[dev][0]:.12e} (dense expm {dense:.12e}); "
                  f"{'; '.join(errs)}; {time.perf_counter() - t0:.2f} s")

    scores = {}
    for lane, d in (("card", dev), ("cpu", cpu)):
        log = ResultLog(root / f"out_f64_{lane}", "weighted_exp_lbfgs",
                        columns=WEIGHTED_COLUMNS, key=("dataset", "method"))
        with Problems() as probs:
            for name in GRIDS:
                t0 = time.perf_counter()
                res = run_country(grids[name], name,
                                  WeightedConfig(maxiter=20), log,
                                  verbose=False, device=d)
                n = grids[name].shape[0]
                for method, r in res.items():
                    check_x(f"{lane} {name} {method}", r.x,
                            probs.kept[n, method])
                print(f"[weighted] run_country {name} f64 on the {lane}: "
                      f"{time.perf_counter() - t0:.2f} s")
        for row in log.rows:
            scores[lane, row["dataset"], row["method"]] = row
    for name in GRIDS:
        for method in METHODS:
            rc, rh = scores["card", name, method], scores["cpu", name, method]
            where = f"run_country {name} {method}"
            err = gate("score", rel(rc["score_pct"], rh["score_pct"]), where)
            print(f"[weighted] {where} f64: card {rc['score_pct']:.10f}% "
                  f"({rc['iterations']} it, {rc['time']:.2f} s), cpu "
                  f"{rh['score_pct']:.10f}% ({rh['iterations']} it, "
                  f"{rh['time']:.2f} s); {err}")
            check(rc["score_pct"] > 0, f"{where}: score <= 0")
    return {(name, method): scores["card", name, method]["score_pct"]
            for name in GRIDS for method in METHODS}


def weighted_cli(dev, grids, root: Path, f64: dict) -> None:
    """The CLI's weighted subcommand on cuda:0 (f32): every grid, then
    ``--hessian --fun sinh`` on the two smaller ones, each row printed
    beside the card's f64 score (the f32–f64 gap is reported, not gated)."""
    from krylov_robustness_torch.experiments.weighted import (
        WEIGHTED_COLUMNS,
        run_country,
    )
    from krylov_robustness_torch.utils.config import WeightedConfig
    from krylov_robustness_torch.utils.logging import ResultLog

    out = root / "out_weighted"
    small = ("grid94", "grid1200")
    wall = run_cli(["--out-dir", str(out), "weighted", "--countries", *GRIDS,
                    "--maxiter", "20"])
    print(f"[weighted] CLI exp lbfgs wall {wall:.2f} s")
    wall = run_cli(["--out-dir", str(out), "weighted", "--hessian", "--fun",
                    "sinh", "--countries", *small, "--maxiter", "20"])
    print(f"[weighted] CLI sinh hessian wall {wall:.2f} s")
    # the f64 reference of the sinh hessian rows, on the card
    log = ResultLog(root / "out_f64_sinh", "weighted_sinh_hessian",
                    columns=WEIGHTED_COLUMNS, key=("dataset", "method"))
    for name in small:
        for method, r in run_country(
                grids[name], name, WeightedConfig(fun="sinh", use_hessian=True,
                                                  maxiter=20),
                log, verbose=False, device=dev).items():
            f64[name, method, "sinh"] = float(next(
                row["score_pct"] for row in log.rows
                if row["dataset"] == name and row["method"] == method))
    for tag, key in (("exp_lbfgs", ()), ("sinh_hessian", ("sinh",))):
        with open(next(out.glob(f"results_weighted_{tag}_*.csv")),
                  newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == (9 if not key else 6),
              f"CLI {tag}: {len(rows)} rows")
        for r in rows:
            s = float(r["score_pct"])
            ref = f64[(r["dataset"], r["method"], *key)]
            print(f"[weighted] CLI {tag} f32 {r['dataset']} n={r['n']} "
                  f"{r['method']}: score {s:.6f}% (f64 {ref:.6f}%, gap "
                  f"{abs(s - ref) / abs(ref):.3e}) it {r['iterations']} "
                  f"time {float(r['time']):.2f} s")
            check(np.isfinite(s) and s > 0 and np.isfinite(float(r["time"])),
                  f"CLI {tag} {r['dataset']} {r['method']}: score {s}")


def vermont_problem(dev, A):
    """The search space of the JAX package's
    scripts/config5_sharded_sinh_rewire.py on one card: rewiring of
    trace(sinh(A)), COO f64, search space 30, 10 modifiable edges, ndense 0,
    expmv entries, build tol 1e-6·sinh(‖A‖). Returns (A as CSR f64, the
    operator, ‖A‖, the problem, its build seconds)."""
    from krylov_robustness_torch.funm.normest import normest2_host
    from krylov_robustness_torch.graphs.centrality import (
        compute_centrality_host,
    )
    from krylov_robustness_torch.ops.sparse import CooMatrix
    from krylov_robustness_torch.optimize.continuous import build_problem

    A = sp.csr_matrix(A, dtype=np.float64)
    M = CooMatrix.from_scipy(A, dtype=torch.float64, device=dev)
    nrm = normest2_host(A, tol=1e-2)
    c = compute_centrality_host(A, "eig")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob = build_problem(
        A, M, c, "rewire", fun="sinh", search_space=30, modifiable_edges=10,
        heur_order="min", total_weight=10.0, ndense=0,
        tol=1e-6 * float(np.sinh(nrm)), entries_method="expmv")
    return A, M, nrm, prob, time.perf_counter() - t0


def weighted_vermont(dev, A) -> dict:
    """:func:`vermont_problem` optimized at the script's maxiter = 50,
    checked against an independent objective and central differences of
    it. Returns the problem and the optimizer's result."""
    from krylov_robustness_torch.funm.expmv import (
        expmv,
        select_taylor_degree,
    )
    from krylov_robustness_torch.funm.trace import mc_trace
    from krylov_robustness_torch.optimize import continuous
    from krylov_robustness_torch.updates.low_rank import weights_to_low_rank
    from krylov_robustness_torch.updates.trace_update import (
        trace_fun_update_batched,
    )

    torch.cuda.reset_peak_memory_stats()
    A, M, nrm, prob, t_build = vermont_problem(dev, A)
    n = A.shape[0]
    calls = []
    fun_and_grad = continuous.fun_and_grad

    def timed(*args, **kwargs):
        t = time.perf_counter()
        out = fun_and_grad(*args, **kwargs)
        calls.append(time.perf_counter() - t)
        return out
    t0 = time.perf_counter()
    with mock.patch.object(continuous, "fun_and_grad", timed):
        res = continuous.optimize_weights(A, M, prob, fun="sinh", tol=1e-6,
                                          maxiter=50, nrmA=nrm)
    t_opt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nodes = len(np.unique(prob.Omega))
    print(f"[vermont] n={n} edges={A.nnz // 2} ‖A‖={nrm:.6f} rewire sinh: "
          f"{len(prob.Omega)} edges over {nodes} nodes; build "
          f"{t_build:.2f} s, optimize {t_opt:.2f} s ({res.iterations} it, "
          f"{len(calls)} fun_and_grad calls, median "
          f"{statistics.median(calls) * 1e3:.1f} ms, host outside them "
          f"{t_opt - sum(calls):.2f} s), peak device memory "
          f"{peak / 2**30:.3f} GiB; {res.message}")
    check_x("vermont", res.x, prob)
    check(-res.fval > 0, f"vermont: Δtrace {-res.fval} <= 0")

    def objective(x, tol):
        U, B, _ = weights_to_low_rank(prob.Omega, x, n)
        r = trace_fun_update_batched(
            M, torch.as_tensor(U, device=dev)[None],
            torch.as_tensor(B, device=dev)[None], fun="sinh",
            tol=tol * float(np.sinh(nrm)))
        return -float(r.delta[0])

    f_ind = objective(res.x, 1e-12)
    err = abs(res.fval - f_ind) / abs(f_ind)
    print(f"[vermont] objective at x {res.fval:.12e}, independent "
          f"trace_fun_update_batched (tol 1e-12·sinh‖A‖) {f_ind:.12e}: rel "
          f"{err:.3e} (gate 1e-6)")
    check(err <= 1e-6, f"vermont: objective off by {err:.3e}")
    _, g = continuous.fun_and_grad(res.x, M, prob.Omega, prob.dfA,
                                   fun="sinh", tol=1e-6, nrmA=nrm)
    h = 1e-4
    half = len(prob.Omega) // 2
    for k in (int(np.argmax(np.abs(g[:half]))),
              half + int(np.argmax(np.abs(g[half:])))):
        e = np.zeros_like(res.x)
        e[k] = h
        fd = (objective(res.x + e, 1e-12) - objective(res.x - e, 1e-12)) / (
            2 * h)
        err = abs(g[k] - fd) / abs(fd)
        print(f"[vermont] gradient[{k}] (edge {prob.Omega[k].tolist()}) "
              f"{g[k]:.10e}, central difference (h = {h}) {fd:.10e}: rel "
              f"{err:.3e} (gate 1e-4)")
        check(err <= 1e-4, f"vermont: gradient[{k}] off by {err:.3e}")
    plans = [select_taylor_degree(M, t=t, b_cols=10) for t in (1.0, -1.0)]
    tr_sinh, _, _ = mc_trace(
        lambda x: (expmv(M, x, t=1.0, plan=plans[0])
                   - expmv(M, x, t=-1.0, plan=plans[1])) / 2,
        n, tol=1e-3, maxit=1000, device=dev)
    print(f"[vermont] Δtrace sinh {-res.fval:.10e}, trace(sinh(A)) ≈ "
          f"{float(tr_sinh):.6e} (Hutchinson, tol 1e-3): score "
          f"{-res.fval / float(tr_sinh) * 100:.6f}%")
    return {"problem": prob, "result": res}


def phase_weighted(dev, road, root: Path, keep: dict) -> None:
    """Tables 5-6: the continuous path on the power-grid stand-ins (f64 on
    the card against the CPU, then the CLI in f32), then at Vermont's scale
    (its problem and result kept in ``keep['vermont']``); every operator it
    multiplies with is a ``CooMatrix``."""
    t0 = time.perf_counter()
    with operators_seen() as seen:
        grids = write_grids(root)
        f64 = weighted_f64(dev, grids, root)
        weighted_cli(dev, grids, root, f64)
        keep["vermont"] = weighted_vermont(dev, road)
    print(f"[weighted] operators {sorted(seen)}; path wall "
          f"{time.perf_counter() - t0:.1f} s")
    check(seen == {"CooMatrix"}, f"weighted path operators {sorted(seen)}")


# -- sharded path (the distributed layer) ------------------------------------
def sharded_one_rank(dev, A, root: Path) -> dict:
    """A 1-rank NCCL process group on the card: the multi-rank dry run, then
    the sharded backends on the road graph against the single-card ones —
    sharded_bsr in f32 (K1) and f64 (K2) against bsr, sharded (COO) f64
    against coo. Returns the f32 picks and step times."""
    import torch.distributed as dist

    from krylov_robustness_torch.optimize.greedy import greedy_krylov
    from krylov_robustness_torch.parallel import selfcheck
    from krylov_robustness_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{root}/nccl_store",
                            rank=0, world_size=1, device_id=dev)
    try:
        t0 = time.perf_counter()
        dry = selfcheck.dryrun(dev)
        print(f"[sharded] 1 rank (nccl): dry run on the n={dry['n']} example "
              f"graph, mesh {dry['mesh']}: sharded/sharded_bsr picks "
              f"{dry['edges'].tolist()} identical, operators "
              f"{dry['operators']}, fused steps {dry['fused']}, "
              f"rob_variation {dry['rob_variation']:.6e}, "
              f"{time.perf_counter() - t0:.1f} s")
        mesh = make_mesh(device=dev)
        c, _, sigma, tol = protocol(A, torch.float32)
        kw = dict(order="min", mode="break", mesh=mesh, fused_steps=0,
                  device=dev)
        before = launches("K1")
        rs = greedy_krylov(A, 3, 250, c, tol=tol, dtype=torch.float32,
                           backend="sharded_bsr", shift=sigma, **kw)
        grew = launches("K1") - before
        rb = greedy_krylov(A, 3, 250, c, tol=tol, dtype=torch.float32,
                           backend="bsr", shift=sigma, **kw)
        print(f"[sharded] 1 rank road break k=3 Q=250 f32: {rs.operator}, "
              f"K1 launches +{grew}, per-step ms {step_ms(rs)}; bsr "
              f"{rb.operator} per-step ms {step_ms(rb)}")
        check(rs.operator == "BsrRowShardedMatrix(bf16x2)",
              f"sharded f32 ran on {rs.operator}")
        check(grew > 0, "sharded f32: K1 was not launched")
        same_picks_or_floor("sharded 1-rank K1 vs bsr", rs, rb, tol)
        c64, _, sigma64, tol64 = protocol(A, torch.float64)
        kw64 = dict(kw, tol=tol64, dtype=torch.float64, shift=sigma64)
        before = launches("K2")
        rs64 = greedy_krylov(A, 2, 250, c64, backend="sharded_bsr", **kw64)
        grew = launches("K2") - before
        rb64 = greedy_krylov(A, 2, 250, c64, backend="bsr", **kw64)
        gap = abs(rs64.rob_variation - rb64.rob_variation) / abs(
            rb64.rob_variation)
        print(f"[sharded] 1 rank road break k=2 f64: {rs64.operator}, K2 "
              f"launches +{grew}, per-step ms {step_ms(rs64)}; bsr per-step "
              f"ms {step_ms(rb64)}; rob_variation {rs64.rob_variation!r} vs "
              f"{rb64.rob_variation!r} (rel {gap:.3e}, gate 1e-10)")
        check(grew > 0, "sharded f64: K2 was not launched")
        check(np.array_equal(rs64.edges, rb64.edges),
              f"sharded f64 picks {rs64.edges.tolist()} != bsr "
              f"{rb64.edges.tolist()}")
        check(gap <= 1e-10, f"sharded f64 rob_variation off by {gap:.3e}")
        rsc = greedy_krylov(A, 2, 250, c64, backend="sharded", **kw64)
        rc = greedy_krylov(A, 2, 250, c64, backend="coo", **kw64)
        print(f"[sharded] 1 rank road break k=2 f64 sharded COO: "
              f"{rsc.operator} per-step ms {step_ms(rsc)}; coo per-step ms "
              f"{step_ms(rc)}")
        check(np.array_equal(rsc.edges, rc.edges),
              f"sharded COO picks {rsc.edges.tolist()} != coo "
              f"{rc.edges.tolist()}")
    finally:
        dist.destroy_process_group()
    return {"f32": rs, "c": c, "tol": tol, "sigma": sigma}


def sharded_two_ranks(A, root: Path, card: str, one: dict, stats: dict):
    """Two gloo ranks spawned on the one card (NCCL takes one rank a GPU;
    gloo stages CUDA tensors through the host). The kernels were built
    before, so no rank runs nvcc. Each rank's checks are
    ``parallel/selfcheck.py::card_checks``; here both ranks' launches,
    products and picks are held, and the per-pass times printed beside the
    single-card kernel's at the same b."""
    from krylov_robustness_torch.parallel import selfcheck

    t0 = time.perf_counter()
    outs = selfcheck.launch(
        "card_checks", 2, root, timeout=600, device_kind="cuda", A=A, b=512,
        seed=3, gates=GATES,
        greedy_args=(3, 250, one["c"], one["tol"], one["sigma"]))
    for rank, out in enumerate(outs):
        for label, prod in out["products"].items():
            passes = "; ".join(
                f"{w} pass ({p['entries']} entries, x {p['x_rows']} rows "
                f"of which {p['x_read']} read, y {p['y_rows']}): kernel "
                f"{p['ms']:.4f} ms, plain {p['plain_ms']:.4f} ms, bound {p['bound_ms']:.4f} ms "
                f"({p['bound_by']}), kernel-plain {p['max_abs_err']:.3e}"
                for w, p in prod["passes"].items())
            print(f"[sharded] 2 ranks (gloo, one card) rank {rank} rows "
                  f"{prod['rows']} {label} b=512 on {card}: launches "
                  f"{prod['launches']} per product, rel err vs scipy "
                  f"{prod['err']:.3e}; {passes}; whole sharded product "
                  f"(gather included) {prod['sharded_ms']:.4f} ms")
        g = out["greedy"]
        print(f"[sharded] 2 ranks rank {rank}: coo/ell rel err "
              f"{out['errors']}; sharded_bsr break k=3 Q=250 f32 "
              f"{g['operator']} picks {g['edges'].tolist()} launches "
              f"{g['launches']} per-step ms "
              f"{[round(float(t) * 1e3, 2) for t in g['per_step_time']]} "
              f"wall {g['wall']:.1f} s")
        check(g["launches"]["K1"] > 0, f"rank {rank}: greedy K1 not "
              f"launched")
    for label, single in (("bf16x2", stats["road", "bf16x2", 512]),
                          ("f64", stats["road", "f64", 512])):
        print(f"[sharded] single-card {label} b=512 on {card}: kernel "
              f"{single['ms']:.4f} ms, bound {single['bound_ms']:.4f} ms "
              f"({single['bound_by']})")
    ra, rb = (SimpleNamespace(**o["greedy"]) for o in outs)
    check(np.array_equal(ra.edges, rb.edges), "the two ranks' picks differ")
    same_picks_or_floor("sharded 2 ranks vs 1 rank", ra, one["f32"],
                        one["tol"])
    print(f"[sharded] 2-rank phase wall {time.perf_counter() - t0:.1f} s")


def sharded_path(dev, A, root: Path, card: str, stats: dict) -> None:
    sharded_two_ranks(A, root, card, sharded_one_rank(dev, A, root), stats)


# -- CONFIG 5 on the row-sharded operator ------------------------------------
def config5_report(label: str, out: dict, card: str) -> None:
    """The ``[config5]`` lines of one rank's run."""
    ms = [e[3] * 1e3 for e in out["evals"]]
    c = out["costs"]
    tr_p, tr_m = out["traces"]
    print(f"[config5] {label} on {card}: {out['operator']} over "
          f"{out['world']} rank(s), {out['device']}; build "
          f"{out['time_build']:.2f} s, optimize {out['time_opt']:.2f} s "
          f"({out['iterations']} it, {len(ms)} fun_and_grad calls, median "
          f"{statistics.median(ms):.1f} ms); {out['message']}")
    print(f"[config5] {label}: Omega {out['Omega'].tolist()}; Taylor plans "
          f"(t, m, s, mu) {out['plans']}; fval {out['fval']!r}")
    print(f"[config5] {label}: one fun_and_grad at the optimum "
          f"{c['ms']:.1f} ms, of it {c['gathers']} all-gathers "
          f"{c['gather_ms']:.1f} ms ({100 * c['gather_share']:.1f}%); "
          f"profiled {c['profiled_ms']:.1f} ms, device busy "
          f"{100 * c['busy_share']:.1f}%; peak device memory of the run "
          f"{out['peak_bytes'] / 2**30:.3f} GiB")
    print(f"[config5] {label}: Δtrace sinh {-out['fval']:.10e}, "
          f"trace(sinh(A)) ≈ ({tr_p:.10e} − {tr_m:.10e})/2 = "
          f"{out['tr_sinh']:.10e} (Hutchinson over expmv, t = ±1, tol "
          f"1e-3): score {out['score'] * 100:.6f}%")


def phase_config5(dev, A, root: Path, card: str, vermont: dict) -> None:
    """The JAX package's CONFIG 5 (``scripts/config5_sharded_sinh_rewire.py``)
    through the port's driver, ``experiments/config5.py``, on the road graph
    written as ``Transport/road_standin.mat``, at the script's parameters
    (search space 30, 10 modifiable edges, maxiter 50, f64): a 1-rank NCCL
    process group in this process, held against phase 9's ``CooMatrix`` run
    of the same protocol, then 2 gloo ranks spawned on the card, held
    against each other and against the 1-rank run."""
    import torch.distributed as dist

    from krylov_robustness_torch.parallel import selfcheck

    t0 = time.perf_counter()
    write_mat(root, "Transport", "road_standin", A)
    kw = dict(dataset="road_standin", measure=True, device_kind="cuda")
    dist.init_process_group(
        "nccl", init_method=f"file://{root}/nccl_store_config5", rank=0,
        world_size=1, device_id=dev)
    try:
        with operators_seen() as seen:
            one = selfcheck.run_config5(rank=0, out_dir=root / "out_c5_1",
                                        **kw)
    finally:
        dist.destroy_process_group()
    config5_report("1 rank (nccl)", one, card)
    check(seen == {"RowShardedMatrix"}, f"config5: operators {seen}")
    with open(next((root / "out_c5_1").glob("results_config5_*.csv")),
              newline="") as f:
        rows = list(csv.DictReader(f))
    print(f"[config5] 1 rank: result row {rows}")
    check(len(rows) == 1 and rows[0]["n_devices"] == "1",
          f"config5: result rows {rows}")
    prob, res = vermont["problem"], vermont["result"]
    errs = {"dfA": rel(one["dfA"], prob.dfA),
            "fval": abs(one["fval"] - res.fval) / abs(res.fval)}
    print(f"[config5] 1 rank against phase 9's CooMatrix run: Omega "
          f"identical {np.array_equal(one['Omega'], prob.Omega)}, dfA rel {errs['dfA']:.3e} (gate 1e-10), fval {one['fval']!r} "
          f"vs {res.fval!r} rel {errs['fval']:.3e} (gate 1e-8), iterations "
          f"{one['iterations']} vs {res.iterations}")
    check(np.array_equal(one["Omega"], prob.Omega), "config5: Omega differs "
          "from the CooMatrix run's")
    check(errs["dfA"] <= 1e-10 and errs["fval"] <= 1e-8,
          f"config5 1 rank against CooMatrix: {errs}")
    check(one["iterations"] == res.iterations, "config5: iterations differ "
          "from the CooMatrix run's")
    check(np.isfinite(one["score"]) and one["score"] > 0,
          f"config5: score {one['score']}")

    t1 = time.perf_counter()
    outs = selfcheck.launch("run_config5", 2, root, timeout=600,
                            out_dir=root / "out_c5_2", **kw)
    for rank, out in enumerate(outs):
        config5_report(f"2 ranks (gloo, one card) rank {rank}", out, card)
        check(out["operator"] == "RowShardedMatrix" and out["world"] == 2,
              f"config5 rank {rank}: {out['operator']} over {out['world']}")
    a, b = outs
    same = {key: all(np.array_equal(u, v) for u, v in zip(
        np.atleast_1d(a[key]), np.atleast_1d(b[key])))
        for key in ("Omega", "dfA", "x", "fval", "iterations", "traces")}
    same["plans"] = a["plans"] == b["plans"]
    same["iterates"] = len(a["evals"]) == len(b["evals"]) and all(
        np.array_equal(ea[0], eb[0]) and ea[1] == eb[1]
        for ea, eb in zip(a["evals"], b["evals"]))
    gap = abs(a["fval"] - one["fval"]) / abs(one["fval"])
    print(f"[config5] 2 ranks: identical on both ranks {same}; fval "
          f"{a['fval']!r} against 1 rank {one['fval']!r}: rel {gap:.3e} "
          f"(gate 1e-8); Omega as 1 rank's: "
          f"{np.array_equal(a['Omega'], one['Omega'])}; phase wall "
          f"{time.perf_counter() - t1:.1f} s")
    check(all(same.values()), f"config5: the two ranks differ: {same}")
    check(gap <= 1e-8, f"config5: 2 ranks' fval off the 1 rank's by "
          f"{gap:.3e}")
    print(f"[config5] wall {time.perf_counter() - t0:.1f} s")


def phase_scaling(dev, A, card: str) -> None:
    """``measure_sharded_spmm`` at D = 1 on the road graph (one card holds
    one rank: a rate, not scaling), both layouts, b = 8 and 512, f32."""
    from krylov_robustness_torch.experiments.scaling import (
        measure_sharded_spmm,
    )

    t0 = time.perf_counter()
    for layout in ("coo", "ell"):
        for b in (8, 512):
            (dt, rate), = measure_sharded_spmm(
                A, mesh_sizes=[1], b=b, iters=20, dtype=torch.float32,
                layout=layout, device=dev).values()
            print(f"[scaling] road {layout} f32 b={b} D=1 on {card}: "
                  f"{dt * 1e3:.4f} ms a product, {rate / 1e9:.3f} Gnnz·b/s")
            check(np.isfinite(rate) and rate > 0, "scaling: no rate")
    print(f"[scaling] wall {time.perf_counter() - t0:.1f} s")


# the trace estimator's tol (1e-4) bounds the change between two of its
# iterations, not its error: on the CPU test graphs both packages missed the
# dense trace by up to ~4e-3 (tests/test_torch_trace_parity.py)
TRACE_GATE = 1e-2


def phase_surface(dev, graphs, root: Path) -> None:
    """The trace bench (f64 on the card) on the stand-ins written as .mat
    by the earlier paths and on a small one below the dense cutoff; the
    expmv parity row on that one; ``EllMatrix @ x`` against scipy."""
    from krylov_robustness_torch.experiments import parity, trace_bench
    from krylov_robustness_torch.graphs.preprocess import (
        preprocess_unweighted,
    )
    from krylov_robustness_torch.ops.sparse import EllMatrix
    from krylov_robustness_torch.parallel.selfcheck import example_graph

    t0 = time.perf_counter()
    small = example_graph(600, seed=3)
    write_mat(root, "Misc", "small_standin", small)
    out, _ = trace_bench.run(
        datasets=[("transport", "road_standin"), ("misc", "hub_standin"),
                  ("misc", "small_standin")], out_dir=root / "out_trace",
        verbose=False, device=dev)
    for label, (tr, dt, rel) in out.items():
        print(f"[surface] trace_exp {label} f64: trace {tr:.10e} in "
              f"{dt:.2f} s, rel err vs dense {rel}")
        check(np.isfinite(tr) and tr > 0, f"trace {label}: {tr}")
        check(isinstance(rel, str) or rel <= TRACE_GATE,
              f"trace {label}: rel err {rel} over {TRACE_GATE}")
    check(not isinstance(out["small_standin"][2], str),
          "trace: the small stand-in was not held against the dense trace")
    row = parity.expmv_parity_row("small_standin",
                                  preprocess_unweighted(small), device=dev)
    print(f"[surface] expmv parity small_standin n={row['n']} "
          f"cols={row['cols']}: max rel err {row['max_rel_err']:.3e} "
          f"(gate 1e-6)")
    check(row["max_rel_err"] <= 1e-6, "expmv parity over 1e-6")
    A = graphs["road"]
    x = np.random.default_rng(4).standard_normal((A.shape[0], 16))
    E = EllMatrix.from_scipy(A, dtype=torch.float64, device=dev)
    y = (E @ torch.as_tensor(x, device=dev)).cpu().numpy()
    ref = A @ x
    err = float(np.abs(y - ref).max() / np.abs(ref).max())
    print(f"[surface] EllMatrix road K={E.slots} f64 b=16: rel err vs "
          f"scipy {err:.3e} (gate 1e-12); wall "
          f"{time.perf_counter() - t0:.1f} s")
    check(err <= 1e-12, f"EllMatrix error {err:.3e}")


def launch_counts() -> dict:
    """Launches of each kernel in this process so far (the program's
    ``spmm.launches.K1`` … ``K4``, ``krylov.launches.MGS`` and
    ``spectra.launches.sturm`` counters), the member-steps that went through
    the block step's kernel chain (``krylov.steps_kernel``) as ``MGS
    steps``, and the candidate matrices whose spectra came from the Sturm
    kernel and from host LAPACK (``spectra.members_kernel`` and
    ``spectra.members_host``) as ``Sturm members`` and ``host members``."""
    from krylov_robustness_torch.utils import tracing

    counts = tracing.counters()
    out = {k: counts.get(f"spmm.launches.{k}", 0)
           for k in ("K1", "K2", "K3", "K4")}
    out["MGS"] = counts.get("krylov.launches.MGS", 0)
    out["MGS steps"] = counts.get("krylov.steps_kernel", 0)
    out["Sturm"] = counts.get("spectra.launches.sturm", 0)
    out["Sturm members"] = counts.get("spectra.members_kernel", 0)
    out["host members"] = counts.get("spectra.members_host", 0)
    return out


def launches(kernel: str) -> int:
    return launch_counts()[kernel]


def drive(path: str, fn, *args) -> dict:
    """One main path, with the launches of each kernel counted over it;
    returns the counts."""
    before = launch_counts()
    t0 = time.perf_counter()
    fn(*args)
    counts = {k: v - before[k] for k, v in launch_counts().items()}
    print(f"[{path}] launches {counts}, {time.perf_counter() - t0:.1f} s")
    return counts


def greedy_path(dev, graphs) -> None:
    phase_road(dev, graphs["road"])
    phase_hub(dev, graphs["hub"])


def run(dev, root: Path) -> int:
    from krylov_robustness_torch.bench import hub_graph, road_graph

    card = phase_device()
    phase_build()
    graphs = {"road": sp.csr_matrix(road_graph(), dtype=np.float64),
              "hub": hub_graph()}
    stats = phase_kernels(dev, graphs)
    stats.update(phase_road_kernels(dev, graphs["road"]))
    phase_flat_fallback(dev, graphs["hub"])
    phase_epinions_operator(dev)
    stats[("road", "MGS f32", 500)] = phase_block_mgs(dev, graphs)
    stats[("road", "Sturm f64", 250)] = phase_spectra(dev, graphs)
    with MainPathCapture() as capture:
        greedy = drive("greedy", greedy_path, dev, graphs)
        budget = drive("budget", phase_budget, dev, graphs["road"], root)
        tables = drive("tables", phase_tables, graphs["hub"], root)
        benched = drive("bench", phase_bench, card, capture)
        kept = {}
        weighted = drive("weighted", phase_weighted, dev, graphs["road"],
                         root, kept)
        sharded = drive("sharded", sharded_path, dev, graphs["road"], root,
                        card, stats)
        config5 = drive("config5", phase_config5, dev, graphs["road"], root,
                        card, kept["vermont"])
    phase_scaling(dev, graphs["road"], card)
    phase_surface(dev, graphs, root)
    check(sharded["K1"] and sharded["K2"],
          f"sharded path: a kernel was not launched: {sharded}")
    check(greedy["K1"] and greedy["K2"],
          f"greedy path: a kernel was not launched: {greedy}")
    for path, counts in (("greedy", greedy), ("budget", budget),
                         ("tables", tables), ("bench", benched),
                         ("sharded", sharded)):
        check(counts["MGS"] > 0,
              f"{path} path: no step went through block_mgs: {counts}")
    for path, counts in (("greedy", greedy), ("budget", budget)):
        check(counts["Sturm"] > 0 and counts["host members"] == 0,
              f"{path} path: a round's spectra did not take the Sturm "
              f"kernel: {counts}")
    check(budget["K3"] > 0, f"budget path: K3 was not launched: {budget}")
    check(tables["K1"] > 0, f"tables path: K1 was not launched: {tables}")
    check(benched["K4"] > 0 and benched["K1"] > 0,
          f"bench path: a kernel was not launched: {benched}")
    for path, counts in (("weighted", weighted), ("config5", config5)):
        check(not any(counts[k] for k in ("K1", "K2", "K3", "K4")),
              f"{path} path: an SpMM kernel was launched: {counts}")
        check(counts["MGS"] > 0,
              f"{path} path: no step went through block_mgs: {counts}")
    replayed = capture.replay()
    check("K4" in replayed, "replay: no K4 launch was kept")
    entries = (("K1", "K1 tile_spmm_bf16 (bf16x2)", greedy,
                ("road", "bf16x2", 512)),
               ("K2", "K2 tile_spmm_full (f64)", greedy,
                ("road", "f64", 512)),
               ("K3", "K3 ell_spmm (f32)", budget, ("road", "K3 f32", 100)),
               ("K4", "K4 bsr_spmm (f32)", benched, ("road", "K4 f32", 512)),
               ("MGS", "block_mgs step chain (f32)", greedy,
                ("road", "MGS f32", 500)),
               ("Sturm", "banded_sturm spectra (f64)", greedy,
                ("road", "Sturm f64", 250)))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[k],
         "replaces": REPLACES[k], "launches": counts[k],
         **({"member_steps": counts["MGS steps"]} if k == "MGS" else {}),
         **({"members": counts["Sturm members"],
             "lapack_ms": stats[key]["lapack_ms"]} if k == "Sturm" else {}),
         **{e: stats[key][e] for e in ENTRY_KEYS}}
        for k, name, counts, key in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    # the CLI reads its data root from the environment when graphs/io.py is
    # first imported: point it at a temporary root before anything does
    root = Path(tempfile.mkdtemp(prefix="krt_smoke_"))
    os.environ["KRYLOV_ROBUSTNESS_DATA"] = str(root)
    try:
        return run(torch.device("cuda", 0), root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
