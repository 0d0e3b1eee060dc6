"""Probes of the greedy lanes on one GPU, beside ``chip_smoke.py``.

Run from the root of a checkout (the graphs come from
:mod:`krylov_robustness_torch.bench`, the paper protocol from
``chip_smoke.py``)::

    python3 -m krylov_robustness_torch.tools.probe [solvers] [gather] \\
        [weighted] [--out DIR] [--variants NAME=VALUE[,...] ...]

``solvers``: the spectra solver of the f32 fused lane on the hub graph. One
fused block (k = 10) with the Sturm bisection (``eigvalsh_banded``, the
lane's solver) and one with batched ``torch.linalg.eigvalsh``, against the
per-step lane: wall time, fused steps accepted, picks. Then both solvers
timed with CUDA events on the stacked projections of the block's first
scoring round.

``gather``: the four kernels that share the row gather of
``csrc/row_gather.cuh`` (K1, K2, K3 at b ≥ 32, K4) at the smoke's phase-3
shapes, built into ``DIR/gather/<variant>/`` (default ``build/probe``)
from the checkout's sources
with their constants and types as they are and as each ``--variants`` entry
sets them (``UNROLL=8``, ``ROWS_PER_WARP=8,WARPS=2``, ``K2F32Sum=float``),
each held against the plain version and timed with CUDA events in turns
(every variant, then again in reverse order; the better time counts) beside
cuSPARSE; then each variant's K2 f32 error on the hub graph at b = 500 on
the smoke's second x.

``weighted``: ``torch.profiler`` over one ``fun_and_grad`` of the smoke's
Vermont-scale rewiring problem (``chip_smoke.vermont_problem``, f = sinh,
COO f64) at x = 0.3·ub, after one warm-up call: wall, device busy (the
union of the device's event intervals, ``utils/tracing.py``), and each
stage's host time and its span on the device timeline (the Arnoldi steps,
their COO products and CholQR, every ``eigh``, the Lanczos objective and its
products), table to ``DIR/weighted_fun_and_grad.txt``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..bench import hub_graph, road_graph
from ..utils import tracing


def _cuda_ms(fn, reps: int = 5) -> float:
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


def _run(greedy_krylov, A, c, sigma, tol, dev, k, fused_steps,
         backend="auto"):
    t0 = time.perf_counter()
    r = greedy_krylov(A, k, 250, c, order="min", tol=tol, mode="break",
                      dtype=torch.float32, backend=backend, shift=sigma,
                      fused_steps=fused_steps, device=dev)
    return r, time.perf_counter() - t0


def probe_solvers(smoke, dev) -> None:
    from ..funm.dense import eigvalsh_or_nan
    from ..optimize import fused
    from ..optimize.greedy import greedy_krylov

    A = hub_graph()
    c, _, sigma, tol = smoke.protocol(A, torch.float32)
    sturm = fused._spectra
    first = []

    def recording(stacked, bs):
        if not first:
            first.append((stacked.clone(), bs))
        return sturm(stacked, bs)

    def with_eigvalsh(stacked, bs):
        return eigvalsh_or_nan(stacked)

    runs = {}
    for name, solver in (("sturm", recording), ("eigvalsh", with_eigvalsh)):
        fused._spectra = solver
        try:
            runs[name] = _run(greedy_krylov, A, c, sigma, tol, dev, 10, 10)
        finally:
            fused._spectra = sturm
    runs["per-step"] = _run(greedy_krylov, A, c, sigma, tol, dev, 10, 0)
    for name, (r, wall) in runs.items():
        print(f"[solvers] hub break k=10 {name}: fused steps accepted "
              f"{r.fused_accepted}/10, wall {wall:.2f} s, picks "
              f"{r.edges.tolist()}")
    stacked, bs = first[0]
    ms_sturm = _cuda_ms(lambda: sturm(stacked, bs))
    ms_eigh = _cuda_ms(lambda: eigvalsh_or_nan(stacked))
    gap = float((sturm(stacked, bs) - eigvalsh_or_nan(stacked)).abs().max())
    scale = float(stacked.abs().amax())
    print(f"[solvers] stacked projections {tuple(stacked.shape)} f32: Sturm "
          f"{ms_sturm:.2f} ms, eigvalsh {ms_eigh:.2f} ms a call; largest "
          f"eigenvalue gap {gap:.3e} at scale {scale:.3e}")


GATHER_VARIANTS = ("UNROLL=2", "UNROLL=8", "ROWS_PER_WARP=1",
                   "ROWS_PER_WARP=8", "WARPS=1", "WARPS=2", "WARPS=8")
# each source's row-gather entries (all take six pointers, then n and b,
# then the stream; K1 takes the bf16 terms after b) and the kernel each
# launches: {f} is the dtype, f32 or f64
GATHER_ENTRIES = {"bsr_super": {"K1": "krt_bsr_super_bf16",
                                "K2": "krt_bsr_super_{f}"},
                  "banded_ell": {"K3": "krt_banded_gather_{f}"},
                  "bsr_flat": {"K4": "krt_bsr_flat_{f}"}}


def _gather_libs(out: Path, variants) -> dict:
    """variant → {kernel: (library, entry name)}, built from the checkout's
    sources with the row-gather constants of each variant, one nvcc per
    source, all started together."""
    from ..ops import cuda_build

    csrc = cuda_build.SOURCES["bsr_super"].parent
    builds = []
    for name in ("as-is", *variants):
        d = out / "gather" / name.replace("=", "").replace(",", "_")
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        files = {f: (csrc / f).read_text() for f in
                 ("row_gather.cuh", *(f"{src}.cu" for src in GATHER_ENTRIES))}
        for setting in () if name == "as-is" else name.split(","):
            key, value = setting.split("=")
            hits = 0
            for f, text in files.items():
                for pattern, new in ((rf"constexpr int {key} = \d+;",
                                      f"constexpr int {key} = {value};"),
                                     (rf"using {key} = \w+;",
                                      f"using {key} = {value};")):
                    text, k = re.subn(pattern, new, text)
                    hits += k
                files[f] = text
            if hits != 1:
                raise ValueError(f"the sources have no constant or type {key}")
        for f, text in files.items():
            (d / f).write_text(text)
        for src in GATHER_ENTRIES:
            builds.append((name, src, d / f"lib{src}.so", subprocess.Popen(
                [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                 str(d / f"lib{src}.so"), str(d / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, src, lib, proc in builds:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name} {src}:\n{log}")
        dll = ctypes.CDLL(str(lib))
        for kernel, entry in GATHER_ENTRIES[src].items():
            for f in ("f32", "f64"):
                fn = getattr(dll, entry.format(f=f))
                fn.argtypes = [ptr] * 6 + [i32] * (3 if kernel == "K1"
                                                   else 2) + [ptr]
                fn.restype = i32
            libs.setdefault(name, {})[kernel] = (dll, entry)
    return libs


def probe_gather(smoke, dev, out: Path, variants) -> None:
    import scipy.sparse as sp

    from ..ops.banded_spmm import BandedEllOperator, rcm_permutation
    from ..ops.bsr import BsrOperator
    from ..ops.bsr_super import SuperBsrOperator

    libs = _gather_libs(out, variants)

    def rcm(A):
        p = rcm_permutation(A)
        return sp.csr_matrix(A, dtype=np.float64)[p, :].tocsc()[:, p].tocsr()

    graphs = {"road": rcm(road_graph()), "hub": rcm(hub_graph())}
    f32, f64 = torch.float32, torch.float64
    # (graph, kernel, label) → (operator, widths)
    cases = {
        ("hub", "K1", "bf16x2"): (lambda A: SuperBsrOperator(
            A, dtype=f32, device=dev, mode="bf16x2"), (500, 520)),
        ("road", "K1", "bf16x2"): (lambda A: SuperBsrOperator(
            A, dtype=f32, device=dev, mode="bf16x2"), (512, 500)),
        ("road", "K1", "bf16x3"): (lambda A: SuperBsrOperator(
            A, dtype=f32, device=dev, mode="bf16x3"), (512,)),
        ("road", "K2", "f64"): (lambda A: SuperBsrOperator(
            A, dtype=f64, device=dev, mode="f32"), (512, 500)),
        ("hub", "K2", "f32"): (lambda A: SuperBsrOperator(
            A, dtype=f32, device=dev, mode="f32"), (500,)),
        ("road", "K2", "f32"): (lambda A: SuperBsrOperator(
            A, dtype=f32, device=dev, mode="f32"), (512,)),
        ("road", "K3", "f32"): (lambda A: BandedEllOperator(
            A, dtype=f32, device=dev), (100, 512)),
        ("road", "K3", "f64"): (lambda A: BandedEllOperator(
            A, dtype=f64, device=dev), (100,)),
        ("road", "K4", "f32"): (lambda A: BsrOperator(
            A, dtype=f32, device=dev), (1, 100, 500, 512)),
        ("road", "K4", "f64"): (lambda A: BsrOperator(
            A, dtype=f64, device=dev), (512,)),
    }

    def launch(name, kernel, op, x):
        """One product through variant ``name``'s entry of ``kernel``."""
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "K4":
            row_ptr, cols, val_off, vals = (op.row_ptr, op.cols, op.val_off,
                                            op.ablocks)
        else:
            row_ptr, cols, val_off = op._row_ptr, op._cols, op._val_off
            vals = op.vals
        dll, entry = libs[name][kernel]
        fn = getattr(dll, entry.format(f="f32" if x.dtype == f32 else "f64"))
        terms = (op._terms(),) if kernel == "K1" else ()
        code = fn(row_ptr.data_ptr(), cols.data_ptr(), val_off.data_ptr(),
                  vals.data_ptr(), x.data_ptr(), y.data_ptr(), op.n,
                  x.shape[1], *terms, stream)
        if code != 0:
            raise RuntimeError(f"{name} {kernel}: launch failed with CUDA "
                               f"error {code}")
        return y

    def held(kernel, op, x):
        """variant → max|kernel − plain| / max|plain| on x."""
        yp = op.matmul_plain(x)
        scale = float(yp.abs().max())
        return {name: float((launch(name, kernel, op, x) - yp).abs().max())
                / scale for name in libs}

    # x as the smoke's phase 3 draws it for each graph, so that each case is
    # held on the inputs the smoke holds it on
    x64 = {name: np.random.default_rng(1).standard_normal(
        (A.shape[0], 520 if name == "hub" else 512))
        for name, A in graphs.items()}
    for (graph, kernel, label), (make, widths) in cases.items():
        A = graphs[graph]
        op = make(A)
        for b in widths:
            x = torch.as_tensor(x64[graph][:, :b], device=dev,
                                dtype=f64 if label == "f64" else f32)
            errs = held(kernel, op, x)
            for name, err in errs.items():
                smoke.check(err <= smoke.GATES[label],
                            f"gather {name} {graph} {kernel} {label} b={b}: "
                            f"{err:.3e}")
            times = {name: [] for name in libs}
            for order in (list(libs), list(libs)[::-1]):
                for name in order:
                    times[name].append(smoke.cuda_ms(
                        lambda: launch(name, kernel, op, x), reps=15))
            lib_ms = smoke.library_ms(A, x)
            print(f"[gather] {graph} {kernel} {label} b={b}: cusparse "
                  f"{lib_ms:.4f} ms; " + "; ".join(
                      f"{name} {min(t):.4f} ms (err {errs[name]:.3e})"
                      for name, t in times.items()))
        del op
        torch.cuda.empty_cache()
    # hub K2 f32 at b = 500 on the smoke's second draw of x, where a
    # sequential f32 sum over a hub row sat at the gate: every variant's
    # error, gated for the sources as they are
    op = cases["hub", "K2", "f32"][0](graphs["hub"])
    x = torch.as_tensor(np.random.default_rng(2).standard_normal((op.n, 500)),
                        device=dev, dtype=f32)
    errs = held("K2", op, x)
    smoke.check(errs["as-is"] <= smoke.GATES["f32"],
                f"gather hub K2 f32 b=500 second x: {errs['as-is']:.3e}")
    print("[gather] hub K2 f32 b=500 second x (seed 2): " + "; ".join(
        f"{name} err {err:.3e}" for name, err in errs.items()))


def probe_weighted(smoke, dev, out: Path) -> None:
    import contextlib
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile, record_function

    from ..funm import dense
    from ..krylov import arnoldi, lanczos
    from ..optimize import continuous

    out.mkdir(parents=True, exist_ok=True)
    A, M, nrm, prob, _ = smoke.vermont_problem(dev, road_graph())
    x = 0.3 * prob.ub
    smoke.check(np.sum(x) <= prob.budget, "weighted probe: x over budget")

    def call():
        return continuous.fun_and_grad(x, M, prob.Omega, prob.dfA,
                                       fun="sinh", tol=1e-6, nrmA=nrm)

    # stage name → (module, function) wrapped in a profiler range
    stages = {"fun_update": (continuous, "fun_update"),
              "arnoldi_step": (arnoldi, "arnoldi_step"),
              "arnoldi_spmm": (arnoldi, "_spmm_batch"),
              "arnoldi_cholqr": (arnoldi, "_chol_qr"),
              "eigh": (dense, "eigh_or_nan"),
              "objective_trace_update": (continuous,
                                         "trace_fun_update_batched"),
              "lanczos_spmm": (lanczos, "_spmm_nb")}

    def ranged(name, fn):
        def run(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return run

    call()
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        for name, (mod, fn) in stages.items():
            stack.enter_context(mock.patch.object(
                mod, fn, ranged(name, getattr(mod, fn))))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    busy_us = tracing.device_busy_us(prof)
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40)
    (out / "weighted_fun_and_grad.txt").write_text(table)
    print(f"[weighted] fun_and_grad n={M.n} ({len(prob.Omega)} edges over "
          f"{len(np.unique(prob.Omega))} nodes): wall {wall * 1e3:.1f} ms, "
          f"device busy {busy_us / 1e3:.1f} ms "
          f"({100 * busy_us / 1e3 / (wall * 1e3):.1f}% of wall)")
    # each stage: its host range (CPU time inside it) and its range on the
    # device timeline (from its first kernel's start to its last's end)
    for ev in prof.key_averages():
        if ev.key in stages:
            dev_us = getattr(ev, "device_time_total",
                             getattr(ev, "cuda_time_total", 0.0))
            side = (f"host {ev.cpu_time_total / 1e3:.1f} ms"
                    if ev.cpu_time_total else
                    f"device span {dev_us / 1e3:.1f} ms")
            print(f"[weighted] {ev.key}: {ev.count} calls, {side}")
    print("\n".join(table.splitlines()[:16]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*",
                    choices=["solvers", "gather", "weighted"],
                    help="default: all three")
    ap.add_argument("--out", type=Path, default=Path("build/probe"))
    ap.add_argument("--variants", nargs="*", default=GATHER_VARIANTS,
                    help="row-gather constants for the gather probe")
    args = ap.parse_args(argv)
    args.probes = args.probes or ["solvers", "gather", "weighted"]
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as smoke

    dev = torch.device("cuda", 0)
    smoke.phase_device()
    if "solvers" in args.probes:
        probe_solvers(smoke, dev)
    if "gather" in args.probes:
        probe_gather(smoke, dev, args.out, args.variants)
    if "weighted" in args.probes:
        probe_weighted(smoke, dev, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
