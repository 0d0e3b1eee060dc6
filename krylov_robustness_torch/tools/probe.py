"""Probes of the greedy lanes on one GPU, beside ``chip_smoke.py``.

Run from the root of a checkout (the graphs and the paper protocol come from
``chip_smoke.py``)::

    python3 -m krylov_robustness_torch.tools.probe [solvers] [profile] \\
        [--out DIR]

``solvers``: the spectra solver of the f32 fused lane on the hub graph. One
fused block (k = 10) with the Sturm bisection (``eigvalsh_banded``, the
lane's solver) and one with batched ``torch.linalg.eigvalsh``, against the
per-step lane: wall time, fused steps accepted, picks. Then both solvers
timed with CUDA events on the stacked projections of the block's first
scoring round.

``profile``: ``torch.profiler`` over two per-step steps on the road and the
hub graph and over one fused block (k = 10) on the hub graph. Prints wall
time and device-busy time (the summed duration of the device's own events)
per run, and writes each run's table, sorted by device time, to
``DIR/profile_<run>.txt`` (default ``build/probe``).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch


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

    A = smoke.hub_graph()
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


def probe_profile(smoke, dev, out: Path) -> None:
    import scipy.sparse as sp
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ..optimize.greedy import greedy_krylov

    out.mkdir(parents=True, exist_ok=True)
    road = sp.csr_matrix(smoke.road_graph(), dtype=np.float64)
    hub = smoke.hub_graph()
    for name, A, k, fused_steps in (("road_break_perstep_k2", road, 2, 0),
                                    ("hub_break_perstep_k2", hub, 2, 0),
                                    ("hub_break_fused_k10", hub, 10, 10)):
        c, _, sigma, tol = smoke.protocol(A, torch.float32)
        _run(greedy_krylov, A, c, sigma, tol, dev, 1, 0)  # warm-up
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            r, wall = _run(greedy_krylov, A, c, sigma, tol, dev, k,
                           fused_steps)
        busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                      if e.device_type == DeviceType.CUDA)
        launches = sum(1 for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=40)
        (out / f"profile_{name}.txt").write_text(table)
        print(f"[profile] {name}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e3 / (wall * 1e3):.1f}%"
              f" of wall), device events {launches}, per-step ms "
              f"{[round(float(t) * 1e3, 2) for t in r.per_step_time]}")
        print("\n".join(table.splitlines()[:14]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("probes", nargs="*", choices=["solvers", "profile"],
                    help="default: both")
    ap.add_argument("--out", type=Path, default=Path("build/probe"))
    args = ap.parse_args(argv)
    args.probes = args.probes or ["solvers", "profile"]
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as smoke

    dev = torch.device("cuda", 0)
    smoke.phase_device()
    if "solvers" in args.probes:
        probe_solvers(smoke, dev)
    if "profile" in args.probes:
        probe_profile(smoke, dev, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
