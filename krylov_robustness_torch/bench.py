"""Benchmark of the port on one GPU — port of the root ``bench.py``::

    python3 -m krylov_robustness_torch.bench [--cpu]

SpMM throughput (nnz·b/s) on the largest paper transport network (Vermont
when the data root has it, else a seeded road stand-in of its scale), RCM
ordered, at the batch width the greedy scorer consumes (b = 512), for four
lanes: the plain COO SpMM (``coo``), K4 flat 128 × 128 BSR in f32
(``flat_f32``) and K1, the super-tile operator's kernel over its CSR-order
bf16 values, with x split into two or three bf16 terms (``super_bf16x2``,
``super_bf16x3``). Each lane runs a chain
of 50 products (each the previous output times 1/‖A‖∞) once to warm up, then
three times under CUDA events; its time is the best chain over 50. The best
lane whose relative error against the f64 host product is under 1e-5 gives
``value``; ``vs_baseline`` is the COO lane's time over its time.

Then two greedy lanes at the paper protocol's shape (ca-AstroPh when the
data root has it, else a seeded hub stand-in of its scale; Q = 250
candidates, 2 × 2 edge blocks): per-step scoring (``trace_fun_update_edges``
on COO, 6 runs, the first discarded; ``greedy_scoring_ms``) and the fused
greedy lane (``greedy_krylov`` k = 20, R = 10, ``backend='auto'``, f32;
``greedy_step_ms``, the median step after the first block).

Prints ONE JSON line on stdout, with the keys of the root ``bench.py`` and
``card`` (``nvidia-smi`` name and power limit). A table with each SpMM lane's
bound (the least time the card could take for y = A·x, A read as CSR) and
design time (the same bytes with the lane's stored tables in place of CSR)
goes to stderr. Runs on ``cuda:0`` unless given
``--cpu``; on the CPU only the COO lane runs, as the root ``bench.py`` does
off the TPU. While it runs, other processes of the port's paper CLI on the
card are paused (SIGSTOP, resumed at the end; ``KRT_BENCH_NO_PAUSE=1`` turns
that off).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import signal
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import scipy.sparse as sp
import torch

# H100 SXM at 700 W (NVIDIA's data sheet): HBM rate in GB/s, and the peak
# TFLOP/s of the unit each lane computes on
HBM_GBPS = 3350.0
PEAK_TFLOPS = {"ffma": 67.0, "dfma": 34.0}
B = 512
ITERS = 50
ACC_GATE = 1e-5
Q = 250
SCORING_REPS = 6
FUSED_K = 20
FUSED_STEPS = 10


@contextmanager
def competing_queues_paused():
    """SIGSTOP the port's own paper-CLI processes that run on the card
    (``krylov_robustness_torch.experiments`` without ``--cpu``) for the timed
    region: a concurrent greedy run would share the card. Always resumes
    them."""
    pids = []
    if os.environ.get("KRT_BENCH_NO_PAUSE"):
        yield
        return
    for pid in os.listdir("/proc"):
        if not pid.isdigit() or int(pid) == os.getpid():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if "krylov_robustness_torch.experiments" in cmd and "--cpu" not in cmd:
            pids.append(int(pid))
    for p in pids:
        try:
            os.kill(p, signal.SIGSTOP)
        except OSError:
            pass
    if pids:
        print(f"bench: paused competing queue pids {pids}", file=sys.stderr)
        time.sleep(3)  # let in-flight device work drain
    try:
        yield
    finally:
        for p in pids:
            try:
                os.kill(p, signal.SIGCONT)
            except OSError:
                pass


# -- graphs ------------------------------------------------------------------
def road_graph() -> sp.csr_matrix:
    """Synthetic banded road-network stand-in at Vermont's scale (n = 95,672,
    seed 0): a path with hops of 1 and 2 plus 15,000 random chords of up to
    300, symmetric, 0/1, no loops."""
    rng = np.random.default_rng(0)
    n = 95672
    i = np.arange(n - 2)
    src = np.concatenate([i, i, rng.integers(0, n - 301, 15000)])
    off = np.concatenate(
        [np.full(n - 2, 1), np.full(n - 2, 2), rng.integers(1, 300, 15000)])
    A = sp.coo_matrix((np.ones(len(src)), (src, off + src)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float32)
    A.setdiag(0)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    return A


def hub_graph() -> sp.csr_matrix:
    """Seeded Chung–Lu graph at ca-AstroPh's scale: 18,772 nodes, 198,000
    endpoint draws from power-law expected degrees (max 500, mean ≈ 21),
    then the paper preprocessing (binarize, no loops, largest component)."""
    from .graphs.preprocess import preprocess_unweighted

    rng = np.random.default_rng(0)
    n, m, dmax = 18772, 198000, 500.0
    for alpha in np.linspace(0.3, 1.2, 91):
        w = (np.arange(n) + 1.0) ** -alpha
        w *= dmax / w[0]
        if w.mean() <= 2 * m / n:
            break
    p = w / w.sum()
    src, dst = rng.choice(n, size=m, p=p), rng.choice(n, size=m, p=p)
    return preprocess_unweighted(
        sp.coo_matrix((np.ones(m), (src, dst)), shape=(n, n)))


def build_graph():
    """(A, name): Vermont, preprocessed, when the data root has it, else the
    road stand-in."""
    from .graphs.io import load_transport
    from .graphs.preprocess import preprocess_unweighted

    try:
        return preprocess_unweighted(load_transport("Vermont")), "Vermont"
    except FileNotFoundError:
        return road_graph(), "synthetic-road"


def greedy_graph():
    """(A, name): ca-AstroPh, preprocessed, when the data root has it, else
    the hub stand-in."""
    from .graphs.io import load_misc
    from .graphs.preprocess import preprocess_unweighted

    try:
        return preprocess_unweighted(load_misc("ca-AstroPh")), "ca-AstroPh"
    except FileNotFoundError:
        return hub_graph(), "synthetic-hub"


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# -- SpMM lanes --------------------------------------------------------------
# the tensors each operator's SpMM reads besides x, its values first. COO
# reads its nnz values whole; the row gathers (K1–K4; K3 for b ≥ 32) read nnz
# values out of their CSR-order, ELL or block storage through val_off.
_TABLES = {"CooMatrix": ("vals", "rows", "cols"),
           "BandedEllOperator": ("vals", "_row_ptr", "_cols", "_val_off"),
           "BsrOperator": ("ablocks", "row_ptr", "cols", "val_off"),
           "SuperBsrOperator": ("vals", "_row_ptr", "_cols", "_val_off")}


def table_bytes(op) -> int:
    """Bytes of the stored tables an operator's SpMM reads: its index
    tensors whole, and the nnz values it reads."""
    names = _TABLES[type(op).__name__]
    values, *index = (getattr(op, name) for name in names)
    return op.nnz * values.element_size() + sum(
        t.numel() * t.element_size() for t in index)


def function_bytes(op, n: int, nnz: int, b: int, x_size: int) -> int:
    """Bytes y = A·x must move however A is stored: A as CSR with ``op``'s
    value type (a value and an int32 column index a nonzero, n + 1 int32
    row pointers), x read once and y written once."""
    value_size = getattr(op, _TABLES[type(op).__name__][0]).element_size()
    return nnz * (value_size + 4) + (n + 1) * 4 + 2 * n * b * x_size


def speed_of_light_ms(nbytes: int, flops: float, unit: str):
    """(ms, 'bytes' or 'operations'): the larger of ``nbytes`` at the HBM
    rate and ``flops`` at the peak rate of ``unit``."""
    t_bytes = nbytes / (HBM_GBPS * 1e9) * 1e3
    t_ops = flops / (PEAK_TFLOPS[unit] * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bounds_ms(op, n: int, nnz: int, b: int, x_size: int, unit: str) -> dict:
    """The lane's bound — :func:`function_bytes` against 2·nnz·b at the peak
    of ``unit``, the least time the card could take for the product — and
    its design time, the same with the operator's stored tables in place of
    CSR (what a kernel that reads its tables once takes at best)."""
    flops = 2.0 * nnz * b
    bound, bound_by = speed_of_light_ms(
        function_bytes(op, n, nnz, b, x_size), flops, unit)
    design_bytes = table_bytes(op) + 2 * n * b * x_size
    return {"bound_ms": bound, "bound_by": bound_by,
            "design_bytes": design_bytes,
            "design_ms": speed_of_light_ms(design_bytes, flops, unit)[0]}


def _chain(op, x, iters: int, scale: float):
    for _ in range(iters):
        x = (op @ x) * scale
    return x


def time_chain(op, x, iters: int, scale: float) -> float:
    """Seconds per product: the best of three ``iters``-product chains
    (each product times ``scale``) after one warm-up chain, timed with CUDA
    events on the card. With ``scale`` = 1/‖A‖∞ no value of the chain
    overflows, and on a sparse graph none decays below f32's normal range
    (a fixed 1e-3, as on the TPU, makes x zero within ~20 products)."""
    _chain(op, x, iters, scale)
    best = math.inf
    for _ in range(3):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _chain(op, x, iters, scale)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3
        else:
            t0 = time.perf_counter()
            _chain(op, x, iters, scale)
            dt = time.perf_counter() - t0
        best = min(best, dt / iters)
    return best


def spmm_lanes(A, b: int, iters: int, device) -> list[dict]:
    """Each SpMM lane on the RCM-ordered ``A`` at width ``b``: its seconds per
    product (:func:`time_chain`), relative error against the f64 host
    product, bound and design time (:func:`bounds_ms`). On the CPU only the
    COO lane runs."""
    from .ops.banded_spmm import rcm_permutation
    from .ops.bsr import BsrOperator
    from .ops.bsr_super import SuperBsrOperator
    from .ops.sparse import CooMatrix
    from .utils.device import resolve_device

    dev = resolve_device(device)
    perm = rcm_permutation(A)
    Ap = sp.csr_matrix(A)[perm, :].tocsc()[:, perm].tocsr()
    n, nnz = Ap.shape[0], Ap.nnz
    x0 = np.random.default_rng(1).standard_normal((n, b)).astype(np.float32)
    ref = Ap @ x0.astype(np.float64)
    scale = 1.0 / float(abs(Ap).sum(axis=1).max())
    lanes = [("coo", "ffma",
              lambda: CooMatrix.from_scipy(Ap, dtype=torch.float32,
                                           device=dev))]
    if dev.type == "cuda":
        lanes += [
            ("flat_f32", "ffma",
             lambda: BsrOperator(Ap, dtype=torch.float32, device=dev)),
            ("super_bf16x2", "ffma",
             lambda: SuperBsrOperator(Ap, dtype=torch.float32, device=dev,
                                      mode="bf16x2")),
            ("super_bf16x3", "ffma",
             lambda: SuperBsrOperator(Ap, dtype=torch.float32, device=dev,
                                      mode="bf16x3")),
        ]
    x = torch.as_tensor(x0, device=dev)
    rows = []
    for tag, unit, make in lanes:
        op = make()
        acc = float(np.abs((op @ x).double().cpu().numpy() - ref).max()
                    / np.abs(ref).max())
        dt = time_chain(op, x, iters, scale)
        rows.append({"lane": tag, "s": dt, "acc": acc, "unit": unit,
                     **bounds_ms(op, n, nnz, b, x.element_size(), unit)})
        del op
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def spmm_payload(rows: list[dict], name: str, nnz: int, b: int) -> dict:
    """The root bench's headline: the best accurate lane's nnz·b/s and its
    speedup over the COO lane."""
    t_coo = next(r["s"] for r in rows if r["lane"] == "coo")
    t_best = min([t_coo] + [r["s"] for r in rows if r["acc"] < ACC_GATE])
    return {"metric": f"spmm_throughput_{name}_b{b}",
            "value": nnz * b / t_best / 1e9, "unit": "Gnnzb/s",
            "vs_baseline": t_coo / t_best}


def print_spmm_table(rows: list[dict], nnz: int, b: int) -> None:
    print(f"{'variant':<24}{'ms':>10}{'Gnnzb/s':>10}{'rel err':>11}"
          f"{'bound ms':>10}  {'bound by':<18}{'design MB':>10}"
          f"{'design ms':>10}", file=sys.stderr)
    for r in rows:
        print(f"{r['lane']:<24}{r['s'] * 1e3:>10.4f}"
              f"{nnz * b / r['s'] / 1e9:>10.2f}{r['acc']:>11.2e}"
              f"{r['bound_ms']:>10.4f}  "
              f"{r['bound_by'] + ' (' + r['unit'] + ')':<18}"
              f"{r['design_bytes'] / 1e6:>10.1f}{r['design_ms']:>10.4f}",
              file=sys.stderr)


# -- greedy lanes ------------------------------------------------------------
def greedy_protocol(A, Q: int):
    """(centrality, σ, absolute tolerance, top-Q candidate edges) as the
    root bench takes them: σ = ‖A‖ above 20, tol 1e-6·exp(‖A‖ − σ)."""
    from .funm.normest import normest2_host
    from .graphs.centrality import compute_centrality_host
    from .graphs.top_edges import find_top_edges

    lognrm = float(normest2_host(A, tol=1e-2))
    sigma = lognrm if lognrm > 20.0 else 0.0
    tol = 1e-6 * float(np.exp(lognrm - sigma))
    cent = compute_centrality_host(A, "eig")
    top = find_top_edges(A, cent, Q, "min")[:Q]
    return cent, sigma, tol, top


def scoring_lane(M, top, tol: float, sigma: float, reps: int):
    """Per-step scoring of the ``top`` candidates on the operator ``M``,
    ``reps`` times; returns (seconds of each run, the last result). Each run
    ends with its Δ on the host."""
    from .updates.trace_update import trace_fun_update_edges

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = trace_fun_update_edges(M, top, sign=-1.0, tol=tol, shift=sigma)
        float(r.delta[0])
        if M.device.type == "cuda":
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times, r


def fused_lane(A, cent, tol: float, sigma: float, device, Q: int, k: int,
               fused_steps: int):
    """The fused greedy lane in f32 with ``backend='auto'``; returns (median
    step seconds after the first block, or over all steps when there is one
    block, the result)."""
    from .optimize.greedy import greedy_krylov

    r = greedy_krylov(A, k=k, Q=Q, centrality=cent, order="min", tol=tol,
                      mode="break", dtype=torch.float32, backend="auto",
                      shift=sigma, fused_steps=fused_steps, device=device)
    steps = np.asarray(r.per_step_time)
    later = steps[fused_steps:] if len(steps) > fused_steps else steps
    return float(np.median(later)), r


def run(device, *, spmm_graph=None, scoring_graph=None, b: int = B,
        iters: int = ITERS, Q: int = Q, reps: int = SCORING_REPS,
        fused_k: int = FUSED_K, fused_steps: int = FUSED_STEPS) -> dict:
    """Both parts of the bench on ``device``; returns the JSON payload.
    ``spmm_graph`` and ``scoring_graph`` are (A, name) pairs, by default
    :func:`build_graph` and :func:`greedy_graph`."""
    from .ops.sparse import CooMatrix
    from .utils.device import resolve_device

    dev = resolve_device(device)
    A, name = spmm_graph or build_graph()
    rows = spmm_lanes(A, b, iters, dev)
    print_spmm_table(rows, A.nnz, b)
    payload = spmm_payload(rows, name, A.nnz, b)

    A2, name2 = scoring_graph or greedy_graph()
    cent, sigma, tol, top = greedy_protocol(A2, Q)
    M2 = CooMatrix.from_scipy(A2, dtype=torch.float32, device=dev)
    times, _ = scoring_lane(M2, top, tol, sigma, reps)
    shape = f"{name2}_b{len(top)}_bs2"
    scoring_ms = statistics.median(times[1:] or times) * 1e3
    print(f"greedy scoring latency ({shape}): {scoring_ms:.1f} ms (runs: "
          f"{[f'{t:.3f}' for t in times]})", file=sys.stderr)
    step_s, r = fused_lane(A2, cent, tol, sigma, dev, Q, fused_k, fused_steps)
    print(f"fused greedy step ({shape}, k={fused_k}, R={fused_steps}, "
          f"backend=auto, {r.operator}, {r.fused_accepted} fused steps): "
          f"{step_s * 1e3:.1f} ms", file=sys.stderr)
    payload.update(greedy_step_ms=step_s * 1e3,
                   greedy_step_shape=f"{shape}_fusedR{fused_steps}",
                   greedy_scoring_ms=scoring_ms,
                   card=card() if dev.type == "cuda" else "cpu")
    return payload


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="krylov_robustness_torch.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (COO lane only) instead of cuda:0")
    args = p.parse_args(argv)
    from .utils.device import require_full_f32_matmul, resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda:0")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        require_full_f32_matmul()
    with competing_queues_paused():
        payload = run(dev)
    print(json.dumps(payload))
    return 0


if __name__ == "__main__":
    sys.exit(main())
