#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``krylov_robustness_torch``) on one GPU.

Usage, from the root of a checkout on a machine with an sm_90a card::

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code 1):

1. device: the card's name and power limit, torch/CUDA versions, TF32 off;
2. build: compile the super-tile kernels K1/K2 from ``csrc/`` with nvcc;
3. kernels: each kernel against its plain torch version and scipy, with
   CUDA-event times beside the plain version's and the COO SpMM's, on a road
   network at Vermont's scale and a hub graph at ca-AstroPh's scale (both
   RCM-permuted), at b = 512 and at the main path's widths;
4. main path, road graph: ``greedy_krylov`` break/make on the per-step lane
   through K1 (f32) and K2 (f64), picks held against the plain COO backend;
5. main path, hub graph: the fused lane with σ-shift, picks held against the
   per-step lane, whose picks are held against the COO backend;
6. replay: the inputs of the last launch of each kernel at each shape of
   phases 4-5, rerun through the kernel and its plain version.

The line before the last is a JSON object with one entry per kernel (launch
counts of the main-path run, errors and times of phase 3); the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits with code 2
and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import scipy.sparse as sp
import torch

SOURCE = "krylov_robustness_torch/csrc/bsr_super.cu"
REPLACES = {
    "K1": "krylov_robustness_tpu/ops/pallas_bsr_super.py:97",
    "K2": "krylov_robustness_tpu/ops/pallas_bsr_super.py:82",
}
# relative to max|A x|: the first two mirror tests/test_pallas_bsr_super.py
GATES = {"bf16x2": 3e-5, "bf16x3": 3e-7, "f32": 1e-6, "f64": 1e-12}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def road_graph():
    """Synthetic banded road-network stand-in at Vermont's scale (the
    generator of bench.py::build_graph, n = 95,672, seed 0)."""
    rng = np.random.default_rng(0)
    n = 95672
    i = np.arange(n - 2)
    src = np.concatenate([i, i, rng.integers(0, n - 301, 15000)])
    off = np.concatenate(
        [np.full(n - 2, 1), np.full(n - 2, 2), rng.integers(1, 300, 15000)]
    )
    A = sp.coo_matrix((np.ones(len(src)), (src, off + src)), shape=(n, n))
    A = ((A + A.T) > 0).astype(np.float32)
    A.setdiag(0)
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    return A


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


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
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


def phase_build():
    from krylov_robustness_torch.ops import bsr_super

    path, seconds = bsr_super.build_kernels()
    print(f"[build] {path.name} built in {seconds:.2f} s")


# Kernel modes held against their plain versions in phase 3, per graph: every
# mode at b = 512, and the widths the main path gives the kernels — 2·Q = 500
# in a per-step scoring call, 2·(Q + R) = 520 in a fused block — in the modes
# it runs them (the capture of the main path checks that none is missed).
MODES = {"bf16x2": ("bf16x2", torch.float32), "bf16x3": ("bf16x3", torch.float32),
         "f32": ("f32", torch.float32), "f64": ("f32", torch.float64)}
KERNEL_CASES = {
    "road": (("bf16x2", (512, 500)), ("bf16x3", (512,)), ("f32", (512,)),
             ("f64", (512, 500))),
    "hub": (("bf16x2", (500, 520)), ("f32", (500,))),
}


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
            for b in widths:
                xh = x64[:, :b]
                if dtype == torch.float32:
                    xh = xh.astype(np.float32).astype(np.float64)
                ref = Ap @ xh
                scale = float(np.abs(ref).max())
                x = torch.as_tensor(xh, device=dev).to(dtype)
                yk = op.matmul(x)
                yp = op.matmul_plain(x)
                torch.cuda.synchronize()
                err_k = float(np.abs(yk.double().cpu().numpy() - ref).max())
                err_p = float(np.abs(yp.double().cpu().numpy() - ref).max())
                diff = float((yk - yp).abs().max())
                ms = cuda_ms(lambda: op.matmul(x))
                plain_ms = cuda_ms(lambda: op.matmul_plain(x))
                rate = nnz * b / (ms * 1e-3) / 1e9
                plain_rate = nnz * b / (plain_ms * 1e-3) / 1e9
                print(f"[kernels] {name} {label}: n={n} nnz={nnz} b={b} "
                      f"tiles={op.ntiles} kernel {ms:.4f} ms ({rate:.2f} "
                      f"Gnnz·b/s) plain {plain_ms:.4f} ms ({plain_rate:.2f} "
                      f"Gnnz·b/s); rel err vs scipy kernel {err_k / scale:.3e} "
                      f"plain {err_p / scale:.3e}; kernel-plain "
                      f"{diff / scale:.3e} (gate {GATES[label]:.0e})")
                where = f"{name} {label} b={b}"
                check(err_k <= GATES[label] * scale,
                      f"{where} kernel error {err_k / scale:.3e}")
                check(err_p <= GATES[label] * scale,
                      f"{where} plain error {err_p / scale:.3e}")
                check(diff <= GATES[label] * scale,
                      f"{where} kernel vs plain {diff / scale:.3e}")
                stats[name, label, b] = {"max_abs_err": diff, "ms": ms,
                                         "plain_ms": plain_ms}
                del x, yk, yp
            if (name, label) == ("road", "bf16x3"):
                # frozen-structure edit on the card, then a product
                C = sp.coo_matrix(sp.tril(Ap, -1))
                i, j = int(C.row[7]), int(C.col[7])
                op.set_edge(i, j, 0.0)
                A2 = Ap.tolil()
                A2[i, j] = A2[j, i] = 0.0
                xh = x64[:, :8].astype(np.float32).astype(np.float64)
                ref2 = sp.csr_matrix(A2) @ xh
                y2 = op.matmul(torch.as_tensor(xh, dtype=torch.float32,
                                               device=dev))
                err2 = float(np.abs(y2.double().cpu().numpy() - ref2).max()
                             ) / float(np.abs(ref2).max())
                print(f"[kernels] set_edge({i},{j}) then product: rel err "
                      f"{err2:.3e}")
                check(err2 <= GATES[label], f"set_edge product error {err2:.3e}")
            del op
            torch.cuda.empty_cache()
    return stats


class MainPathCapture:
    """While active, keeps a copy of the inputs of the last launch of each
    kernel at each (tiles, n, b, mode) the main path gives it, so that
    ``replay`` can hold every such shape against the plain version. The last
    launch carries the deepest Lanczos block, the densest x of the run. The
    wrappers keep their own launch counts; this adds none."""

    def __init__(self):
        from krylov_robustness_torch.ops import bsr_super

        self.mod = bsr_super
        self.k1, self.k2 = bsr_super.tile_spmm_bf16, bsr_super.tile_spmm_full
        self.kept = {}

    def _keep(self, key, args):
        self.kept.pop(key, None)
        self.kept[key] = tuple(a.clone() for a in args)

    def __enter__(self):
        def k1(atiles, slab, sup_ptr, blkmask, x, terms):
            self._keep(("K1", f"bf16x{terms}", atiles.shape[0], *x.shape),
                       (atiles, slab, sup_ptr, blkmask, x))
            return self.k1(atiles, slab, sup_ptr, blkmask, x, terms)

        def k2(atiles, slab, sup_ptr, blkmask, x):
            label = "f32" if x.dtype == torch.float32 else "f64"
            self._keep(("K2", label, atiles.shape[0], *x.shape),
                       (atiles, slab, sup_ptr, blkmask, x))
            return self.k2(atiles, slab, sup_ptr, blkmask, x)

        self.mod.tile_spmm_bf16, self.mod.tile_spmm_full = k1, k2
        return self

    def __exit__(self, *exc):
        self.mod.tile_spmm_bf16, self.mod.tile_spmm_full = self.k1, self.k2

    def replay(self) -> dict:
        """Each kept launch, rerun through its kernel and its plain version;
        returns the largest kernel-plain difference per kernel."""
        worst = {}
        for key, (atiles, slab, sup_ptr, blkmask, x) in self.kept.items():
            kernel, label, ntile, n, b = key
            nsup, tile_r = sup_ptr.numel() - 1, atiles.shape[1]
            sup = torch.repeat_interleave(
                torch.arange(nsup, device=x.device), torch.diff(sup_ptr))
            if kernel == "K1":
                terms = int(label[-1])
                yk = self.k1(atiles, slab, sup_ptr, blkmask, x, terms)
                yp = self.mod.tile_spmm_bf16_plain(atiles, slab, sup, x,
                                                   nsup * tile_r, terms)
            else:
                yk = self.k2(atiles, slab, sup_ptr, blkmask, x)
                yp = self.mod.tile_spmm_full_plain(atiles, slab, sup, x,
                                                   nsup * tile_r)
            diff = float((yk - yp).abs().max())
            scale = float(yp.abs().max())
            print(f"[replay] {kernel} {label} tiles={ntile} n={n} b={b}, "
                  f"x {float((x != 0).float().mean()):.3f} nonzero: "
                  f"kernel-plain {diff / scale:.3e} (gate "
                  f"{GATES[label]:.0e})")
            check(diff <= GATES[label] * scale,
                  f"main-path {kernel} {label} b={b}: kernel vs plain "
                  f"{diff / scale:.3e}")
            worst[kernel] = max(worst.get(kernel, 0.0), diff)
        return worst


def hub_graph():
    """Seeded Chung–Lu graph at ca-AstroPh's scale: 18,772 nodes, 198,000
    endpoint draws from power-law expected degrees (max 500, mean ≈ 21),
    then the paper preprocessing (binarize, no loops, largest component)."""
    from krylov_robustness_torch.graphs.preprocess import (
        preprocess_unweighted,
    )

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
    from krylov_robustness_torch.ops import bsr_super
    from krylov_robustness_torch.optimize.greedy import greedy_krylov

    c, lognrm, sigma, tol = protocol(A, torch.float32)
    print(f"[road] n={A.shape[0]} edges={A.nnz // 2} lognrm={lognrm:.4f} "
          f"sigma={sigma} tol={tol:.4e}")
    for mode, k in (("break", 10), ("make", 5)):
        before = bsr_super.launches_bf16
        r = greedy_krylov(A, k, 250, c, order="min", tol=tol, mode=mode,
                          dtype=torch.float32, backend="auto", shift=sigma,
                          fused_steps=10, device=dev)
        grew = bsr_super.launches_bf16 - before
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
    before = bsr_super.launches_f32
    r = greedy_krylov(A, 5, 250, c64, order="min", tol=tol64, mode="break",
                      dtype=torch.float64, backend="bsr", shift=sigma64,
                      device=dev)
    grew = bsr_super.launches_f32 - before
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
    from krylov_robustness_torch.ops import bsr_super
    from krylov_robustness_torch.optimize.greedy import greedy_krylov

    c, lognrm, sigma, tol = protocol(A, torch.float32)
    deg = np.asarray(A.sum(axis=1)).ravel()
    print(f"[hub] n={A.shape[0]} edges={A.nnz // 2} max degree "
          f"{int(deg.max())} lognrm={lognrm:.4f} sigma={sigma:.4f} "
          f"tol={tol:.4e}")
    check(lognrm > 20, "hub graph: lognrm <= 20, σ-shift would be off")
    before = bsr_super.launches_bf16
    t0 = time.perf_counter()
    r = greedy_krylov(A, 20, 250, c, order="min", tol=tol, mode="break",
                      dtype=torch.float32, backend="auto", shift=sigma,
                      fused_steps=10, device=dev)
    wall = time.perf_counter() - t0
    grew = bsr_super.launches_bf16 - before
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
    # the per-step lane on the plain COO SpMM: holds K1 on the hub's nearly
    # full tiles against an SpMM that shares no code with it
    rc = greedy_krylov(A, 20, 250, c, order="min", tol=tol, mode="break",
                       dtype=torch.float32, backend="coo", shift=sigma,
                       fused_steps=0, device=dev)
    check(rc.operator == "CooMatrix", f"coo run used {rc.operator}")
    print(f"[hub] break k=20 f32 per-step coo: median step "
          f"{float(np.median(rc.per_step_time)) * 1e3:.2f} ms")
    same_picks_or_floor("hub K1 vs coo", rs, rc, tol)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from krylov_robustness_torch.ops import bsr_super

    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    graphs = {"road": sp.csr_matrix(road_graph(), dtype=np.float64),
              "hub": hub_graph()}
    stats = phase_kernels(dev, graphs)
    with MainPathCapture() as capture:
        # the main path's launches: counts zeroed just before, read just after
        bsr_super.launches_bf16 = bsr_super.launches_f32 = 0
        phase_road(dev, graphs["road"])
        phase_hub(dev, graphs["hub"])
        launches = {"K1": bsr_super.launches_bf16,
                    "K2": bsr_super.launches_f32}
    check(all(launches.values()), f"a kernel was not launched: {launches}")
    capture.replay()
    print(json.dumps({"kernels": [
        {"name": "K1 tile_spmm_bf16 (bf16x2)", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES["K1"],
         "launches": launches["K1"], **stats["road", "bf16x2", 512]},
        {"name": "K2 tile_spmm_full (f64)", "route": "cuda",
         "source": SOURCE, "replaces": REPLACES["K2"],
         "launches": launches["K2"], **stats["road", "f64", 512]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
