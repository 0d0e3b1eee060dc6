"""Driver of the weighted protocols (paper §6, Tables 5–6; CONFIG 5, the
JAX package's ``scripts/config5_sharded_sinh_rewire.py``) through the
port's ``optimize/continuous.py``, on the row-sharded operator
``parallel/spmm_sharded.py::RowShardedMatrix`` as
``experiments/config5.py::run`` builds it.

Set-up makes the graph (``generators.run_graph``: the configuration's
stand-in, its nodes relabeled by the seed), its ‖A‖ and eigenvector centrality,
joins a process group of ``ranks`` ranks (one here: NCCL on the card, gloo
on the CPU, at a free localhost port), builds the operator once and warms
up with one solve. A solve is ``build_problem`` then ``optimize_weights``;
the window runs whole solves back to back until its length is reached. The
program's objective and gradient at the weights a solve returns are the
last ``fun_and_grad`` evaluation there, which the driver records. The check
recomputes the search space and that objective and gradient with the plain
reference (``reference/weighted.py``), and asks with the reference's
gradient whether the returned weights solve the problem.
"""

from __future__ import annotations

import socket
import time

import numpy as np
import torch
import torch.distributed as dist

from ..generators import protocol_inputs, run_graph
from ..reference import weighted as ref

NUMBERS = ("omega_mismatch", "fval_gap", "grad_gap", "opt_gap")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class WeightedDriver:
    unit = "solve"

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 generator):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generator = generator
        self.solves = []  # (Omega, x, fval, iterations, gradient at x)
        self._evals = []
        self._joined = False
        self._truth = None  # the reference's Omega, f and g

    def setup(self, log):
        from krylov_robustness_torch.optimize import continuous
        from krylov_robustness_torch.parallel.mesh import make_mesh
        from krylov_robustness_torch.parallel.spmm_sharded import \
            RowShardedMatrix

        mix = self.mix
        self.log = log
        self.A = run_graph(self.config, self.generator, self.seed)
        self.lam, self.centrality = protocol_inputs(self.A)
        if mix["ranks"] != 1:
            raise ValueError("this driver runs one rank a process")
        if not dist.is_initialized():
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            dist.init_process_group(
                "nccl" if self.device.type == "cuda" else "gloo",
                init_method=f"tcp://127.0.0.1:{_free_port()}",
                world_size=1, rank=0)
            self._joined = True
        mesh = make_mesh(1, device=self.device)
        self.M = RowShardedMatrix.from_scipy(
            self.A, mesh, dtype=getattr(torch, mix["dtype"]))
        self.operator = type(self.M).__name__
        log(f"graph n={self.A.shape[0]} edges={self.A.nnz // 2} "
            f"|A|={self.lam:.6f}; {type(self.M).__name__} over "
            f"{mix['ranks']} rank ({dist.get_backend()})")
        original = continuous.fun_and_grad

        def recorded(X, *args, **kwargs):
            f, g = original(X, *args, **kwargs)
            self._evals.append((np.array(X, np.float64), float(f),
                                np.array(g, np.float64)))
            return f, g

        continuous.fun_and_grad = recorded
        self._restore = (continuous, original)
        t = time.perf_counter()
        self._solve()
        self.solves.clear()
        log(f"program: warm-up solve {time.perf_counter() - t:.3f} s")

    def _solve(self):
        from krylov_robustness_torch.optimize import continuous

        mix = self.mix
        self._evals = []
        prob = continuous.build_problem(
            self.A, self.M, self.centrality, mix["method"], fun=mix["fun"],
            search_space=mix["search_space"],
            modifiable_edges=mix["modifiable_edges"],
            heur_order=mix["order"], total_weight=mix["total_weight"],
            ndense=mix["ndense"],
            tol=mix["tol"] * float(np.sinh(self.lam)),
            entries_method=mix["entries_method"])
        res = continuous.optimize_weights(
            self.A, self.M, prob, fun=mix["fun"], tol=mix["tol"],
            use_hessian=mix["use_hessian"], maxiter=mix["maxiter"],
            nrmA=self.lam)
        # the program's objective and gradient at the returned weights: its
        # last evaluation there
        at = [e for e in self._evals if np.array_equal(e[0], res.x)]
        g = at[-1][2] if at else None
        self.solves.append((np.asarray(prob.Omega), np.asarray(res.x),
                            float(res.fval), int(res.iterations), g))

    def window(self, seconds: float, hooks) -> dict:
        t0 = time.perf_counter()
        walls = []
        while True:
            t = time.perf_counter()
            self._solve()
            hooks.committed(1)
            now = time.perf_counter()
            walls.append(now - t)
            if now - t0 >= seconds:
                break
        self.log("solve wall s: " + " ".join(f"{w:.3f}" for w in walls))
        return {"s_per_solve": (now - t0) / len(self.solves)}

    def attempted(self) -> int:
        return len(self.solves)

    def readings(self) -> dict:
        return {"unit": "solve", "units": len(self.solves)}

    def describe(self) -> str:
        return (f"{self.operator}({self.mix['dtype']}), "
                f"{self.mix['ranks']} rank")

    def release(self):
        module, original = self._restore
        module.fun_and_grad = original
        self.M = None
        if self._joined:
            dist.destroy_process_group()
            self._joined = False
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, precision: str = "float64", log=print):
        """(numbers, answers checked, answers failed) for the window's last
        solve (every solve has the same inputs): the search space against
        the reference's, the objective and gradient at the returned
        weights, each as a gap relative to the larger of the two, and the
        optimality gap of the reference's gradient there. With
        ``precision`` float32 the reference stands in the program's place
        (the control)."""
        device, mix = self.device, self.mix
        Omega, x, f, iters, g = self.solves[-1]
        if self._truth is None:
            self._truth = (ref.search_space(
                self.A, self.centrality, mix["method"], mix["fun"],
                mix["search_space"], mix["modifiable_edges"], device=device),
                *ref.objective_and_gradient(self.A, Omega, x, mix["fun"],
                                            device=device))
        omega_ref, f_ref, g_ref = self._truth
        if precision != "float64":
            Omega = ref.search_space(
                self.A, self.centrality, mix["method"], mix["fun"],
                mix["search_space"], mix["modifiable_edges"],
                precision=precision, device=device)
            f, g = ref.objective_and_gradient(
                self.A, self.solves[-1][0], x, mix["fun"],
                precision=precision, device=device)
        ref_set = {tuple(sorted(map(int, e))) for e in omega_ref}
        lb, ub = ref.rewire_bounds(self.A, omega_ref)
        nums = {
            "omega_mismatch": sum(tuple(sorted(map(int, e))) not in ref_set
                                  for e in Omega) + abs(len(Omega) -
                                                        len(omega_ref)),
            "fval_gap": abs(f - f_ref) / max(abs(f), abs(f_ref))
            if f != f_ref else 0.0,
            "grad_gap": float(np.max(np.abs(g - g_ref)) /
                              np.max(np.abs(g_ref))) if g is not None
            else float("inf"),
            "opt_gap": ref.optimality_gap(g_ref, x, lb, ub,
                                          mix["total_weight"]),
        }
        log(f"check solve: fval={f!r} reference={f_ref!r} "
            f"iterations={iters} x={np.array2string(x, precision=6)}")
        limits = mix["limits"]
        failed = int(any(nums[k] > limits[k] for k in NUMBERS))
        return [(k, float(nums[k]), limits[k]) for k in NUMBERS], 1, failed


    def fault_readings(self) -> dict:
        """The numbers of the last solve under the planted fault of a solve
        that returns its start, x = 0: the reference's objective and
        gradient there, reported as the program's."""
        mix = self.mix
        Omega = self.solves[-1][0]
        x0 = np.zeros(len(Omega))
        f0, g0 = ref.objective_and_gradient(self.A, Omega, x0, mix["fun"],
                                            device=self.device)
        lb, ub = ref.rewire_bounds(self.A, Omega)
        return {"start_returned": {
            "fval_gap": 0.0, "grad_gap": 0.0,
            "opt_gap": ref.optimality_gap(g0, x0, lb, ub,
                                          mix["total_weight"])}}


def make(config, mix, seed, device, generator):
    return WeightedDriver(config, mix, seed, device, generator)
