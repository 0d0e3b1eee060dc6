"""Driver of the greedy make protocol (paper Table 3,
``Tests/test_unweighted_make.m``) through the port's
``optimize/greedy.py::greedy_krylov`` with ``mode='make'``.

The break driver's protocol with make's three differences: each sweep adds
k edges, the argmax of Δ, to the graph; its candidates are the top Q + k
*missing* edges in the 'min' order (``find_top_missing_edges``); a
candidate's low-rank update is B = +[[0, 1], [1, 0]]. Set-up, the window
and the sample of commits are the break driver's. The check re-scores each
sampled commit with the plain reference (``reference/greedy.py``, sign +1)
on the seeded graph plus the edges its sweep added before it, and judges
the pick against the reference's argmax: the break driver's numbers taken
over −Δ, so that the best is again the least.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..generators import protocol_inputs, run_graph
from ..reference import greedy as ref
from ..reference import top_missing_edges_min
from .greedy import NUMBERS, GreedyDriver


def make_numbers(delta_ref: np.ndarray, candidates: np.ndarray, pick,
                 pick_delta: float) -> dict:
    """``reference.greedy.step_numbers`` of a make step: the best is the
    largest Δ, so the numbers are those of −Δ. ``pick_regret`` reads how far
    the reference's Δ of the pick lies below its best."""
    return ref.step_numbers(-np.asarray(delta_ref), candidates, pick,
                            -pick_delta)


class GreedyMakeDriver(GreedyDriver):
    # -- set-up -------------------------------------------------------------
    def setup(self, log):
        """The break driver's set-up, but for its mode test and its bound
        on Q, which counts the graph's missing edges here."""
        mix = self.mix
        if mix["mode"] != "make" or mix["centrality"] != "eig":
            raise ValueError("the greedy make driver runs make sweeps on "
                             "eigenvector centrality")
        self.A = run_graph(self.config, self.generator, self.seed)
        self.lam, self.centrality = protocol_inputs(self.A)
        f32 = mix["dtype"] == "float32"
        self.sigma = self.lam if (mix["hub_shift"] and f32
                                  and self.lam > 20.0) else 0.0
        self.tol = mix["tol"] * float(np.exp(self.lam - self.sigma))
        n, m = self.A.shape[0], self.A.nnz // 2
        self.Q = min(n * (n - 1) // 2 - m - mix["k"], mix["Q"])
        log(f"graph n={n} edges={m} |A|={self.lam:.6f} "
            f"sigma={self.sigma:.6f} tol={self.tol:.6e} Q={self.Q} "
            f"(make: candidates are missing edges)")
        res = self._sweep(mix["warmup_k"], None)
        self.operator = res.operator
        self.lane = ("fused" if res.fused_accepted else "per-step")
        log(f"program: operator={res.operator} lane={self.lane} "
            f"(warm-up sweep of {mix['warmup_k']} edges, "
            f"{res.fused_accepted} committed by fused blocks)")

    def _sweep(self, k: int, checkpoint):
        from krylov_robustness_torch.optimize import greedy

        mix = self.mix
        return greedy.greedy_krylov(
            self.A, k, self.Q, self.centrality, order=mix["order"],
            tol=self.tol, mode="make", dtype=getattr(torch, mix["dtype"]),
            checkpoint=checkpoint, shift=self.sigma,
            fused_steps=mix["fused_steps"], device=self.device)

    # -- check --------------------------------------------------------------
    def states(self):
        """For each sampled commit: (its index, the graph before it, its
        candidates, the program's pick and Δ). The graph adds the edges its
        sweep committed before it to the seeded graph; the candidates are
        the first Q of the reference's own top Q + k 'min' missing edges not
        yet committed."""
        top = top_missing_edges_min(self.A, self.centrality,
                                    self.Q + self.mix["k"])
        C = sp.coo_matrix(self.A)
        for idx in self.sample():
            sweep, step, edge, delta, _, _ = self.edges[idx]
            before = [e[2] for e in self.edges
                      if e[0] == sweep and e[1] < step]
            e = np.asarray(before, np.int64).reshape(-1, 2)
            A = sp.csr_matrix(
                (np.ones(C.nnz + 2 * len(e)),
                 (np.concatenate([C.row, e[:, 0], e[:, 1]]),
                  np.concatenate([C.col, e[:, 1], e[:, 0]]))),
                shape=self.A.shape)
            gone = set(before)
            cands = np.asarray([e for e in map(tuple, top.tolist())
                                if e not in gone][:self.Q], np.int64)
            yield idx, A, cands, edge, delta

    def _truths(self):
        for idx, A, cands, pick, delta in self.states():
            if idx not in self._truth:
                self._truth[idx] = ref.delta_trace_exp(
                    A, cands, sign=+1.0, shift=self.sigma,
                    device=self.device)
            truth, steps = self._truth[idx]
            yield idx, A, cands, pick, delta, truth, steps

    def check(self, precision: str = "float64", log=print):
        """As the break driver's check, against the reference's argmax;
        with another ``precision`` the reference in that precision commits
        its own argmax in the program's place (the control)."""
        worst = {k: 0.0 for k in NUMBERS}
        limits = self.mix["limits"]
        failed = checked = 0
        for idx, A, cands, pick, delta, truth, steps in self._truths():
            if precision != "float64":
                mine, _ = ref.delta_trace_exp(
                    A, cands, sign=+1.0, shift=self.sigma,
                    device=self.device, precision=precision, atol=self.tol)
                h = int(np.argmax(mine))
                pick, delta = tuple(cands[h]), float(mine[h])
            nums = make_numbers(truth, cands, pick, delta)
            log(f"check edge {tuple(map(int, pick))}: " + " ".join(
                f"{k}={v:.6e}" for k, v in nums.items())
                + f" (reference steps {steps})")
            checked += 1
            failed += any(nums[k] > limits[k] for k in NUMBERS)
            for k in NUMBERS:
                worst[k] = max(worst[k], nums[k])
        return ([(k, worst[k], limits[k]) for k in NUMBERS], checked, failed)

    def fault_readings(self) -> dict:
        """The numbers of the sampled steps under the planted fault of a
        commit off by one from the argmax, reported with the best's Δ
        (``reference.greedy.swapped_pick`` over −Δ), worst over the steps."""
        worst = {k: 0.0 for k in NUMBERS}
        for _, _, cands, _, _, truth, _ in self._truths():
            h, neg = ref.swapped_pick(-truth)
            nums = make_numbers(truth, cands, cands[h], -neg)
            for k in NUMBERS:
                worst[k] = max(worst[k], nums[k])
        return {"swapped_pick": worst}


def make(config, mix, seed, device, generator):
    return GreedyMakeDriver(config, mix, seed, device, generator)
