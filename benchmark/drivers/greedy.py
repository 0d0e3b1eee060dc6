"""Driver of the greedy break protocols (paper Tables 2–3 and Figures 1–4)
through the port's ``optimize/greedy.py::greedy_krylov``.

Set-up makes the graph (``generators.run_graph``: the configuration's
stand-in, its nodes relabeled by the seed), its ‖A‖ and eigenvector centrality
(``generators.protocol_inputs``), the protocol's shift σ and tolerance, and
warms up with one short sweep. The window runs whole sweeps of k edges back
to back, each building its own operator and picking its own candidates, as
a row of the paper CLI does; it observes each committed edge through the
``checkpoint`` that ``greedy_krylov`` saves into, and ends at the first
commit at or after the window's length. The check re-scores sampled steps
with the plain reference (``reference/greedy.py``) from the seeded graph
and the edges the sweep committed before each.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from ..generators import protocol_inputs, run_graph
from ..reference import top_edges_min
from ..reference import greedy as ref

NUMBERS = ("pick_regret", "delta_gap", "pick_outside")


class WindowClosed(Exception):
    """Raised from a commit at or after the end of the window; it unwinds
    the sweep in flight."""


class _Commits:
    """The ``checkpoint`` handed to ``greedy_krylov``: it loads nothing and
    hands every committed edge, with its Δ, Krylov steps and step time, to
    ``on_commit``."""

    def __init__(self, on_commit):
        self.on_commit = on_commit
        self.seen = 0

    def load(self, dataset):
        return None

    def save(self, dataset, step, edges, rob, extra=None):
        extra = extra or {}
        new = []
        for s in range(self.seen, len(edges)):
            new.append((s, tuple(int(v) for v in edges[s]),
                        float(extra["deltas"][s]), int(extra["iters"][s]),
                        float(extra["times"][s])))
        self.seen = len(edges)
        self.on_commit(new)

    def clear(self):
        pass


class GreedyDriver:
    unit = "edge"

    def __init__(self, config: dict, mix: dict, seed: int, device,
                 generator):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.generator = generator
        self.edges = []  # (sweep, step, edge, delta, iters, time)
        self.sweeps_started = 0
        self.lane = ""
        self._truth = {}  # sampled commit → reference Δ of its candidates

    # -- set-up -------------------------------------------------------------
    def setup(self, log):
        mix = self.mix
        if mix["mode"] != "break" or mix["centrality"] != "eig":
            raise ValueError("the greedy driver runs break sweeps on "
                             "eigenvector centrality")
        self.A = run_graph(self.config, self.generator, self.seed)
        self.lam, self.centrality = protocol_inputs(self.A)
        f32 = mix["dtype"] == "float32"
        self.sigma = self.lam if (mix["hub_shift"] and f32
                                  and self.lam > 20.0) else 0.0
        self.tol = mix["tol"] * float(np.exp(self.lam - self.sigma))
        m = self.A.nnz // 2
        self.Q = min(m - mix["k"], mix["Q"])
        log(f"graph n={self.A.shape[0]} edges={m} |A|={self.lam:.6f} "
            f"sigma={self.sigma:.6f} tol={self.tol:.6e} Q={self.Q}")
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
            tol=self.tol, mode="break", dtype=getattr(torch, mix["dtype"]),
            checkpoint=checkpoint, shift=self.sigma,
            fused_steps=mix["fused_steps"], device=self.device)

    # -- window -------------------------------------------------------------
    def window(self, seconds: float, hooks) -> dict:
        t0 = time.perf_counter()
        end = [None]

        def on_commit(new):
            sweep = self.sweeps_started - 1
            for step, edge, delta, iters, dt in new:
                self.edges.append((sweep, step, edge, delta, iters, dt))
            hooks.committed(len(new))
            now = time.perf_counter()
            if now - t0 >= seconds:
                end[0] = now
                raise WindowClosed

        while end[0] is None:
            self.sweeps_started += 1
            try:
                self._sweep(self.mix["k"], _Commits(on_commit))
            except WindowClosed:
                break
        return {"s_per_edge": (end[0] - t0) / len(self.edges)}

    def attempted(self) -> int:
        return len(self.edges)

    def readings(self) -> dict:
        """What the per-layer readers take from the window besides the
        trace: each committed edge's step time and Krylov steps."""
        return {"unit": "edge", "units": len(self.edges),
                "step_times_s": [e[5] for e in self.edges],
                "lanczos_steps": [e[4] for e in self.edges]}

    def describe(self) -> str:
        return f"{self.operator}, {self.lane}"

    # -- check --------------------------------------------------------------
    def sample(self) -> list:
        """The committed steps the check re-scores, drawn from the seed: the
        window's first commit (a sweep's first step, from the seeded graph
        alone) and ``check_steps`` − 1 others."""
        rng = np.random.default_rng([self.seed, 7])
        rest = np.arange(1, len(self.edges))
        take = min(len(rest), self.mix["check_steps"] - 1)
        return [0] + sorted(rng.choice(rest, size=take, replace=False)
                            .tolist())

    def states(self):
        """For each sampled commit: (its index, the graph before it, its
        candidates, the program's pick and Δ). The graph removes the edges
        its sweep committed before it from the seeded graph; the candidates
        are the first Q of the reference's own top Q + k 'min' edges not yet
        committed."""
        top = top_edges_min(self.A, self.centrality, self.Q + self.mix["k"])
        C = sp.coo_matrix(self.A)
        n = self.A.shape[0]
        keys = C.row.astype(np.int64) * n + C.col
        for idx in self.sample():
            sweep, step, edge, delta, _, _ = self.edges[idx]
            before = [e[2] for e in self.edges
                      if e[0] == sweep and e[1] < step]
            drop = [i * n + j for i, j in before] + \
                [j * n + i for i, j in before]
            keep = ~np.isin(keys, drop)
            A = sp.csr_matrix((C.data[keep], (C.row[keep], C.col[keep])),
                              shape=self.A.shape)
            gone = set(before)
            cands = np.asarray([e for e in map(tuple, top.tolist())
                                if e not in gone][:self.Q], np.int64)
            yield idx, A, cands, edge, delta

    def release(self):
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _truths(self):
        """(index, graph, candidates, pick, Δ, the reference's Δ of every
        candidate, its steps) of each sampled commit; the reference runs
        once a state."""
        for idx, A, cands, pick, delta in self.states():
            if idx not in self._truth:
                self._truth[idx] = ref.delta_trace_exp(
                    A, cands, sign=-1.0, shift=self.sigma,
                    device=self.device)
            truth, steps = self._truth[idx]
            yield idx, A, cands, pick, delta, truth, steps

    def check(self, precision: str = "float64", log=print):
        """(numbers, answers checked, answers failed): each number is its
        worst over the sampled steps, next to the mix's limit. With another
        ``precision`` the reference itself scores the same states in that
        precision and stands in the program's place (the control)."""
        worst = {k: 0.0 for k in NUMBERS}
        limits = self.mix["limits"]
        failed = checked = 0
        for idx, A, cands, pick, delta, truth, steps in self._truths():
            if precision != "float64":
                mine, _ = ref.delta_trace_exp(
                    A, cands, sign=-1.0, shift=self.sigma,
                    device=self.device, precision=precision, atol=self.tol)
                h = int(np.argmin(mine))
                pick, delta = tuple(cands[h]), float(mine[h])
            nums = ref.step_numbers(truth, cands, pick, delta)
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
        commit off by one from the argmin (``reference.greedy.
        swapped_pick``), worst over the steps, as the check takes them."""
        worst = {k: 0.0 for k in NUMBERS}
        for _, _, cands, _, _, truth, _ in self._truths():
            h, delta = ref.swapped_pick(truth)
            nums = ref.step_numbers(truth, cands, cands[h], delta)
            for k in NUMBERS:
                worst[k] = max(worst[k], nums[k])
        return {"swapped_pick": worst}


def make(config, mix, seed, device, generator):
    return GreedyDriver(config, mix, seed, device, generator)
