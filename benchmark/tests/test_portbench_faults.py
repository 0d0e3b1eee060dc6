"""The check sees each fault a cell can have: a whole run at a tiny size on
the CPU (skipping only the look for a card) with the timed path broken
underneath must come out with ``correct`` false. The exchange between
chips has no fault to plant: every cell runs on one rank, where the
all-gather is a copy."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark.harness import run_cell
from benchmark.tests.conftest import tiny

SEED = 2**31 + 99


def run(workload):
    cfg, mix = tiny(workload)
    rc, line = run_cell(workload, SEED, 1.0, False,
                        t_start=time.perf_counter(), device="cpu",
                        need_chips=False, config=cfg, mix=mix)
    assert rc == 0
    return line


def test_sound_runs_are_correct():
    assert run("road.break_q250")["correct"]
    assert run("road.sinh_rewire")["correct"]


# -- greedy ------------------------------------------------------------------
def _state_unchanged(monkeypatch):
    """Commits that do not reach the operator: every later step, in a fused
    block or after it, scores the graph as it was."""
    from krylov_robustness_torch.optimize import fused, greedy

    monkeypatch.setattr(fused, "coo_rebuild", lambda op, vals: op)
    frozen = greedy._FrozenStructureMatrix
    for cls in (frozen, greedy._BandedAdapter):
        monkeypatch.setattr(cls, "set_edge", lambda self, i, j, v: None)
    monkeypatch.setattr(frozen, "set_fused_vals", lambda self, vals: None)
    monkeypatch.setattr(frozen, "fused_state",
                        lambda self: (self.mat, self.mat.vals.clone()))


def _half_left_out(monkeypatch):
    """The scorer scores the second half of the candidates and reports the
    first half, the most central edges, as the worst scores (per-step
    scorer and fused block)."""
    from krylov_robustness_torch.optimize import fused, greedy

    real, real_fused = greedy.trace_fun_update_edges, fused._score_all

    def half(A, edges, *a, **k):
        r = real(A, edges, *a, **k)
        d = r.delta.clone()
        d[:len(d) // 2] = float("inf")
        return dataclasses.replace(r, delta=d)

    def half_fused(*a, **k):
        delta, iters, conv = real_fused(*a, **k)
        delta = delta.clone()
        delta[:len(delta) // 2] = float("inf")
        return delta, iters, conv

    monkeypatch.setattr(greedy, "trace_fun_update_edges", half)
    monkeypatch.setattr(fused, "_score_all", half_fused)


def _answer_altered(monkeypatch):
    """Every reported Δ 1% off where it is produced."""
    from krylov_robustness_torch.optimize import fused, greedy

    real, real_block = greedy.trace_fun_update_edges, \
        fused.fused_greedy_block

    def altered(*a, **k):
        r = real(*a, **k)
        return dataclasses.replace(r, delta=r.delta * 1.01)

    def altered_block(*a, **k):
        vals, alive, (hs, dls, its, oks, nfs) = real_block(*a, **k)
        return vals, alive, (hs, dls * 1.01, its, oks, nfs)

    monkeypatch.setattr(greedy, "trace_fun_update_edges", altered)
    monkeypatch.setattr(fused, "fused_greedy_block", altered_block)


def _pick_swapped(monkeypatch):
    """Scores computed right, but the commit is off by one from the argmin:
    the scorer hands the sweep its scores shifted by one place, so it
    commits the candidate after the best and reports the best's Δ."""
    from krylov_robustness_torch.optimize import fused, greedy

    real, real_fused = greedy.trace_fun_update_edges, fused._score_all

    def swapped(*a, **k):
        r = real(*a, **k)
        return dataclasses.replace(r, delta=torch.roll(r.delta, 1))

    def swapped_fused(*a, **k):
        delta, iters, conv = real_fused(*a, **k)
        return torch.roll(delta, 1), iters, conv

    monkeypatch.setattr(greedy, "trace_fun_update_edges", swapped)
    monkeypatch.setattr(fused, "_score_all", swapped_fused)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_left_out,
                                   _answer_altered, _pick_swapped])
@pytest.mark.parametrize("workload,fused", [
    ("road.break_q250", False), ("hub.break_q250_perstep", True)])
def test_greedy_fault_is_caught(monkeypatch, workload, fused, fault):
    """The per-step lane (road) and the fused lane (the hub graph in fused
    blocks of 3, a lane no cell runs yet)."""
    fault(monkeypatch)
    cfg, mix = tiny(workload, fused)
    rc, line = run_cell(workload, SEED, 1.0, False,
                        t_start=time.perf_counter(), device="cpu",
                        need_chips=False, config=cfg, mix=mix)
    assert rc == 0 and not line["correct"]


# -- weighted ----------------------------------------------------------------
def _patch_evaluation(monkeypatch, change):
    from krylov_robustness_torch.optimize import continuous

    real = continuous.fun_and_grad

    def broken(X, *a, **k):
        return change(X, *real(X, *a, **k), a, k)

    monkeypatch.setattr(continuous, "fun_and_grad", broken)


def test_weighted_step_that_leaves_its_state_unchanged(monkeypatch):
    """The evaluation ignores the weights: every call reports the graph as
    it was (f = 0 and the gradient at x = 0)."""
    from krylov_robustness_torch.optimize import continuous

    real = continuous.fun_and_grad

    def unchanged(X, *a, **k):
        return real(np.zeros_like(np.asarray(X, float)), *a, **k)

    monkeypatch.setattr(continuous, "fun_and_grad", unchanged)
    assert not run("road.sinh_rewire")["correct"]


def test_weighted_solve_that_returns_its_start(monkeypatch):
    """The optimizer stops where it began: x = 0, with the objective and
    gradient there, which the reference confirms."""
    from krylov_robustness_torch.optimize import continuous

    def start(A_scipy, A, problem, fun="exp", tol=1e-8, use_hessian=False,
              maxiter=200, nrmA=None):
        x0 = np.zeros(len(problem.Omega))
        f, _ = continuous.fun_and_grad(x0, A, problem.Omega, problem.dfA,
                                       fun=fun, tol=tol, nrmA=nrmA)
        return continuous.ContinuousResult(x=x0, fval=float(f), iterations=0,
                                           success=False, message="start")

    monkeypatch.setattr(continuous, "optimize_weights", start)
    assert not run("road.sinh_rewire")["correct"]


def test_weighted_half_the_gradient_left_out(monkeypatch):
    def half(X, f, g, a, k):
        g = np.array(g)
        g[len(g) // 2:] = 0.0
        return f, g

    _patch_evaluation(monkeypatch, half)
    assert not run("road.sinh_rewire")["correct"]


def test_weighted_answer_altered_where_it_is_produced(monkeypatch):
    _patch_evaluation(monkeypatch, lambda X, f, g, a, k: (f * 1.001, g))
    assert not run("road.sinh_rewire")["correct"]


@pytest.mark.cuda
def test_greedy_control_fails_on_the_card(cuda_device):
    """The TF32 control on the card at a small size: it fails a limit of
    the mix on at least one of three seeds where the program passes."""
    from benchmark.control import readings

    cfg, mix = tiny("road.break_q250")
    cfg.update(n=20000, edges=21876, max_chord=300)
    mix.update(Q=100, k=10)
    failed = []
    for seed in (1, 2, 3):
        row = readings("road.break_q250", seed, 2.0, device=cuda_device,
                       config=cfg, mix=mix)
        assert all(row["program"][k] <= mix["limits"][k]
                   for k in mix["limits"])
        failed.append(any(row["control"][k] > mix["limits"][k]
                          for k in mix["limits"]))
    assert any(failed)
    torch.cuda.empty_cache()
