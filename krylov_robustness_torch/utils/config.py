"""Experiment configuration dataclasses — carried over from
``krylov_robustness_tpu/utils/config.py``.

Names and defaults mirror the reference's two config tiers (SURVEY.md §5.6):
function-level optional args (``krylov_miobi.m:29-64``,
``trace_fun_update.m:21-35``) and script-level settings blocks
(``test_unweighted_break.m:15-21``, ``test_weighted_exp_lbfgs.m:5-26``), so
the paper protocols are expressible 1:1.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class KrylovConfig:
    tol: float = 1e-12
    max_it: int = 100  # reference: it = min(100, n)
    schedule: Sequence[int] = (6, 6, 8, 12, 20, 28, 20)
    lag: int = 2


@dataclasses.dataclass
class UnweightedConfig:
    """Protocol of Tests/test_unweighted_break.m / _make.m."""

    k: int = 50  # budget (test_unweighted_break.m:19)
    Q: int = 250  # search space (test_unweighted_break.m:20)
    tol: float = 1e-6  # relative, scaled by exp(normest(A))
    it: int = 100
    centrality: str = "eig"
    order: str = "min"  # centrality_order{2}
    miobi_eigs: int = 25  # num_eig_miobi
    mode: str = "break"
    # candidate-score reuse (NOT part of the reference protocol; default off
    # = full rescore per step). >1 rescores the full set every that-many
    # steps and a fixed-size fresh subset otherwise — see
    # optimize.greedy._greedy_loop.
    rescore_every: int = 1
    rescore_frac: float = 0.2
    # greedy steps fused per block (optimize/fused.py); 0/1 = per-step loop;
    # None = auto (10 in float32, the JAX package's production lane; 0 on
    # the f64 golden lane, which keeps exact per-step semantics). Straggler
    # steps replay through the accurate path.
    fused_steps: int | None = None


@dataclasses.dataclass
class BudgetSweepConfig:
    """Protocol of Tests/test_unweighted_*_budget.m."""

    budgets: Sequence[int] = tuple(range(10, 101, 10))
    search_spaces: Sequence[int] = (50, 250, 1000)
    tol: float = 1e-6
    mode: str = "break"


@dataclasses.dataclass
class WeightedConfig:
    """Protocol of Tests/test_weighted_*_{lbfgs,hessian}.m."""

    fun: str = "exp"  # exp | sinh | cosh
    tol_param: float = 1e-8  # 1e-6 for sinh/cosh (sinh driver line 6)
    it: int = 100
    modifiable_edges: int = 30
    search_space: int = 100
    heur_method: str = "min"
    total_weight: float = 10.0
    ndense: int = 500
    maxiter: int = 200
    use_hessian: bool = False
    methods: Sequence[str] = ("tuning", "rewire", "add")

    def __post_init__(self):
        if self.fun in ("sinh", "cosh") and self.tol_param == 1e-8:
            self.tol_param = 1e-6  # test_weighted_sinh_lbfgs.m:6
