"""Numerical-health guards — port of ``check_finite`` from
``krylov_robustness_tpu/utils/guards.py``: non-finite values surface as a
report the caller acts on (the greedy loops exclude such scores from the
argmin and warn)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NumericsReport:
    finite: bool
    max_abs: float
    name: str

    def raise_if_bad(self):
        if not self.finite:
            raise FloatingPointError(
                f"non-finite values detected in {self.name} "
                f"(max |x| = {self.max_abs})")
        return self


def _leaves(x):
    if isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def check_finite(x, name: str = "array") -> NumericsReport:
    """Finite check of a tensor, an array, or nested lists/tuples/dicts of
    them; non-float leaves are skipped."""
    finite = True
    max_abs = 0.0
    for leaf in _leaves(x):
        arr = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if not arr.is_floating_point():
            continue
        finite = finite and bool(torch.isfinite(arr).all())
        if arr.numel():
            max_abs = max(max_abs, float(arr.abs().max()))
    return NumericsReport(finite=finite, max_abs=max_abs, name=name)
