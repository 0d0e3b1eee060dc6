"""Numerical-health guards — port of ``krylov_robustness_tpu/utils/
guards.py``: non-finite values surface as a report the caller acts on (the
greedy loops exclude such scores from the argmin and warn)."""

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


def finite_mask(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Per-batch finiteness flags: ``torch.isfinite`` reduced over every axis
    but ``axis`` (over all of them for ``axis=None``). A negative ``axis``
    counts from the end; the JAX package's reduces over every axis for
    one."""
    ok = torch.isfinite(x)
    if axis is None:
        return ok.all()
    axis = axis % x.ndim
    dims = tuple(i for i in range(x.ndim) if i != axis)
    return ok.all(dim=dims) if dims else ok


def checkified(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` and return ``(err, out)``: ``err`` is a
    ``FloatingPointError`` naming the first non-finite floating leaf of
    ``out`` (tensors, arrays, nested lists/tuples/dicts), or ``None``.

    This is not JAX's ``checkify``: it inspects the result only, after the
    call. A NaN or Inf that arises inside ``fn`` and does not reach ``out``
    (masked, reduced away, or replaced) goes unreported, and a division by
    zero is not caught where it happens."""
    out = fn(*args, **kwargs)
    for i, leaf in enumerate(_leaves(out)):
        arr = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(
            np.asarray(leaf))
        if arr.is_floating_point() and not bool(torch.isfinite(arr).all()):
            return FloatingPointError(
                f"non-finite value in leaf {i} of the result of "
                f"{getattr(fn, '__name__', fn)!s}"), out
    return None, out
