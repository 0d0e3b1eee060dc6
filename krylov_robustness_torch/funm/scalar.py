"""Registry of the scalar functions f applied to matrices (port of
``krylov_robustness_tpu/funm/scalar.py``; reference
``functions/fun_update.m:42-59``)."""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class ScalarFun:
    name: str
    fn: Callable
    derivative: str  # name of the derivative function in the registry

    def __call__(self, x):
        return self.fn(x)


_REGISTRY: dict[str, ScalarFun] = {}


def _register(name: str, fn, derivative: str):
    _REGISTRY[name] = ScalarFun(name=name, fn=fn, derivative=derivative)


_register("exp", torch.exp, "exp")
_register("sinh", torch.sinh, "cosh")
_register("cosh", torch.cosh, "sinh")
_register("identity", lambda x: x, "one")
_register("one", torch.ones_like, "zero")
_register("zero", torch.zeros_like, "zero")


def get_fun(f) -> ScalarFun:
    if isinstance(f, ScalarFun):
        return f
    if isinstance(f, str):
        return _REGISTRY[f]
    raise TypeError(f"unknown scalar function spec: {f!r}")


def derivative_of(f) -> ScalarFun:
    return _REGISTRY[get_fun(f).derivative]
