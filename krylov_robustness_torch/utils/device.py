"""Explicit device resolution: the port never chooses a device by itself."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA request on a machine
    without CUDA raises instead of running somewhere else."""
    if device is None:
        raise ValueError("pass an explicit device ('cpu' or 'cuda')")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def float_dtype(dtype) -> torch.dtype:
    """The two compute dtypes of the port."""
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, "
                         f"got {dtype!r}")
    return dtype


def require_full_f32_matmul() -> None:
    """Raise if float32 matrix products on CUDA may run in TF32: its ~1e-3
    relative error sits far above the f32 lane's 32·eps convergence floor."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls must run in full precision: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")
