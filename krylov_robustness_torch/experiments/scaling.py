"""Multi-rank scaling-efficiency harness — port of
``krylov_robustness_tpu/experiments/scaling.py`` (north star: ≥80% SpMM
nnz·b/s scaling from one card to several).

Measures the row-sharded SpMM (``RowShardedMatrix.spmm_sharded``, its
all-gather included) at mesh sizes 1..D over the first D ranks of the
process group (one card each under ``torchrun``, or gloo ranks on the
CPU), and reports nnz·b/s per mesh size and the efficiency against the
smallest mesh scaled by D. Every rank of the group calls it; ranks off a
mesh wait for the next one. On one card only D = 1 exists: it shows the
product's rate, not scaling.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import make_mesh, row_sharded
from ..parallel.spmm_sharded import RowShardedMatrix


def measure_sharded_spmm(A_scipy, mesh_sizes=None, b: int = 8,
                         iters: int = 50, dtype=torch.float32,
                         layout: str = "coo", *, device):
    """{D: (seconds per SpMM, nnz·b/s)} for each mesh size this rank is on;
    ``layout``: the local block's ``'coo'`` (gather + ``index_add_``) or
    ``'ell'`` (K slot gathers). ``iters`` chained products, timed with CUDA
    events on the card and ``time.perf_counter`` on the CPU, after one
    untimed chain."""
    n, nnz = A_scipy.shape[0], A_scipy.nnz
    total = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_sizes is None:
        mesh_sizes = [d for d in (1, 2, 4, 8, 16, 32) if d <= total]
    x_host = np.random.default_rng(0).standard_normal((n, b))
    out = {}
    for D in mesh_sizes:
        mesh = make_mesh(D, device=device)
        if not mesh.is_member:
            continue
        M = RowShardedMatrix.from_scipy(A_scipy, mesh, dtype=dtype,
                                        layout=layout)
        x = torch.zeros((M.n, b), dtype=dtype, device=mesh.device)
        x[:n] = torch.as_tensor(x_host, device=mesh.device)
        x_local = x[row_sharded(mesh, n=M.n)].contiguous()

        def chain(x):
            for _ in range(iters):
                x = M.spmm_sharded(x) * 1e-3
            return x

        chain(x_local)
        if mesh.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize(mesh.device)
            start.record()
            chain(x_local)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) * 1e-3 / iters
        else:
            t0 = time.perf_counter()
            chain(x_local)
            dt = (time.perf_counter() - t0) / iters
        out[D] = (dt, nnz * b / dt)
    return out


def scaling_efficiency(results: dict) -> dict:
    """Efficiency vs linear scaling from the smallest mesh."""
    base_D = min(results)
    base_rate = results[base_D][1] / base_D
    return {D: rate / (D * base_rate) for D, (dt, rate) in results.items()}
