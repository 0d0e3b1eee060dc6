"""CLI for the paper-protocol experiment drivers — port of
``krylov_robustness_tpu/experiments/__main__.py``:

    python -m krylov_robustness_torch.experiments unweighted --mode break
    python -m krylov_robustness_torch.experiments --cpu budget --mode break \\
        --datasets Anaheim Rome
    python -m krylov_robustness_torch.experiments weighted --fun sinh --hessian
    python -m krylov_robustness_torch.experiments trace
    python -m krylov_robustness_torch.experiments parity --dense-cutoff 2500
    torchrun --nproc-per-node 4 -m krylov_robustness_torch.experiments \\
        scaling --dataset Barcelona --batch 8 --layout coo

By default it runs on the card (``cuda:0``, or under ``torchrun`` the card
of the rank's ``LOCAL_RANK``) in float32 with TF32 off, and raises on a
machine without CUDA; ``--cpu`` runs on the CPU in float64 (the
golden-result configuration, matching the reference's MATLAB doubles). The
datasets are read from ``$KRYLOV_ROBUSTNESS_DATA`` (``graphs/io.py``).
``scaling`` joins the ``torchrun`` world when there is one
(``parallel/mesh.py::maybe_init_distributed``).
"""

from __future__ import annotations

import argparse
import sys

import torch


def _setup_device(use_cpu: bool):
    """(device, dtype): the CPU in float64, or the current card (cuda:0
    unless a launcher chose another) in float32 with full-precision f32
    matmuls (which raises without CUDA)."""
    if use_cpu:
        return torch.device("cpu"), torch.float64
    from ..utils.device import require_full_f32_matmul, resolve_device

    resolve_device("cuda")  # raises without CUDA
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    require_full_f32_matmul()
    return dev, torch.float32


def main(argv=None):
    p = argparse.ArgumentParser(prog="krylov_robustness_torch.experiments")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU in float64 instead of cuda:0 in "
                   "float32")
    p.add_argument("--out-dir", default="results")
    sub = p.add_subparsers(dest="cmd", required=True)

    u = sub.add_parser("unweighted", help="Tables 2-3 protocol (break/make)")
    u.add_argument("--mode", choices=["break", "make"], default="break")
    u.add_argument("--datasets", nargs="*", default=None,
                   help="dataset names (searched in misc then transport)")
    u.add_argument("--collections", nargs="*", default=["misc", "transport"])
    u.add_argument("--k", type=int, default=50)
    u.add_argument("--Q", type=int, default=250)
    u.add_argument("--tol", type=float, default=1e-6)
    u.add_argument("--gkb-only", action="store_true",
                   help="run only the GREEDY_KRYLOV method (large-Q reruns "
                   "next to existing Q=250 baselines)")
    u.add_argument("--force", action="store_true",
                   help="regenerate rows even if the resume check finds "
                   "them complete (keyed in-place replace)")
    u.add_argument("--order", choices=["min", "mult"], default="min",
                   help="candidate-ranking order for find_top_(missing_)edges "
                   "(reference 'min'/'mult' tie semantics)")
    u.add_argument("--rescore-every", type=int, default=1,
                   help="candidate-score reuse period: full rescore every N "
                   "greedy steps, fixed-size fresh subset otherwise "
                   "(1 = reference protocol; >1 is a non-reference "
                   "heuristic whose committed winner is always scored "
                   "fresh)")
    u.add_argument("--rescore-frac", type=float, default=0.2,
                   help="fraction of candidates scored fresh between full "
                   "rescores")
    u.add_argument("--fused-steps", type=int, default=None,
                   help="greedy steps fused per block (optimize/fused.py); "
                   "0/1 = per-step loop; default auto = 10 on cuda:0 "
                   "(f32), 0 on the --cpu f64 golden lane. Steps with "
                   "convergence stragglers past the fused budget replay "
                   "through the accurate path")

    b = sub.add_parser("budget", help="Figures 1-4 budget sweeps")
    b.add_argument("--mode", choices=["break", "make"], default="break")
    b.add_argument("--datasets", nargs="+", required=True)
    b.add_argument("--budgets", type=int, nargs="*",
                   default=list(range(10, 101, 10)))
    b.add_argument("--search-spaces", type=int, nargs="*",
                   default=[50, 250, 1000])
    b.add_argument("--tol", type=float, default=1e-6)
    b.add_argument("--force", action="store_true",
                   help="regenerate sweeps even if their rows exist "
                   "(keyed in-place replace)")

    w = sub.add_parser("weighted", help="Tables 5-6 protocol (weighted IPM)")
    w.add_argument("--fun", choices=["exp", "sinh", "cosh"], default="exp")
    w.add_argument("--hessian", action="store_true",
                   help="exact Krylov Hessian instead of L-BFGS approximation")
    w.add_argument("--countries", nargs="*", default=None)
    w.add_argument("--methods", nargs="*",
                   default=["tuning", "rewire", "add"])
    w.add_argument("--maxiter", type=int, default=200)

    sub.add_parser("trace", help="trace(exp(A)) wall-time benchmark")

    pa = sub.add_parser("parity", help="deterministic 1e-6 accuracy tables "
                        "(expmv action + tightened trace) vs dense oracles")
    pa.add_argument("--dense-cutoff", type=int, default=2500)
    pa.add_argument("--trace-tol", type=float, default=1e-6)

    s = sub.add_parser("scaling", help="sharded-SpMM scaling efficiency "
                       "(one process per rank under torchrun)")
    s.add_argument("--dataset", default="Barcelona")
    s.add_argument("--batch", type=int, default=8)
    s.add_argument("--layout", choices=["coo", "ell"], default="coo")

    args = p.parse_args(argv)
    if args.cmd == "scaling":
        from ..parallel.mesh import maybe_init_distributed

        # before the device is chosen: under torchrun each rank takes the
        # card of its LOCAL_RANK
        maybe_init_distributed()
    dev, dtype = _setup_device(args.cpu)

    if args.cmd == "unweighted":
        from ..utils.config import UnweightedConfig
        from .unweighted import run_paper_suite

        cfg = UnweightedConfig(mode=args.mode, k=args.k, Q=args.Q,
                               tol=args.tol, order=args.order,
                               rescore_every=args.rescore_every,
                               rescore_frac=args.rescore_frac,
                               fused_steps=args.fused_steps)
        run_paper_suite(cfg, out_dir=args.out_dir,
                        collections=tuple(args.collections),
                        datasets=args.datasets or None, dtype=dtype,
                        gkb_only=args.gkb_only, force=args.force, device=dev)
    elif args.cmd == "weighted":
        from ..utils.config import WeightedConfig
        from .weighted import run_paper_suite as run_weighted

        cfg = WeightedConfig(fun=args.fun, use_hessian=args.hessian,
                             maxiter=args.maxiter,
                             methods=tuple(args.methods))
        run_weighted(cfg, out_dir=args.out_dir, countries=args.countries,
                     dtype=dtype, device=dev)
    elif args.cmd == "budget":
        from .unweighted import run_budget_sweep

        run_budget_sweep(args.datasets, args.budgets, args.search_spaces,
                         mode=args.mode, tol=args.tol, out_dir=args.out_dir,
                         dtype=dtype, force=args.force, device=dev)
    elif args.cmd == "trace":
        from .trace_bench import run

        run(out_dir=args.out_dir, dtype=dtype, device=dev)
    elif args.cmd == "parity":
        from .parity import (
            run_expmv_parity,
            run_trace_f32_lane,
            run_trace_tight,
        )

        run_expmv_parity(out_dir=args.out_dir,
                         dense_cutoff=args.dense_cutoff, device=dev)
        run_trace_tight(out_dir=args.out_dir, tol=args.trace_tol, device=dev)
        run_trace_f32_lane(out_dir=args.out_dir, device=dev)
    else:
        _scaling(args, dev, dtype)
    return 0


def _scaling(args, dev, dtype) -> None:
    """The ``scaling`` subcommand: one JSON line (rank 0 of a torchrun
    world) with nnz·b/s per mesh size and the efficiency against the
    smallest mesh."""
    import json

    import torch.distributed as dist

    from ..graphs.io import load_transport
    from ..graphs.preprocess import preprocess_unweighted
    from .scaling import measure_sharded_spmm, scaling_efficiency

    A = preprocess_unweighted(load_transport(args.dataset))
    res = measure_sharded_spmm(A, b=args.batch, dtype=dtype,
                               layout=args.layout, device=dev)
    if dist.is_initialized():
        rank = dist.get_rank()
        dist.destroy_process_group()
        if rank != 0:
            return
    eff = scaling_efficiency(res)
    print(json.dumps({
        "dataset": args.dataset,
        "layout": args.layout,
        "device": str(dev),
        "rates_nnzb_per_s": {str(d): r for d, (t, r) in res.items()},
        "efficiency": {str(d): e for d, e in eff.items()},
    }))


if __name__ == "__main__":
    sys.exit(main())
