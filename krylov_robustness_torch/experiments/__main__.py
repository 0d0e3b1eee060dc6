"""CLI for the paper-protocol experiment drivers — port of
``krylov_robustness_tpu/experiments/__main__.py``:

    python -m krylov_robustness_torch.experiments unweighted --mode break
    python -m krylov_robustness_torch.experiments --cpu budget --mode break \\
        --datasets Anaheim Rome
    python -m krylov_robustness_torch.experiments weighted --fun sinh --hessian

By default it runs on ``cuda:0`` in float32 with TF32 off, and raises on a
machine without CUDA; ``--cpu`` runs on the CPU in float64 (the
golden-result configuration, matching the reference's MATLAB doubles). The
datasets are read from ``$KRYLOV_ROBUSTNESS_DATA`` (``graphs/io.py``). The
subcommands ``trace``, ``parity`` and ``scaling`` are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import sys

import torch

# subcommands of the JAX CLI still to port, with their ROADMAP.md item
NOT_PORTED = {
    "trace": "Queue 1 item 3 (experiments/trace_bench.py)",
    "parity": "Queue 1 item 3 (experiments/parity.py)",
    "scaling": "Queue 1 item 4 (distributed layer)",
}


def _setup_device(use_cpu: bool):
    """(device, dtype): the CPU in float64, or cuda:0 in float32 with
    full-precision f32 matmuls (which raises without CUDA)."""
    if use_cpu:
        return torch.device("cpu"), torch.float64
    from ..utils.device import require_full_f32_matmul, resolve_device

    dev = resolve_device("cuda:0")
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

    for name, item in NOT_PORTED.items():
        sub.add_parser(name, help=f"not ported yet (ROADMAP {item})")

    # the JAX CLI's flags of a subcommand still to port are not declared
    # here: that subcommand raises whatever flags it is given
    args, unknown = p.parse_known_args(argv)
    if args.cmd in NOT_PORTED:
        raise NotImplementedError(
            f"the {args.cmd!r} subcommand is not ported yet (ROADMAP.md, "
            f"{NOT_PORTED[args.cmd]})")
    if unknown:
        p.error(f"unrecognized arguments: {' '.join(unknown)}")
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
    else:
        from .unweighted import run_budget_sweep

        run_budget_sweep(args.datasets, args.budgets, args.search_spaces,
                         mode=args.mode, tol=args.tol, out_dir=args.out_dir,
                         dtype=dtype, force=args.force, device=dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
