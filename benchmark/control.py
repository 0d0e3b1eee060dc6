"""Readings that set the limits of ``correct``: for each seed, one short run
of a cell (set-up, a window of ``--seconds``, the program's state freed),
then the numbers the check compares: for the program's answers; for the
control, the reference itself in the mix's ``control`` precision standing
in the program's place on the same inputs; and for each fault the driver
plants in the reference's answers (``fault_readings``). One JSON line a
seed::

    python3 -m benchmark.control --workload <name> --seeds 11 12 13 \\
        --seconds 8 [--out FILE]

It needs the CUDA devices the cell asks for, as a run does.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

from .harness import log, resolve


def readings(workload: str, seed: int, seconds: float, device="cuda",
             config=None, mix=None) -> dict:
    import torch

    cell, cfg, mx, _, _ = resolve(workload)
    cfg = config if config is not None else cfg
    mx = mix if mix is not None else mx
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    drv = importlib.import_module(f"benchmark.drivers.{mx['driver']}")
    gen = importlib.import_module(f"benchmark.generators.{cfg['generator']}")
    d = drv.make(cfg, mx, seed, dev, gen)
    t = time.perf_counter()
    d.setup(log)
    hooks = type("H", (), {"committed": lambda self, n: None})()
    e2e = d.window(seconds, hooks)
    d.release()
    program, checked, failed = d.check(log=log)
    control, _, _ = d.check(precision=mx["control"], log=log)
    return {"workload": workload, "seed": seed, "path": d.describe(),
            "units": d.attempted(), **e2e,
            "program": {k: v for k, v, _ in program},
            "control": {k: v for k, v, _ in control},
            "faults": d.fault_readings(),
            "seconds": time.perf_counter() - t}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the readings are taken on the card only")
        return 3
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            row = readings(args.workload, seed, args.seconds)
            line = json.dumps(row)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
