"""Runs one cell of ``BENCHMARK.json`` once and prints its result line.

A run: resolve the cell to its configuration, mix, driver and per-layer
readers by name; refuse without enough CUDA devices; set up (the driver
makes the inputs from the seed and warms up); measure for the window; with
``--trace 1`` profile a bounded stretch of it and read the per-layer
metrics; free the program's state; check the window's answers against the
plain reference; print every number compared beside its limit as the last
lines of standard error, and the JSON result as the last line of standard
output.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "krylov_robustness_tpu")
PORT = "krylov_robustness_torch"
STRETCH_START = 0.25  # the profiled stretch begins after this share


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load:
    JAX, its libraries and the JAX package (compared whole, so the port's
    name, which begins with the JAX package's, is not one of them)."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(entry: dict, workload: str) -> bool:
    return "workloads" not in entry or workload in entry["workloads"]


def with_parked(spec: dict) -> dict:
    """``spec`` with the entries of ``parked.json`` whose names it lacks:
    cells kept out of ``BENCHMARK.json`` (PERF.md, Open questions) with
    their metrics, which the command still runs by name."""
    parked = json.loads((HERE / "parked.json").read_text())
    spec = dict(spec)
    for key in ("workloads", "end_to_end", "per_layer"):
        have = {e["name"] for e in spec[key]}
        spec[key] = spec[key] + [e for e in parked[key]
                                 if e["name"] not in have]
    return spec


def resolve(workload: str, spec: dict | None = None):
    """(cell, configuration, mix, end-to-end entries, per-layer entries) of
    ``workload``, each file found by its name; the mix carries the cell's
    limits of ``correct`` and the precision of its control
    (``limits/<workload>.json``) under ``limits`` and ``control``."""
    if spec is None:
        spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        spec = with_parked(spec)
        cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json or "
                       f"benchmark/parked.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    config = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json").read_text())
    mix.update(json.loads((HERE / "limits" / f"{workload}.json").read_text()))
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    return cell, config, mix, e2e, layer


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device: str = "cuda", need_chips: bool = True,
             config: dict | None = None, mix: dict | None = None,
             out=None) -> tuple[int, dict | None]:
    """One run of ``workload``; returns (exit code, result or None) and
    prints the result line to ``out`` (standard output by default).
    ``config``/``mix`` replace the cell's files (the harness's own CPU
    tests run tiny sizes this way); ``need_chips=False`` skips the look for
    CUDA devices."""
    out = sys.stdout if out is None else out
    cell, cfg, mx, e2e, layer = resolve(workload)
    cfg = config if config is not None else cfg
    mx = mix if mix is not None else mx
    if need_chips:
        import torch

        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            log(f"{workload} needs {cell['chips']} CUDA device(s); "
                f"this machine has {have}. No result.")
            return 3, None
        log(f"card: {card_line()}")
    try:
        importlib.import_module(PORT)
    except ImportError as e:
        log(f"the program ({PORT}) cannot be imported: {e}. No result.")
        return 2, None
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.reset_peak_memory_stats(dev)

    driver_mod = importlib.import_module(f"benchmark.drivers.{mx['driver']}")
    generator = importlib.import_module(
        f"benchmark.generators.{cfg['generator']}")
    driver = driver_mod.make(cfg, mx, seed, dev, generator)
    driver.setup(log)
    log(f"program path: {driver.describe()}")

    readers, spans, stretch = {}, None, None
    if trace:
        from .tracing import Spans, Stretch

        targets: dict[str, list[str]] = {}
        for m in layer:
            mod = load_file(HERE / "metrics" / f"{m['name']}.py",
                            f"benchmark_metric_{m['name'].replace('.', '_')}")
            readers[m["name"]] = mod
            for label, ts in getattr(mod, "SPANS", {}).items():
                targets.setdefault(label, [])
                targets[label] += [t for t in ts if t not in targets[label]]
        spans = Spans(targets)
        for miss in spans.install(extra_modules=(driver_mod,)):
            log(f"span target missing: {miss}")
        stretch = Stretch(seconds, STRETCH_START, mx["trace_units"], dev)
    hooks = stretch if stretch is not None else SimpleNamespace(
        committed=lambda n: None, begin=lambda: None)

    t_window = time.perf_counter()
    setup_s = t_window - t_start
    hooks.begin()
    results = driver.window(seconds, hooks)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0
    log(f"window: {time.perf_counter() - t_window:.3f} s, "
        f"{driver.attempted()} {driver.unit}(s)")

    metrics: dict = {}
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": torch.cuda.get_device_name(dev)
                if dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        from .tracing import Trace

        stretch.stop()
        counts = dict(spans.counts)
        spans.uninstall()
        tr = None
        if stretch.prof is not None:
            t = time.perf_counter()
            tr = Trace(stretch.prof, stretch.units)
            log(f"trace: {len(tr.device)} device events "
                f"({tr.unattributed} without a host launch), "
                f"{len(tr.spans)} spans, stretch {tr.window_s:.3f} s over "
                f"{tr.units} {driver.unit}(s), read in "
                f"{time.perf_counter() - t:.1f} s")
            log("span calls in the window: " + ", ".join(
                f"{k} {v}" for k, v in sorted(counts.items())))
            dev_info["busy_s"] = tr.busy_s
            dev_info["window_s"] = tr.window_s
            breakdown = tr.breakdown()
        ctx = SimpleNamespace(trace=tr, readings=driver.readings(),
                              counts=counts, profiled=stretch.profiled)
        for m in layer:
            value = readers[m["name"]].read(ctx)
            if value is None:
                log(f"metric {m['name']}: nothing to read")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        stretch.prof = None
    else:
        for m in e2e:
            # an end-to-end metric split by cells, ``<quantity>.<cells>``,
            # reads the driver's <quantity>
            value = setup_s if m["name"] == "setup_s" else results.get(
                m["name"], results.get(m["name"].partition(".")[0]))
            if value is None:
                log(f"metric {m['name']}: the driver does not report it")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    driver.release()
    t = time.perf_counter()
    numbers, checked, failed = driver.check(log=log)
    log(f"check: {checked} answer(s) re-computed by the reference in "
        f"{time.perf_counter() - t:.1f} s")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}. No result.")
        return 4, None
    correct = all(v <= lim for _, v, lim in numbers)
    for name, v, lim in numbers:
        log(f"{name} {v!r} limit {lim!r}")
    line = {"correct": bool(correct), "attempted": driver.attempted(),
            "failed": int(failed), "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in numbers}
    print(json.dumps(line), file=out, flush=True)
    return 0, line
