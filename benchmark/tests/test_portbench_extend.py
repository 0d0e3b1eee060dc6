"""A new configuration, traffic mix and per-layer metric are new files and
new entries: in a copy of the checkout, a throwaway mix on the greedy
driver, a throwaway tiny road configuration and a throwaway metric run as a
cell of their own, and no file the benchmark had changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import ROOT


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_throwaway_cell_is_files_and_entries(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(ROOT / "krylov_robustness_torch",
               tmp_path / "krylov_robustness_torch")
    before = digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    mix = json.loads((b / "mixes" / "break_q250.json").read_text())
    mix.update(k=3, Q=20, check_steps=3, trace_units=2, fused_steps=0)
    (b / "mixes" / "throwaway.json").write_text(json.dumps(mix))
    (b / "limits" / "tiny.throwaway.json").write_text(json.dumps(
        {"limits": {"pick_regret": 2e-5, "delta_gap": 2e-5,
                    "pick_outside": 0}}))
    cfg = json.loads((b / "configs" / "vermont_road.json").read_text())
    cfg.update(name="throwaway_road", n=500, edges=550, max_chord=25)
    (b / "configs" / "throwaway_road.json").write_text(json.dumps(cfg))
    (b / "metrics" / "throwaway.edges_per_sweep.py").write_text(
        "SPANS = {'sweep': ['krylov_robustness_torch.optimize.greedy:"
        "greedy_krylov']}\n\n\ndef read(ctx):\n"
        "    return ctx.readings['units'] / max(ctx.counts['sweep'], 1)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway_road", "source": "tests",
                            "file": "benchmark/configs/throwaway_road.json",
                            "reduced": ["n"], "why": "a test"})
    spec["workloads"].append({"name": "tiny.throwaway",
                              "config": "throwaway_road",
                              "traffic": "throwaway", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "throwaway.edges_per_sweep",
                              "unit": "edges", "better": "higher",
                              "source": "program_counter", "layer": "sweep",
                              "moves": "s_per_edge",
                              "workloads": ["tiny.throwaway"]})
    for m in spec["end_to_end"]:
        if m["name"] == "s_per_edge":
            m["workloads"].append("tiny.throwaway")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = """
import json, sys, time
sys.path.insert(0, '.')
import torch
torch.set_num_threads(1)
from benchmark.harness import run_cell
out = {}
for trace in (False, True):
    rc, line = run_cell('tiny.throwaway', 5, 0.5, trace,
                        t_start=time.perf_counter(), device='cpu',
                        need_chips=False)
    out[trace] = line
print('LINES', json.dumps(out))
"""
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=600,
                       env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode == 0, p.stderr[-3000:]
    lines = json.loads(p.stdout.split("LINES", 1)[1])
    t0, t1 = lines["false"], lines["true"]
    assert t0["correct"] and t1["correct"]
    assert set(t0["metrics"]) == {"setup_s", "s_per_edge"}
    assert t1["metrics"]["throwaway.edges_per_sweep"]["value"] > 0
    assert t1["metrics"]["throwaway.edges_per_sweep"]["unit"] == "edges"
    after = digest(b)
    assert {k: v for k, v in after.items() if k in before} == before
