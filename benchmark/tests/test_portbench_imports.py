"""Nothing the command loads is JAX or the JAX package, and the references
import nothing of the program."""

import ast
import subprocess
import sys

from benchmark.harness import FORBIDDEN, HERE, ROOT, forbidden_modules

PORT = "krylov_robustness_torch"


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.partition(".")[0])
    return tops


def test_no_benchmark_file_imports_jax():
    for path in HERE.rglob("*.py"):
        assert not imported_tops(path) & set(FORBIDDEN), path


def test_references_import_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert PORT not in imported_tops(path), path
        assert "benchmark" not in imported_tops(path), path
        text = path.read_text()
        assert "from .." not in text, path


def test_forbidden_names_compare_whole_top_level_names():
    before = dict(sys.modules)
    try:
        sys.modules["krylov_robustness_torch_x"] = object()
        sys.modules["jaxtyping_like"] = object()
        assert forbidden_modules() == []
        sys.modules["krylov_robustness_tpu.ops"] = object()
        assert forbidden_modules() == ["krylov_robustness_tpu"]
    finally:
        for k in set(sys.modules) - set(before):
            del sys.modules[k]


def test_a_run_loads_no_forbidden_module():
    """A whole run of the greedy and the weighted cell at a tiny size, in a
    fresh interpreter; then the loaded top-level names."""
    code = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import torch
torch.set_num_threads(1)
from benchmark.harness import run_cell, forbidden_modules
from benchmark.tests.conftest import tiny
for w in ("road.break_q250", "road.sinh_rewire"):
    cfg, mix = tiny(w)
    rc, line = run_cell(w, 7, 0.5, True, t_start=time.perf_counter(),
                        device="cpu", need_chips=False, config=cfg, mix=mix)
    assert rc == 0 and line["correct"], line
print("FORBIDDEN", forbidden_modules())
print("PORT", "{PORT}" in sys.modules)
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout
    assert "PORT True" in p.stdout
