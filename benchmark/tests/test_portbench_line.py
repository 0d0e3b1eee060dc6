"""A run's result line, run at a tiny size on the CPU through the harness
(skipping only its look for a card), and the command's refusal to run
without one."""

import io
import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from benchmark.harness import ROOT, resolve
from benchmark.tests.conftest import tiny

REQUIRED = ["correct", "attempted", "failed", "metrics", "device"]
SEED = 2**31 + 12345


def run(workload, trace, seconds=1.0, fused=False):
    cfg, mx = tiny(workload, fused)
    out = io.StringIO()
    rc, line = __import__("benchmark.harness", fromlist=["run_cell"]) \
        .run_cell(workload, SEED, seconds, trace, t_start=time.perf_counter(),
                  device="cpu", need_chips=False,
                  config=cfg, mix=mx, out=out)
    assert rc == 0
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == line
    return line


@pytest.mark.parametrize("workload,trace,fused", [
    ("road.break_q250", False, False), ("hub.break_q250_perstep", True, True),
    ("hub.break_q250_perstep", False, False),
    ("road.sinh_rewire", False, False), ("road.sinh_rewire", True, False)])
def test_result_line_keys_and_metrics(workload, trace, fused):
    line = run(workload, trace, fused=fused)
    keys = list(line)
    assert keys[:5] == REQUIRED
    assert keys[-1] == "checks"  # the numbers compared, each by its limit
    assert set(keys) <= set(REQUIRED) | {"breakdown", "checks"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    _, _, _, e2e, layer = resolve(workload)
    expect = layer if trace else e2e
    units = {m["name"]: m["unit"] for m in expect}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name]
        assert isinstance(m["value"], float) or isinstance(m["value"], int)
    if not trace:
        assert set(line["metrics"]) == set(units)
    dev = line["device"]
    assert dev["platform"] == "cpu" and dev["count"] == 1
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    if trace:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        # a CPU run reports no number under a device metric's name
        for name in ("krylov.device_ms_per_edge", "spmm.roofline_pct.greedy",
                     "device.idle_pct.greedy", "spmm.roofline_pct.weighted",
                     "device.idle_pct.weighted"):
            assert name not in line["metrics"]


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "road.break_q250",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = _command(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark: no
    result, another exit code than 0."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PYTHONPATH="")
    p = _command(tmp_path, env)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_a_span_mirrored_on_the_device_is_not_device_work():
    """A ``bench:`` span's mirror on the device timeline is not a kernel,
    also where its host range began before the profiler did."""
    import torch

    from benchmark.tracing import _kinds

    class Event:
        def __init__(self, name, device):
            self._name, self._device = name, device

        def name(self):
            return self._name

        def device_type(self):
            return self._device

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = [Event("bench:spmm|1", cpu), Event("bench:spmm|1", cuda),
              Event("bench:sweep", cuda), Event("gemm_kernel", cuda),
              Event("cudaLaunchKernel", cpu)]
    assert _kinds(events) == ["cpu_op", "gpu_user_annotation",
                              "gpu_user_annotation", "kernel", "cuda_runtime"]
