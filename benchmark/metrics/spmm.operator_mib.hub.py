"""The reader of the metric whose name is this file's less ``.hub``, for
the cells that report ``s_per_edge.hub``: the same number, split off so
that it moves the end-to-end metric those cells report."""

from pathlib import Path

from benchmark.harness import load_file

_BASE = Path(__file__).name[:-len(".hub.py")]
_READER = load_file(Path(__file__).with_name(f"{_BASE}.py"),
                    "benchmark_metric_" + _BASE.replace(".", "_"))
SPANS = getattr(_READER, "SPANS", {})
read = _READER.read
