"""BENCHMARK.json's keys, names, sizes and bounds within their limits, and
every cell resolved to its files by name."""

import json
import re

import pytest

from benchmark.harness import HERE, ROOT, resolve, with_parked

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def test_top_level_keys_and_size():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_text_fields():
    names = [c["name"] for c in SPEC["configs"]] + \
        [w["name"] for w in SPEC["workloads"]] + \
        [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [c["source"] for c in SPEC["configs"]] + \
            [c["why"] for c in SPEC["configs"]] + \
            [w["why"] for w in SPEC["workloads"]] + \
            [m["layer"] for m in SPEC["per_layer"]] + SPEC["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and \
            "\t" not in text, text


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in SOURCES_E2E
        assert 0 < m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES
    assert "setup_s" in [m["name"] for m in SPEC["end_to_end"]]
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == \
        len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(SPEC["workloads"]) // 4)


def test_one_layer_name_per_layer():
    """Metrics named for one layer (the first part of their name) give it
    the same ``layer``, a few words."""
    by_prefix = {}
    for m in SPEC["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        assert len(m["layer"].split()) <= 4, m["layer"]
    assert all(len(v) == 1 for v in by_prefix.values()), by_prefix


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  with_parked(SPEC)["workloads"]])
def test_cell_resolves_to_its_files(cell):
    """Each cell, and each parked cell (``parked.json``), resolves to its
    files by name."""
    w, cfg, mix, e2e, layer = resolve(cell)
    assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
    assert (HERE / "generators" / f"{cfg['generator']}.py").is_file()
    assert (HERE / "mixes" / f"{w['traffic']}.json").is_file()
    assert (HERE / "limits" / f"{cell}.json").is_file()
    names = [m["name"] for m in e2e]
    assert "setup_s" in names and len(names) >= 2
    assert layer, "every cell reports a per-layer metric"
    moves = {m["name"] for m in e2e}
    for m in layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in moves
    for key, value in mix["limits"].items():
        assert NAME.match(key) and value >= 0


def test_every_config_is_used_and_every_metric_listed_where_it_applies():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_files_are_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel
