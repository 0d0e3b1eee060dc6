"""Structured result logging — carried over from
``krylov_robustness_tpu/utils/logging.py`` (SURVEY.md §5.5).

The reference streams a cumulative CSV after every dataset
(``test_unweighted_break.m:150-151``) with columns
(method, dataset, n, m, searchspace_size, centrality_order, time,
tr_variation, budget_size). We keep that exact schema for row-for-row
comparability, and additionally write JSONL for machine consumption.
"""

from __future__ import annotations

import csv
import dataclasses
import json
import re
import time
from pathlib import Path

from .tracing import span

UNWEIGHTED_COLUMNS = [
    "method", "dataset", "n", "m", "searchspace_size", "centrality_order",
    "time", "tr_variation", "budget_size",
]


class ResultLog:
    """Append-only result table with CSV + JSONL streaming."""

    def __init__(self, out_dir: str | Path, name: str,
                 columns: list[str] | None = None,
                 key: tuple[str, ...] | None = None):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.columns = columns or UNWEIGHTED_COLUMNS
        self.key = key
        stamp = time.strftime("%Y-%m-%d")
        self.csv_path = self.out_dir / f"results_{name}_{stamp}.csv"
        self.jsonl_path = self.out_dir / f"results_{name}_{stamp}.jsonl"
        self.rows: list[dict] = []
        # resume semantics: a crashed/partial suite re-run continues the
        # existing table instead of clobbering it. Same-day tables are
        # continued in place; if none exists, the newest prior-day table
        # for this suite seeds today's table (its completed rows carry
        # over, so `has()` skips work finished in an earlier run).
        seed = self.csv_path
        if not seed.exists():
            # Only date-shaped stems of THIS exact suite qualify: the bare
            # glob would also match sibling suites sharing the name prefix
            # (`foo` vs `foo_intersections`) and seed the table from the
            # wrong schema.
            pat = re.compile(
                rf"^results_{re.escape(name)}_\d{{4}}-\d{{2}}-\d{{2}}\.csv$"
            )
            prior = sorted(
                p for p in self.out_dir.glob(f"results_{name}_*.csv")
                if pat.match(p.name)
            )
            seed = prior[-1] if prior else None
        if seed is not None and seed.exists():
            # prefer the JSONL twin: it carries fields beyond the reference
            # CSV schema (e.g. the norm_lane/trexp units tags), which must
            # survive a day rollover; the CSV is the schema-exact rendering.
            seed_jsonl = seed.with_suffix(".jsonl")
            if self.key is not None and seed_jsonl.exists():
                by_key: dict = {}
                with open(seed_jsonl) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        r = json.loads(line)
                        by_key[tuple(str(r.get(c)) for c in self.key)] = r
                self.rows = list(by_key.values())
            else:
                with open(seed, newline="") as f:
                    self.rows = [dict(r) for r in csv.DictReader(f)]
            if seed != self.csv_path and self.rows:
                # materialize the carried-over rows in today's artifacts
                with open(self.jsonl_path, "a") as f:
                    for r in self.rows:
                        f.write(json.dumps(r, default=_json_default) + "\n")
                with open(self.csv_path, "w", newline="") as f:
                    w = csv.DictWriter(f, fieldnames=self.columns,
                                       extrasaction="ignore")
                    w.writeheader()
                    for r in self.rows:
                        w.writerow(r)

    def _key_of(self, row: dict):
        return tuple(str(row.get(c)) for c in self.key)

    def has(self, **key_vals) -> bool:
        """True if a row with these key columns is already in the table
        (resume support: skip work whose row survived a previous run)."""
        if self.key is None:
            return False
        probe = tuple(str(key_vals.get(c)) for c in self.key)
        return any(self._key_of(r) == probe for r in self.rows)

    def append(self, **row):
        if self.key is not None:
            # keyed replace: a resumed suite re-running the same cell
            # overwrites its old row instead of duplicating it
            k = self._key_of(row)
            self.rows = [r for r in self.rows if self._key_of(r) != k]
        self.rows.append(row)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(row, default=_json_default) + "\n")
        # rewrite the cumulative CSV (the reference overwrites per dataset)
        with open(self.csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self.columns, extrasaction="ignore")
            w.writeheader()
            for r in self.rows:
                w.writerow(r)

    def __len__(self):
        return len(self.rows)


def _json_default(o):
    import numpy as np

    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if dataclasses.is_dataclass(o):
        return dataclasses.asdict(o)
    return str(o)


class Timer:
    """Wall-clock phase timing (the reference's tic/toc blocks,
    ``test_unweighted_break.m:62-76``)."""

    def __init__(self):
        self.t0 = time.time()

    def lap(self) -> float:
        now = time.time()
        dt = now - self.t0
        self.t0 = now
        return dt


# the JAX package's name for a named profiler range (SURVEY.md §5.1)
trace_annotation = span
