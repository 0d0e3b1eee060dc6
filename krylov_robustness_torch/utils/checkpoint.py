"""Sweep checkpoint/resume — carried over from
``krylov_robustness_tpu/utils/checkpoint.py`` (SURVEY.md §5.3-5.4).

The reference's only resilience is per-dataset CSV streaming; here long
greedy sweeps checkpoint their algorithmic state (chosen edges so far, the
edit applied to A) after every budget step, so a killed run resumes instead
of restarting. JSON-based: the state is tiny (edge lists + scalars).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class GreedyCheckpoint:
    def __init__(self, path: str | Path, fingerprint: dict | None = None):
        """``fingerprint`` pins the sweep parameters (k, Q, tol, order,
        dtype, ...): a checkpoint written under different parameters is
        silently IGNORED on load instead of replaying a stale sweep."""
        self.path = Path(path)
        self.fingerprint = (
            {k: str(v) for k, v in fingerprint.items()} if fingerprint else None
        )

    def save(self, dataset: str, step: int, edges: list, rob: float,
             extra: dict | None = None):
        state = {
            "dataset": dataset,
            "step": step,
            "edges": [list(map(int, e)) for e in edges],
            "rob_variation": float(rob),
            "extra": extra or {},
            "fingerprint": self.fingerprint,
        }
        tmp = self.path.with_suffix(".tmp")
        tmp.write_text(json.dumps(state))
        tmp.replace(self.path)

    def load(self, dataset: str) -> dict | None:
        if not self.path.exists():
            return None
        state = json.loads(self.path.read_text())
        if state.get("dataset") != dataset:
            return None
        if self.fingerprint is not None and \
                state.get("fingerprint") != self.fingerprint:
            return None  # parameters changed since the checkpoint was cut
        state["edges"] = np.asarray(state["edges"], dtype=np.int64).reshape(-1, 2)
        return state

    def clear(self):
        if self.path.exists():
            self.path.unlink()
