"""Chung–Lu graph with a dense core of hubs: ``draws`` endpoint pairs drawn
with probabilities proportional to the shifted power law
((i + i0 + 1) / (i0 + 1))^−α over the nodes i = 0 … n − 1, whose largest
expected degree is 2·draws·p₀. The shift i0 flattens the head of the law,
so that tens of hubs of comparable degree link to each other and ‖A‖ grows
past √(largest degree) (``chung_lu.py``'s pure power law gives ‖A‖ = 65 at
soc-Epinions1's scale). At n = 75,879, α = 0.89, i0 = 14 and 420,000 draws,
structure seed 0 gives, after the preprocessing, 72,683 nodes, 402,761
edges, largest degree 2,972 and ‖A‖ = 183.1: the scale of SNAP's
soc-Epinions1 (75,877 nodes, 405,739 edges, largest degree 3,044, ‖A‖ ≈
184)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def make(config: dict, seed: int) -> sp.coo_matrix:
    rng = np.random.default_rng(seed)
    n, m = config["n"], config["draws"]
    i0 = config["head_shift"]
    w = ((np.arange(n) + i0 + 1.0) / (i0 + 1.0)) ** -config["alpha"]
    p = w / w.sum()
    src, dst = rng.choice(n, size=m, p=p), rng.choice(n, size=m, p=p)
    return sp.coo_matrix((np.ones(m), (src, dst)), shape=(n, n))
