"""Chung–Lu graph: ``draws`` endpoint pairs drawn from power-law expected
degrees i^−α, scaled to a largest expected degree ``max_degree``, with α the
first of 0.3, 0.31, ... 1.2 whose mean degree is at most 2·draws/n. At
n = 18,772 and 198,000 draws it has the scale of SNAP's ca-AstroPh (a few
hubs of degree ~500 among nodes of degree ~20)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def make(config: dict, seed: int) -> sp.coo_matrix:
    rng = np.random.default_rng(seed)
    n, m, dmax = config["n"], config["draws"], float(config["max_degree"])
    for alpha in np.linspace(0.3, 1.2, 91):
        w = (np.arange(n) + 1.0) ** -alpha
        w *= dmax / w[0]
        if w.mean() <= 2 * m / n:
            break
    p = w / w.sum()
    src, dst = rng.choice(n, size=m, p=p), rng.choice(n, size=m, p=p)
    return sp.coo_matrix((np.ones(m), (src, dst)), shape=(n, n))
