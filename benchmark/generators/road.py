"""Road-network stand-in: a path through every node plus short chords, each
chord from one of a set of junctions, symmetric, 0/1, no loops. The edge
count is exact: the path's n − 1 edges and ``edges`` − (n − 1) distinct
chords of 2 to ``max_chord`` − 1 hops, ``chords_per_junction`` from each
junction. At n = 95,672, 104,644 edges, chords of up to 300 hops and 4 a
junction it has the node and edge counts of the paper's largest transport
network (Vermont) and, at structure seed 0, ‖A‖ = 3.6533 where Vermont
has e^‖A‖ = e^3.6."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def make(config: dict, seed: int) -> sp.coo_matrix:
    rng = np.random.default_rng(seed)
    n, reach = config["n"], config["max_chord"]
    per = config["chords_per_junction"]
    chords = config["edges"] - (n - 1)
    hubs = rng.choice(n - reach, -(-chords // per), replace=False)
    src = np.repeat(hubs, per)[:chords]
    keys = np.unique(src * n + src + rng.integers(2, reach, chords))
    while len(keys) < chords:  # redraw the chords that came out twice
        more = rng.choice(hubs, chords - len(keys))
        keys = np.unique(np.concatenate(
            [keys, more * n + more + rng.integers(2, reach, len(more))]))
    i = np.arange(n - 1)
    src = np.concatenate([i, keys // n])
    dst = np.concatenate([i + 1, keys % n])
    return sp.coo_matrix((np.ones(len(src)), (src, dst)), shape=(n, n))
