"""Sturm banded eigensolver of the PyTorch port (ops/banded_eig.py) against
the JAX package (f64 ≤ 1e-10·scale, f32 ≤ 1e-5·scale) and against
torch.linalg.eigvalsh."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from krylov_robustness_torch.ops.banded_eig import eigvalsh_banded
from krylov_robustness_tpu.ops.banded_eig import (
    eigvalsh_banded as jax_eigvalsh_banded,
)
from test_banded_eig import _random_banded

# one intra-op thread: the suite runs in several processes at once
torch.set_num_threads(1)


@pytest.mark.parametrize("jdt,tdt,rtol", [(jnp.float64, torch.float64, 1e-10),
                                          (jnp.float32, torch.float32, 1e-5)])
@pytest.mark.parametrize("M", [24, 60])
def test_matches_jax_and_eigvalsh(jdt, tdt, rtol, M):
    """Random banded matrices, including zero-padded tails (decoupled zero
    eigenvalues) like the fused scorer's fixed-size projections."""
    G = _random_banded(32, M, 3, seed=M)
    got = eigvalsh_banded(torch.as_tensor(G).to(tdt), w=3)
    want = np.asarray(jax_eigvalsh_banded(jnp.asarray(G, jdt), w=3))
    scale = np.abs(want).max()
    assert np.abs(got.double().numpy() - want).max() <= rtol * scale
    ref = torch.linalg.eigvalsh(torch.as_tensor(G)).numpy()
    assert np.abs(got.double().numpy() - ref).max() <= 2e-4 * scale


def test_interior_zero_blocks_f32_match_jax():
    """The dead-candidate structure (interior zero rows, large zero cluster)
    that once made the pivot cascade undercount: same spectra as JAX."""
    rng = np.random.default_rng(11)
    w, M = 3, 60
    G = np.zeros((16, M, M))
    for b in range(16):
        T = np.zeros((M, M))
        for d in range(w + 1):
            v = rng.standard_normal(24 - d) * (4 if d == 0 else 2)
            T[np.arange(24 - d) + d, np.arange(24 - d)] = v
            T[np.arange(24 - d), np.arange(24 - d) + d] = v
        for z in (7, 8, 15):
            T[z, :] = 0.0
            T[:, z] = 0.0
        G[b] = T
    got = eigvalsh_banded(torch.as_tensor(G, dtype=torch.float32), w=w)
    want = np.asarray(jax_eigvalsh_banded(jnp.asarray(G, jnp.float32), w=w))
    ref = np.sort(np.linalg.eigvalsh(G), axis=-1)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(ref).max()
    assert (got.numpy() < -0.5).sum() == (ref < -0.5).sum()


@pytest.mark.parametrize("M", [1, 2, 3])
def test_band_wider_than_matrix(M):
    """M ≤ w: the band is the whole matrix (the JAX window build indexes
    past the end here and raises)."""
    rng = np.random.default_rng(M)
    S = rng.standard_normal((4, M, M))
    G = torch.as_tensor(S + S.transpose(0, 2, 1))
    got = eigvalsh_banded(G, w=3)
    torch.testing.assert_close(got, torch.linalg.eigvalsh(G), rtol=0,
                               atol=1e-12)
