"""krylov_robustness_torch — PyTorch/CUDA port of ``krylov_robustness_tpu``.

The JAX package beside it is the reference; this package mirrors its module
tree and public functions, imports ``torch``, numpy and scipy, and never JAX.
Every public entry that creates tensors takes an explicit ``device``; nothing
picks one by itself.

Layer map (every module of the JAX package has its counterpart):

  ops          ``CooMatrix``/``EllMatrix`` + plain gather SpMMs, the
               super-tile block-sparse operator and the banded-ELL operator
               with their hand-written Hopper kernels (``csrc/``, built by
               ``ops/cuda_build.py``), RCM helpers, the Sturm banded
               eigensolver
  funm         scalar functions, dense trace differences and Fréchet
               divided differences, norm estimates,
               the Taylor ``expmv`` action, stochastic trace(exp(A))
  krylov       batched block Lanczos, stored-basis block Arnoldi
  updates      batched Δtrace f(A + U B Uᵀ) scoring of candidate edges,
               edge sets and weights as low-rank factors, low-rank
               f(A + U B Uᵀ) − f(A), entries and Fréchet derivatives of f(A)
  optimize     greedy break/make, per-step and fused multi-step lanes; the
               continuous tuning/rewire/add problems under trust-constr
  graphs       dataset loaders, preprocessing, candidate selection,
               centralities
  baselines    MIOBI and EIGENV
  parallel     meshes of ``torch.distributed`` ranks, row-sharded operators
               (COO/ELL local products, and K1/K2 launched per shard over
               the super-tile packing, with the all-gather overlapped)
  experiments  the Tables 2-3, Figures 1-4 and Tables 5-6 drivers, the
               trace, parity and scaling benches, and their CLI
               (``python -m krylov_robustness_torch.experiments``); the
               CONFIG 5 driver (``... .experiments.config5``, weighted
               sinh rewiring on the row-sharded operator)
  utils        device resolution, finite checks, configs, result logs,
               checkpoints
  interop      build port objects from arrays exported by the JAX package
"""

__version__ = "0.1.0"

from .ops.sparse import CooMatrix, EllMatrix, spmm  # noqa: E402,F401
