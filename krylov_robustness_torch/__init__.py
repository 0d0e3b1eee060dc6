"""krylov_robustness_torch — PyTorch/CUDA port of ``krylov_robustness_tpu``.

The JAX package beside it is the reference; this package mirrors its module
tree and public functions, imports ``torch``, numpy and scipy, and never JAX.
Every public entry that creates tensors takes an explicit ``device``; nothing
picks one by itself.

Ported so far (the greedy edge break/make main path):

  ops       ``CooMatrix`` + plain gather/``index_add_`` SpMM, the super-tile
            block-sparse operator with its hand-written Hopper kernels
            (``csrc/bsr_super.cu``), RCM helpers, the Sturm banded eigensolver
  funm      scalar functions, dense trace differences, host 2-norm estimate
  krylov    batched block Lanczos
  updates   batched Δtrace f(A + U B Uᵀ) scoring of candidate edges
  optimize  greedy break/make, per-step and fused multi-step lanes
  graphs    preprocessing, candidate selection, host centrality
  utils     device resolution, finite checks
  interop   build port objects from arrays exported by the JAX package
"""

__version__ = "0.1.0"
