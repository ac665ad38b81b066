"""fmm_bem_tpu — a fast-multipole boundary-element framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
barbagroup/fmm-bem-relaxed (inexact-Krylov FMM-BEM, arXiv:1506.05957):

- Morton-ordered adaptive octrees over points or triangular BEM panels
  (host-side build, structure-of-arrays; ref: include/tree/Octree.hpp)
- dual-tree-traversal FMM/treecode matvec compiled to batched XLA ops
  (P2M/M2M/M2L/L2L/L2P/M2P/P2P; ref: include/executor/*)
- analytic kernels: Laplace / Yukawa / Stokes, point and BEM-panel variants
  (ref: kernel/*.hpp)
- GMRES / FGMRES with per-iteration relaxation of the multipole order p
  (ref: examples/BEM/GMRES.hpp, SolverOptions.hpp)
- multi-device spatial decomposition over jax.sharding meshes.

Unlike the reference (header-only C++/OpenMP), everything on the compute
path here is static-shape array code: trees and interaction lists are
built once on the host, and the matvec replays them as batched
matmuls/segment-sums on the accelerator.
"""

import jax as _jax

# Full float32 matrix products: the M2M/M2L/L2L translation chain and
# the Krylov orthogonalisation are matmuls, and a reduced-precision
# default (bf16 passes, or TF32 on NVIDIA tensor cores, ~1e-3 relative)
# would put that error into every matvec and slow GMRES convergence.
_jax.config.update("jax_default_matmul_precision", "highest")

from fmm_bem_tpu.config import FMMConfig, SolverConfig
from fmm_bem_tpu.tree.octree import Tree, build_tree
from fmm_bem_tpu.traversal.lists import InteractionLists, build_interaction_lists
from fmm_bem_tpu.executor.plan import FmmPlan

__version__ = "0.1.0"

__all__ = [
    "FMMConfig",
    "SolverConfig",
    "Tree",
    "build_tree",
    "InteractionLists",
    "build_interaction_lists",
    "FmmPlan",
]
