"""Preconditioners for the FMM-BEM Krylov solves.

JAX counterparts of examples/BEM/Preconditioner.hpp (identity,
diagonal), BlockDiagonalPC.hpp (leaf-block solve) and LocalPC.hpp
(near-field inner solve).  Where the reference runs an inner 1-iteration
GMRES against a near-field-only FMM plan, the array design solves the
batched per-leaf dense blocks directly — cheaper and exact.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def identity():
    """Ref Preconditioner.hpp:8-16."""
    return lambda r: r


def diagonal(diag):
    """Right-preconditioning by 1/diag (ref Preconditioner.hpp:19-41:
    reciprocal of the panel/point self-interaction K(s,s))."""
    inv = 1.0 / jnp.asarray(diag)
    return lambda r: inv * r


def block_diagonal_from_plan(plan, p=None, assemble_block=None):
    """Batched inverse of each leaf's self-interaction block.

    Equivalent in role to the reference's BlockDiagonalPC (inner GMRES on
    an EvalDiagonalSparse plan, BlockDiagonalPC.hpp:37-58), but solved
    exactly with one batched LU on padded [nleaf, K, K] blocks.

    ``assemble_block(tgt_fields, src_fields) -> [K, K]`` defaults to the
    kernel's scalar P2P matrix entries.
    """
    kern = plan.kernel
    K = plan.leaf_pad
    d = plan.device_data(p or plan.config.max_p)
    bidx = d["s_leaf_body_idx"]
    bmask = d["s_leaf_body_mask"]
    dev_fields = plan.device_fields()
    fields = {k: v[bidx] for k, v in dev_fields.items()}

    if assemble_block is None:
        def assemble_block(tf, sf):
            # potential-entry matrix of the leaf block via p2p with unit
            # charges one at a time is wasteful; kernels expose a dense
            # block assembler instead
            return kern.p2p_matrix(tf, sf)

    blocks = jax.vmap(assemble_block)(fields, fields)  # [nl, K, K]
    # pad invalid rows/cols with identity so LU stays well-posed
    eye = jnp.eye(K, dtype=blocks.dtype)
    m2 = bmask[:, :, None] & bmask[:, None, :]
    blocks = jnp.where(m2, blocks, eye[None])
    inv = jnp.linalg.inv(blocks)
    inv = jnp.where(m2, inv, 0.0)

    flat_slot = d["s_body_flat_slot"]
    perm = d["s_perm"]
    nl = bidx.shape[0]

    @jax.jit
    def apply(r):
        rm = r[perm]
        rleaf = jnp.where(bmask, rm[bidx], 0.0)  # [nl, K]
        z = jnp.einsum("lij,lj->li", inv, rleaf)
        zm = z.reshape(nl * K)[flat_slot]
        return jnp.zeros_like(zm).at[perm].set(zm)

    return apply


def local_inner(plan_local, config=None, iters=1, p=3):
    """Near-field inner-solve preconditioner (ref LocalPC.hpp:50-59:
    one GMRES iteration on the local-evaluation plan at loose tol)."""
    from fmm_bem_tpu.config import SolverConfig
    from fmm_bem_tpu.solver.gmres import gmres

    cfg = config or SolverConfig(residual=1e-1, max_iters=iters, restart=iters)

    def apply(r):
        x, _ = gmres(
            lambda x, _p: plan_local(x), r, config=cfg, p_fixed=p
        )
        return x

    return apply
