"""Driver-facing solve entry point.

The reference drivers call GMRES with the plan's matvec
(examples/LaplaceBEM.cpp:281-291, StokesBEM.cpp:305-328).  The
equivalent host loop pays several host<->device round trips per
iteration, so ``solve_plan`` routes to ``gmres_device`` (slot-space
operator, whole relaxed schedule in one executable) whenever the
backend is an accelerator, and keeps the host loop for CPU runs and
host-side preconditioners (inner solves).
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from fmm_bem_tpu.config import SolverConfig
from fmm_bem_tpu.solver.gmres import (
    DeviceGmresContext,
    fgmres,
    fgmres_device,
    gmres,
    gmres_device,
)


def solve_plan(
    plan,
    b,
    config: Optional[SolverConfig] = None,
    *,
    flipped: bool = False,
    p_fixed: Optional[int] = None,
    M_diag=None,
    flexible: bool = False,
    verbose: bool = False,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 8,
    prefer_device: Optional[bool] = None,
    context: Optional[DeviceGmresContext] = None,
):
    """Solve ``A x = b`` where A is the plan's (optionally BC-flipped)
    operator.  Returns ``(x, info, mode)`` with x in user ordering and
    mode one of "device-slots", "device", "host".

    M_diag : optional diagonal-preconditioner entries (user order,
        flattened [n*cdim]); applied as ``z = r / M_diag`` on every
        path.
    prefer_device : force the routing; default = accelerator backend.
    """
    import jax

    cfg = config or SolverConfig()
    if prefer_device is None:
        prefer_device = jax.devices()[0].platform != "cpu"
    cdim = getattr(plan.kernel, "charge_dim", 1)
    n = plan.src.tree.num_bodies
    b = np.asarray(b).reshape(-1)
    dt = jnp.dtype(plan.config.dtype)

    if prefer_device:
        solver = fgmres_device if flexible else gmres_device
        slot = plan.solver_ops_slots(flipped=flipped)
        if slot is not None:
            mv, op4p, to_s, from_s, _ = slot
            Mfn = None
            if M_diag is not None:
                dslot = to_s(jnp.asarray(1.0 / np.asarray(M_diag), dt))
                Mfn = lambda r: r * dslot
            x, info = solver(
                mv,
                to_s(jnp.asarray(b, dt)),
                operand_for_p=op4p,
                config=cfg,
                M=Mfn,
                p_fixed=p_fixed,
                verbose=verbose,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every,
                context=context,
            )
            return np.asarray(from_s(x)), info, "device-slots"
        mv, op4p = plan.solver_ops(flipped=flipped)
        Mfn = None
        if M_diag is not None:
            dinv = jnp.asarray(1.0 / np.asarray(M_diag), dt)
            Mfn = lambda r: r * dinv
        x, info = solver(
            mv,
            jnp.asarray(b, dt),
            operand_for_p=op4p,
            config=cfg,
            M=Mfn,
            p_fixed=p_fixed,
            verbose=verbose,
            checkpoint_path=checkpoint_path,
            checkpoint_every=checkpoint_every,
            context=context,
        )
        return np.asarray(x), info, "device"

    # host loop (CPU backends, host preconditioners)
    rdim = getattr(plan.kernel, "result_dim", 1)
    if flipped:
        apply = lambda v, p: plan.apply_flipped_bc(v, p=p)
    else:
        apply = lambda v, p: plan.apply(v, p=p)

    def matvec(v, p):
        q = v if cdim == 1 else v.reshape(n, cdim)
        out = apply(q, p)
        return out[:, 0] if rdim == 1 else np.asarray(out).reshape(-1)

    Mfn = None
    if M_diag is not None:
        dinv = 1.0 / np.asarray(M_diag)
        Mfn = lambda r: r * dinv
    solve = fgmres if flexible else gmres
    x, info = solve(
        matvec,
        b,
        config=cfg,
        M=Mfn,
        p_fixed=p_fixed,
        verbose=verbose,
        checkpoint_path=checkpoint_path,
        checkpoint_every=checkpoint_every,
    )
    return np.asarray(x), info, "host"
